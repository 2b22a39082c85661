"""Elastic worker lifecycle: backlog-driven autoscaling with graceful,
zero-loss scale-down.

The port's own copy of ``scintools_tpu/fleet/elastic.py``. An
:class:`Autoscaler` turns the queue-depth gauges the pod computes every
poll (``fleet_queue_pending`` / ``fleet_queue_claimed``) into a
worker-count *target*, and the pod acts on the difference:

- **scale-up** spawns workers (capped at ``max_workers``) when the
  backlog per live worker exceeds ``tasks_per_worker``;
- **scale-down drains**: the pod writes a per-worker drain file
  (``<out>/drain/<worker>.drain``); the worker finishes its in-flight
  task, releases its unstarted claims back to ``tasks/``
  (:meth:`WorkQueue.release`, so survivors re-claim through the fresh
  path, not by stealing), writes a final ``draining`` heartbeat and
  exits clean. A clean drain moves no task through stealing.

Decisions are damped: the target moves at most once per
``cooldown_polls`` monitor ticks. ``fleet_workers_target`` gauges it;
``fleet.scale_up`` / ``fleet.scale_down`` events mark each move."""

from __future__ import annotations

import math


class Autoscaler:
    """Backlog → worker-count law (pure; the pod owns the acting).

    ``target = clamp(min_workers, max_workers,
    ceil((pending + claimed) / tasks_per_worker))`` — claimed tasks
    count as backlog because each pins a worker for roughly one
    task-time; a drained queue targets ``min_workers`` (the run is
    ending — spawning for an empty queue is pure churn).
    """

    def __init__(self, min_workers=1, max_workers=8,
                 tasks_per_worker=2.0, cooldown_polls=3):
        self.min_workers = max(0, int(min_workers))
        self.max_workers = max(self.min_workers, int(max_workers))
        self.tasks_per_worker = max(1e-9, float(tasks_per_worker))
        self.cooldown_polls = max(0, int(cooldown_polls))
        self._since_move = self.cooldown_polls  # first move is free
        self._target = None

    def raw_target(self, counts):
        """The undamped law for one queue-counts snapshot."""
        backlog = int(counts.get("pending", 0)) \
            + int(counts.get("claimed", 0))
        want = math.ceil(backlog / self.tasks_per_worker)
        return max(self.min_workers, min(self.max_workers, want))

    def target(self, counts):
        """The damped target: moves at most once per
        ``cooldown_polls`` ticks; returns the current target either
        way."""
        want = self.raw_target(counts)
        if self._target is None:
            self._target = want
            self._since_move = 0
            return self._target
        self._since_move += 1
        if want != self._target \
                and self._since_move >= self.cooldown_polls:
            self._target = want
            self._since_move = 0
        return self._target


def as_autoscaler(spec):
    """Normalise ``Pod(autoscale=...)``: None passes through, a dict
    is :class:`Autoscaler` kwargs, an instance is used as-is."""
    if spec is None or isinstance(spec, Autoscaler):
        return spec
    if isinstance(spec, dict):
        return Autoscaler(**spec)
    raise TypeError(f"autoscale must be None/dict/Autoscaler, got "
                    f"{type(spec).__name__}")
