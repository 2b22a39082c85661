"""Deterministic, seeded fault injection for the fleet.

The port's own copy of ``scintools_tpu/fleet/chaos.py``: for the same
schedule it draws the same fault sequence, bit for bit. Faults enter at
exactly the boundary the retry seam defends (fleet/fsops.py). A
:class:`ChaosSchedule` is a JSON-able spec (it reaches worker processes
through the pod's ``worker_spec.json`` — ``Pod(chaos=...)``), and a
:class:`ChaosEngine` is one worker's instance of it: every draw is a
pure function of ``(seed, worker_id, op_index)``, so a run replays and a
failure reproduces from its seed alone.

Fault classes (rates are per-op probabilities):

- ``eio`` / ``estale`` — the op raises ``OSError(EIO/ESTALE)`` before
  it runs;
- ``torn_write`` — atomic writes only: a TRUNCATED payload lands at the
  destination, then the op fails with EIO; readers see the torn file
  until the writer's retry replaces it;
- ``delay`` — the op sleeps ``delay_s`` first;
- ``hang`` — a long stall (``hang_s``);
- **clock skew** — ``clock_offsets[worker]`` seconds added to that
  worker's :meth:`~scintools_tpu_torch.fleet.fsops.FsOps.now`;
- **slow motion** — ``slow_ops_s[worker]`` added to every op;
- **crash** — ``crash_after_ops[worker]``: the worker process dies
  (``os._exit(137)``, like SIGKILL) at its N-th fs op (process-mode
  pods only);
- **dead disk** — ``fail_after_ops[worker]``: from the N-th op on, every
  op raises EIO, which drives the worker into its degraded park.

``max_faults`` caps the error-raising injections per worker."""

from __future__ import annotations

import errno
import os
import random
import time

_ESTALE = getattr(errno, "ESTALE", 116)

#: error/delay fault kinds drawn per-op from ``rates``
FAULT_KINDS = ("eio", "estale", "torn_write", "delay", "hang")


class ChaosSchedule:
    """The JSON-able chaos spec (see module docstring).

    ``rates`` maps fault kind → per-op probability; unknown kinds
    are rejected loudly (a typo'd schedule must not silently test
    nothing)."""

    def __init__(self, seed=0, rates=None, delay_s=0.02, hang_s=0.5,
                 torn_frac=0.5, clock_offsets=None, slow_ops_s=None,
                 crash_after_ops=None, fail_after_ops=None,
                 max_faults=None):
        self.seed = int(seed)
        self.rates = {k: float(v) for k, v in (rates or {}).items()}
        unknown = set(self.rates) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(
                f"unknown chaos fault kinds {sorted(unknown)} "
                f"(known: {FAULT_KINDS})")
        self.delay_s = float(delay_s)
        self.hang_s = float(hang_s)
        self.torn_frac = float(torn_frac)
        self.clock_offsets = {str(k): float(v) for k, v in
                              (clock_offsets or {}).items()}
        self.slow_ops_s = {str(k): float(v) for k, v in
                           (slow_ops_s or {}).items()}
        self.crash_after_ops = {str(k): int(v) for k, v in
                                (crash_after_ops or {}).items()}
        self.fail_after_ops = {str(k): int(v) for k, v in
                               (fail_after_ops or {}).items()}
        self.max_faults = None if max_faults is None \
            else int(max_faults)

    def to_spec(self):
        """The JSON-able dict form (`worker_spec.json` transport)."""
        return {"seed": self.seed, "rates": dict(self.rates),
                "delay_s": self.delay_s, "hang_s": self.hang_s,
                "torn_frac": self.torn_frac,
                "clock_offsets": dict(self.clock_offsets),
                "slow_ops_s": dict(self.slow_ops_s),
                "crash_after_ops": dict(self.crash_after_ops),
                "fail_after_ops": dict(self.fail_after_ops),
                "max_faults": self.max_faults}

    @classmethod
    def from_spec(cls, spec):
        """Inverse of :meth:`to_spec`; a schedule instance passes
        through, so callers normalise with one call."""
        if isinstance(spec, ChaosSchedule):
            return spec
        return cls(**dict(spec))


class ChaosEngine:
    """One worker's deterministic fault stream.

    :meth:`before` is called by the fsops executor ahead of every
    operation; the draw for op ``n`` is ``random.Random(f"{seed}:
    {worker}:{n}")`` — independent of wall time, scheduling, or
    which paths the ops touch, so the stream is replayable even
    though *which* op is the n-th depends on the run."""

    def __init__(self, schedule, worker):
        self.schedule = ChaosSchedule.from_spec(schedule)
        self.worker = str(worker)
        self.n_ops = 0
        self.n_faults = 0
        self.faults = {k: 0 for k in FAULT_KINDS}
        s = self.schedule
        self._crash_at = s.crash_after_ops.get(self.worker)
        self._fail_at = s.fail_after_ops.get(self.worker)
        self._slow_s = s.slow_ops_s.get(self.worker, 0.0)

    def clock_offset(self):
        """This worker's injected clock skew (seconds; the fsops
        clock adds it to wall time)."""
        return self.schedule.clock_offsets.get(self.worker, 0.0)

    def _draw(self, n):
        rng = random.Random(f"{self.schedule.seed}:{self.worker}:{n}")
        r = rng.random()
        acc = 0.0
        for kind in FAULT_KINDS:
            acc += self.schedule.rates.get(kind, 0.0)
            if r < acc:
                return kind
        return None

    def before(self, op, path, data=None):
        """Consulted by ``FsOps._call`` ahead of each attempt; raises
        to inject, sleeps to delay, or returns to let the op run."""
        self.n_ops += 1
        n = self.n_ops
        if self._crash_at is not None and n >= self._crash_at:
            os._exit(137)             # the deterministic SIGKILL
        if self._slow_s:
            time.sleep(self._slow_s)
        if self._fail_at is not None and n >= self._fail_at:
            self.faults["eio"] += 1
            raise OSError(errno.EIO, "chaos: dead disk", str(path))
        kind = self._draw(n)
        if kind is None:
            return
        if self.schedule.max_faults is not None \
                and self.n_faults >= self.schedule.max_faults \
                and kind not in ("delay", "hang"):
            return
        self.faults[kind] += 1
        if kind == "delay":
            time.sleep(self.schedule.delay_s)
            return
        if kind == "hang":
            time.sleep(self.schedule.hang_s)
            return
        self.n_faults += 1
        if kind == "torn_write":
            if op == "write" and data:
                keep = max(1, int(len(data)
                                  * self.schedule.torn_frac))
                with open(path, "wb") as fh:  # deliberately torn
                    fh.write(data[:keep])
            raise OSError(errno.EIO, "chaos: torn write", str(path))
        if kind == "estale":
            raise OSError(_ESTALE, "chaos: stale handle", str(path))
        raise OSError(errno.EIO, "chaos: injected EIO", str(path))
