"""Distributed survey scheduler: work queue, workers, merge, pod — the
port's own copy of ``scintools_tpu/fleet``.

An epoch-sharded work queue coordinates worker processes through atomic
filesystem operations alone — no collectives, no coordinator service —
so any worker's death is survivable and any host sharing the queue
directory can join.

- :mod:`.queue` — claim-by-rename, heartbeat-stamped leases,
  work-stealing of expired leases, clock-skew-tolerant expiry;
- :mod:`.worker` — the worker loop around ``robust/runner.py``'s
  batched engine, one journal per worker, lease and file heartbeats;
- :mod:`.merge` — deterministic merge of the per-worker journals into
  one canonical survey journal;
- :mod:`.pod` — the coordinator: seeds the queue, launches and watches
  the workers, merges, and writes one merged RunReport;
- :mod:`.telemetry` — the pod's live plane view (``Pod(plane_port=...)``
  serves ``/metrics``, ``/state``, ``/report``, ``/workers``);
- :mod:`.fsops` — the one seam every fleet filesystem operation goes
  through (retries, deadlines, the degraded park, the injectable clock);
- :mod:`.chaos` — seeded fault injection at that seam;
- :mod:`.elastic` — the backlog-driven :class:`Autoscaler` and the
  graceful drain.

``sim.scenario.run_scenario_fleet`` and ``mcmc.survey.run_mcmc_fleet``
run the two surveys through it.
"""

from .chaos import ChaosEngine, ChaosSchedule
from .elastic import Autoscaler, as_autoscaler
from .fsops import FsOpDegradedError, FsOps, RetryPolicy
from .merge import (ATTRIBUTION_FIELDS, iter_merged, merge_journals,
                    merge_records)
from .pod import Pod, run_pod
from .queue import Task, WorkQueue, claim_by_rename
from .telemetry import FleetStateTracker, JournalTail, PodTelemetry
from .worker import (FleetWorker, demo_workload, resolve_workload,
                     run_worker)

__all__ = [
    "ChaosEngine", "ChaosSchedule",
    "Autoscaler", "as_autoscaler",
    "FsOpDegradedError", "FsOps", "RetryPolicy",
    "ATTRIBUTION_FIELDS", "iter_merged", "merge_journals",
    "merge_records",
    "Pod", "run_pod",
    "Task", "WorkQueue", "claim_by_rename",
    "FleetStateTracker", "JournalTail", "PodTelemetry",
    "FleetWorker", "demo_workload", "resolve_workload", "run_worker",
]
