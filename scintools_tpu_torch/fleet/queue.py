"""Filesystem-backed epoch work queue: atomic claim-by-rename, leases,
work-stealing.

The port's own copy of ``scintools_tpu/fleet/queue.py``. A fleet of
survey workers needs a scheduler that never lets a worker idle and
never hands the same work to two workers, without collectives or a
coordinator service: one worker's SIGKILL must leave the others
computing. The queue is a DIRECTORY; N worker processes, on one host or
on several sharing a filesystem, coordinate through atomic filesystem
operations alone:

- **claim-by-rename** — a pending task is one file in ``tasks/``;
  claiming it is ``os.rename`` into the worker's own
  ``claims/<worker>/``. A rename of an existing source is atomic and
  the source vanishes, so of two racers exactly one wins and the loser
  gets ``FileNotFoundError``. :func:`claim_by_rename` is the shared
  primitive (serve/watch.py's shared-spool claim mode uses it too).
- **leases** — a claimed task gets a lease file in ``leases/`` stamped
  with the holder and an expiry instant; the holder's heartbeat
  rewrites it while it computes. A worker that dies stops
  heartbeating, its lease expires, and the task becomes stealable.
- **work-stealing** — a worker with nothing to claim scans for expired
  leases and steals the claim file (the same rename, so two stealers
  race safely). The stolen task re-runs from scratch; results are
  deterministic per epoch and the journal merge (fleet/merge.py) keeps
  the first-committed record.
- **clock-skew tolerance** — expiry instants are stamped by the
  holder's clock and compared against the stealer's; a lease counts as
  expired only ``skew_s`` seconds past its stamp. A slow-but-alive
  holder that loses its lease finds out at its next heartbeat or
  completion (:meth:`WorkQueue.complete` returns False).

Layout (``root`` is the shared queue directory)::

    root/
      tasks/              pending task files        <task_id>.json
      claims/<worker>/    claimed tasks (by holder) <task_id>.json
      leases/             lease stamps              <task_id>.json
      done/               completed tasks           <task_id>.json

A task file is ``{"task": id, "epochs": [[epoch_id, payload], ...]}``,
sized by the coordinator to one batched ``process_batch`` dispatch.
Completion renames the claim into ``done/`` and removes the lease."""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from ..obs import metrics as _metrics
from ..utils import slog
from . import fsops as _fsops


def claim_by_rename(src_path, dst_dir, fs=None):
    """THE claim primitive: atomically move ``src_path`` into
    ``dst_dir``; returns the new path when this caller won the race,
    None when another claimer got there first (the source vanished).
    Both paths must be on the same filesystem (the shared queue/spool
    directory always is). ``fs`` is the retryable filesystem seam
    (fleet/fsops.py; transient faults retried, lost races passed
    through)."""
    fs = fs or _fsops.DEFAULT
    fs.makedirs(dst_dir)
    dst = os.path.join(dst_dir, os.path.basename(os.fspath(src_path)))
    try:
        fs.rename(os.fspath(src_path), dst)
    except FileNotFoundError:
        return None
    return dst


@dataclass
class Task:
    """One claimed unit of work: the epoch batch plus its bookkeeping
    (where its claim file lives now, whether it was stolen and from
    whom)."""

    task_id: str
    epochs: list
    path: str
    stolen: bool = False
    stolen_from: str = ""
    meta: dict = field(default_factory=dict)


class WorkQueue:
    """One worker's handle on the shared queue directory.

    Every method is safe to call concurrently from any number of
    worker processes on the same ``root``; no in-process state matters
    beyond ``worker`` (the identity the claims/leases are stamped
    with) and the lease/skew policy.
    """

    def __init__(self, root, worker="w0", lease_s=30.0, skew_s=2.0,
                 fs=None):
        self.root = os.fspath(root)
        self.worker = str(worker)
        self.lease_s = float(lease_s)
        self.skew_s = float(skew_s)
        # the filesystem seam (fleet/fsops.py): every op below routes
        # through it — retry/backoff on transient faults, chaos
        # injection, and the worker's (possibly skewed) clock
        self.fs = fs or _fsops.DEFAULT
        self.tasks_dir = os.path.join(self.root, "tasks")
        self.claims_dir = os.path.join(self.root, "claims")
        self.my_claims = os.path.join(self.claims_dir, self.worker)
        self.leases_dir = os.path.join(self.root, "leases")
        self.done_dir = os.path.join(self.root, "done")
        for d in (self.tasks_dir, self.my_claims, self.leases_dir,
                  self.done_dir):
            self.fs.makedirs(d)
        # (holder, task_id) -> first time observed claimed with NO
        # lease (the _steal_leaseless persistence gate)
        self._leaseless_seen = {}

    # ---- seeding ----------------------------------------------------
    def seed(self, tasks):
        """Idempotently enqueue ``tasks`` — an iterable of
        ``(task_id, epochs)`` with JSON-able epoch entries. A task
        already pending, claimed, or done is left alone, so re-seeding
        on resume never duplicates work. Returns the number of
        freshly enqueued tasks."""
        existing = self._known_task_ids()
        n = 0
        for task_id, epochs in tasks:
            tid = str(task_id)
            if tid in existing:
                continue
            self.fs.write_json(
                os.path.join(self.tasks_dir, tid + ".json"),
                {"task": tid,
                 "epochs": [[str(e), p] for e, p in epochs]})
            n += 1
        if n:
            slog.log_event("fleet.seed", worker=self.worker, tasks=n)
        return n

    def _known_task_ids(self):
        ids = set()
        for d in (self.tasks_dir, self.done_dir):
            ids |= {f[:-5] for f in self.fs.listdir(d)
                    if f.endswith(".json")}
        for w in self._workers():
            ids |= {f[:-5]
                    for f in self.fs.listdir(
                        os.path.join(self.claims_dir, w))
                    if f.endswith(".json")}
        return ids

    def _workers(self):
        try:
            return sorted(
                w for w in self.fs.listdir(self.claims_dir)
                if os.path.isdir(os.path.join(self.claims_dir, w)))
        except FileNotFoundError:
            return []

    # ---- claiming ---------------------------------------------------
    def claim(self):
        """Claim one unit of work, or None when nothing is claimable
        right now. Order of preference:

        1. the worker's OWN leftover claims whose lease lapsed — a
           restarted worker reclaims what it held when it died (its
           journal resume makes the re-run cheap);
        2. a fresh task from ``tasks/`` (rename race — losing just
           means trying the next file);
        3. an expired lease held by another worker (work-stealing).

        None does NOT mean the queue is finished — a live worker may
        still fail and its tasks become stealable; poll
        :meth:`drained` to distinguish."""
        task = self._reclaim_own() or self._claim_fresh() \
            or self._steal_expired()
        return task

    def _load_task(self, path, stolen=False, stolen_from=""):
        try:
            doc = self.fs.read_json(path)
        except FileNotFoundError:
            # vanished between listing and open — another claimer
            # renamed it away; theirs now, and their (possibly fresh)
            # lease must be left alone
            return None
        except (OSError, ValueError) as e:
            # a torn task file is unrecoverable work — surface loudly
            # and park it in bad/ so it cannot wedge the drain
            # condition (the pod reports bad tasks at merge time)
            slog.log_failure("fleet.task_error", stage="load", error=e,
                             epoch=os.path.basename(path))
            claim_by_rename(path, os.path.join(self.root, "bad"),
                            fs=self.fs)
            self._drop_lease(os.path.basename(path)[:-5])
            return None
        return Task(task_id=str(doc["task"]),
                    epochs=[(str(e), p) for e, p in doc["epochs"]],
                    path=path, stolen=stolen, stolen_from=stolen_from)

    def _claim_fresh(self):
        for name in self._listing(self.tasks_dir):
            won = claim_by_rename(
                os.path.join(self.tasks_dir, name), self.my_claims,
                fs=self.fs)
            if won is None:
                continue               # another worker beat us to it
            task = self._load_task(won)
            if task is None:
                continue
            self.renew(task)
            _metrics.counter("fleet_tasks_claimed_total",
                             help="fresh tasks claimed off the queue"
                             ).inc()
            slog.log_event("fleet.claim", worker=self.worker,
                           task=task.task_id, epochs=len(task.epochs))
            return task
        return None

    def _reclaim_own(self):
        for name in self._listing(self.my_claims):
            tid = name[:-5]
            lease = self.read_lease(tid)
            if lease is not None and lease.get("worker") == self.worker \
                    and not self._expired(lease):
                # held live by this very worker id (e.g. a previous
                # incarnation that is somehow still heartbeating) —
                # leave it alone
                continue
            task = self._load_task(os.path.join(self.my_claims, name))
            if task is None:
                continue
            self.renew(task)
            slog.log_event("fleet.reclaim", worker=self.worker,
                           task=task.task_id)
            return task
        return None

    def _steal_expired(self):
        now = self.fs.now()
        for name in self._listing(self.leases_dir):
            tid = name[:-5]
            lease = self.read_lease(tid)
            if lease is None or not self._expired(lease, now=now):
                continue
            holder = lease.get("worker", "")
            if holder == self.worker:
                continue               # covered by _reclaim_own
            src = os.path.join(self.claims_dir, holder, name)
            won = claim_by_rename(src, self.my_claims, fs=self.fs)
            if won is None:
                # not under the lease holder's dir: a previous stealer
                # may have renamed it and died before renewing the
                # lease — the claim file is wherever it landed
                for w in self._workers():
                    if w in (holder, self.worker):
                        continue
                    won = claim_by_rename(
                        os.path.join(self.claims_dir, w, name),
                        self.my_claims, fs=self.fs)
                    if won is not None:
                        break
            if won is None:
                continue               # another stealer won, or done
            task = self._load_task(won, stolen=True,
                                    stolen_from=holder)
            if task is None:
                continue
            self.renew(task)
            _metrics.counter(
                "fleet_tasks_stolen_total",
                help="expired-lease tasks stolen from other workers"
            ).inc()
            slog.log_event("fleet.steal", worker=self.worker,
                           task=task.task_id, stolen_from=holder,
                           lease_age_s=round(
                               now - float(lease.get("expires_t",
                                                     now)), 3))
            return task
        return self._steal_leaseless()

    def _steal_leaseless(self):
        """Backstop for claims with NO lease at all: a holder killed
        in the claim→first-renew window (or whose lease a racing
        completer dropped) leaves a claim the expiry scan above can
        never see — wedging the drain forever. A missing lease reads
        as "immediately reclaimable" (:meth:`read_lease`), but a
        LIVE fresh claimer is lease-less for the instant between its
        claim-rename and first renew — so a claim must be observed
        lease-less across ~a heartbeat period before it is stolen.
        A mistaken steal in that window still only re-runs work the
        merge dedupes (the documented err direction)."""
        now = time.monotonic()
        grace = max(0.5, self.lease_s / 3.0)
        live = set()
        for holder in self._workers():
            if holder == self.worker:
                continue               # covered by _reclaim_own
            for name in self._listing(os.path.join(self.claims_dir,
                                                   holder)):
                tid = name[:-5]
                key = (holder, tid)
                live.add(key)
                if self.read_lease(tid) is not None:
                    self._leaseless_seen.pop(key, None)
                    continue           # live (or expiry-scannable)
                first = self._leaseless_seen.setdefault(key, now)
                if now - first < grace:
                    continue           # maybe mid-first-renew
                won = claim_by_rename(
                    os.path.join(self.claims_dir, holder, name),
                    self.my_claims, fs=self.fs)
                if won is None:
                    continue           # racer got it first
                self._leaseless_seen.pop(key, None)
                task = self._load_task(won, stolen=True,
                                       stolen_from=holder)
                if task is None:
                    continue
                self.renew(task)
                _metrics.counter(
                    "fleet_tasks_stolen_total",
                    help="expired-lease tasks stolen from other "
                         "workers").inc()
                slog.log_event("fleet.steal", worker=self.worker,
                               task=task.task_id,
                               stolen_from=holder, lease_age_s=None)
                return task
        for key in [k for k in self._leaseless_seen
                    if k not in live]:
            del self._leaseless_seen[key]
        return None

    def _listing(self, d):
        try:
            return sorted(f for f in self.fs.listdir(d)
                          if f.endswith(".json"))
        except FileNotFoundError:
            return []

    # ---- leases -----------------------------------------------------
    def _lease_path(self, task_id):
        return os.path.join(self.leases_dir, str(task_id) + ".json")

    def read_lease(self, task_id):
        """The current lease record for ``task_id`` (or None). A
        torn/corrupt lease reads as None — i.e. immediately
        reclaimable, which errs on the side of re-running work.
        (A DEGRADED filesystem does not: FsOpDegradedError is not an
        OSError precisely so it escapes this handler and parks the
        worker instead of reading as an empty lease.)"""
        try:
            return self.fs.read_json(self._lease_path(task_id))
        except (OSError, ValueError):
            return None

    def _expired(self, lease, now=None):
        """True once ``now`` is ``skew_s`` past the lease's stamped
        expiry — the stealer's clock vs the holder's clock, so hosts
        disagreeing by less than ``skew_s`` never steal live work.
        ``now`` defaults to the seam's clock (:meth:`FsOps.now` —
        wall time plus this process's injected offset)."""
        now = self.fs.now() if now is None else now
        try:
            expires = float(lease.get("expires_t", 0.0))
        except (TypeError, ValueError):
            return True
        return now > expires + self.skew_s

    def renew(self, task):
        """(Re)write the lease for a task this worker holds — the
        heartbeat. Returns False when the lease now names ANOTHER
        worker (it expired and was stolen while we computed): the
        caller should stop investing in the task; its journal lines
        stay and the merge keeps one copy."""
        lease = self.read_lease(task.task_id)
        if lease is not None and lease.get("worker") != self.worker \
                and not self._expired(lease):
            _metrics.counter(
                "fleet_leases_lost_total",
                help="leases discovered stolen at heartbeat time"
            ).inc()
            slog.log_event("fleet.lease_lost", worker=self.worker,
                           task=task.task_id,
                           holder=lease.get("worker"))
            return False
        now = self.fs.now()
        self.fs.write_json(self._lease_path(task.task_id), {
            "task": task.task_id, "worker": self.worker,
            "stamped_t": round(now, 3),
            "expires_t": round(now + self.lease_s, 3)})
        return True

    # ---- completion -------------------------------------------------
    def complete(self, task):
        """Mark a task done: move its claim file into ``done/`` and
        drop the lease. Returns False when the claim file is gone —
        the lease expired and someone stole the task; this worker's
        results are still journaled and the merge dedupes.

        The lease is dropped only when it still names THIS worker
        (or on actual completion): on the lost path it is the NEW
        holder's live lease, and a claim whose lease vanishes while
        its holder is mid-crash is unstealable by the expiry scan
        (the lease-less steal path is the backstop)."""
        won = claim_by_rename(task.path, self.done_dir, fs=self.fs)
        if won is not None:
            self._drop_lease(task.task_id)
        else:
            lease = self.read_lease(task.task_id)
            if lease is None or lease.get("worker") == self.worker:
                self._drop_lease(task.task_id)
        if won is None:
            _metrics.counter(
                "fleet_leases_lost_total",
                help="leases discovered stolen at heartbeat time"
            ).inc()
            slog.log_event("fleet.lease_lost", worker=self.worker,
                           task=task.task_id, holder="")
            return False
        _metrics.counter("fleet_tasks_completed_total",
                         help="tasks completed (claim moved to done/)"
                         ).inc()
        slog.log_event("fleet.task_done", worker=self.worker,
                       task=task.task_id, stolen=task.stolen)
        return True

    def release(self, task):
        """Put a claimed task back on the queue untouched — the
        inverse of claim-by-rename (graceful shutdown / drain
        mid-claim). Survivors re-claim it through the FRESH path;
        no lease has to expire first."""
        claim_by_rename(task.path, self.tasks_dir, fs=self.fs)
        lease = self.read_lease(task.task_id)
        if lease is None or lease.get("worker") == self.worker:
            self._drop_lease(task.task_id)
        slog.log_event("fleet.release", worker=self.worker,
                       task=task.task_id)

    def release_own(self):
        """Release EVERY claim this worker still holds back to
        pending (the drain protocol's hand-off step, fleet/elastic.
        py); returns the number released."""
        n = 0
        for name in self._listing(self.my_claims):
            self.release(Task(task_id=name[:-5], epochs=[],
                              path=os.path.join(self.my_claims,
                                                name)))
            n += 1
        return n

    def _drop_lease(self, task_id):
        try:
            self.fs.unlink(self._lease_path(task_id))
        except FileNotFoundError:
            pass

    # ---- observation ------------------------------------------------
    def counts(self):
        """``{"pending":, "claimed":, "done":}`` file counts (a racy
        snapshot — fine for gauges and drain polling)."""
        claimed = sum(len(self._listing(os.path.join(self.claims_dir,
                                                     w)))
                      for w in self._workers())
        return {"pending": len(self._listing(self.tasks_dir)),
                "claimed": claimed,
                "done": len(self._listing(self.done_dir))}

    def drained(self):
        """True when nothing is pending or claimed — every seeded
        task has reached ``done/``. The worker exit condition (a
        claimed task of a dead worker keeps ``drained`` False until
        someone steals and finishes it)."""
        c = self.counts()
        return c["pending"] == 0 and c["claimed"] == 0

    def done_ids(self):
        return {name[:-5] for name in self._listing(self.done_dir)}
