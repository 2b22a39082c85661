"""The fleet's filesystem seam: every queue, lease, heartbeat and journal
mutation behind one retryable, fault-injectable call site.

The port's own copy of ``scintools_tpu/fleet/fsops.py``. The queue's
correctness rests on POSIX rename atomicity and wall clocks, which hold
trivially on one healthy local disk and less so on the network mounts a
multi-host fleet runs on: renames time out, handles go stale (ESTALE),
writes tear and peer clocks disagree. Every filesystem operation the
fleet performs therefore goes through one :class:`FsOps` instance that

- **classifies** errors (:meth:`RetryPolicy.classify`): transient
  EIO/ESTALE/ETIMEDOUT/ENOSPC/EAGAIN/EBUSY are retried under bounded
  jittered exponential backoff with a per-op deadline; permanent
  errors (EACCES, EROFS…) raise at once; ``FileNotFoundError`` always
  passes straight through — here it is a semantic outcome (a lost
  claim race, a missing lease), never a fault;
- **accounts** for every retry (``fleet_fsop_retries_total{op=}``,
  ``fleet_fsop_deadline_exceeded_total``, and the ``retries`` /
  ``retry_wait_s`` tallies the worker heartbeats carry);
- **degrades** instead of crashing: an op that exhausts its retries
  (or its deadline) emits ``fleet.fsop_degraded`` and raises
  :class:`FsOpDegradedError` — deliberately not an ``OSError``, so no
  torn-lease or torn-task handler swallows it — and the worker loop
  catches it to park (fleet/worker.py): stop claiming, stop renewing
  (leases expire honestly and survivors steal), keep heartbeating;
- **injects**: a :class:`~scintools_tpu_torch.fleet.chaos.ChaosEngine`
  passed as ``chaos=`` is consulted before each operation, so faults
  enter at exactly the boundary the retry policy defends;
- **owns the clock**: :meth:`FsOps.now` is wall time plus an injectable
  per-process offset; the lease stamps and expiry comparisons of
  fleet/queue.py read this clock.

No module of ``fleet/`` renames, replaces or opens a file for writing
other than through this one."""

from __future__ import annotations

import errno
import json
import os
import random
import time
from dataclasses import dataclass

from ..obs import metrics as _metrics
from ..parallel.checkpoint import _TMP_SEQ
from ..utils import slog

#: errnos worth retrying: the transient faults shared filesystems
#: actually produce (I/O hiccup, stale NFS handle, RPC timeout,
#: transiently-full disk, try-again, busy inode).
TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.ETIMEDOUT, errno.ENOSPC, errno.EAGAIN,
    getattr(errno, "ESTALE", 116), getattr(errno, "EBUSY", 16),
})


class FsOpDegradedError(RuntimeError):
    """An fs op exhausted its retry budget (or per-op deadline).

    A ``RuntimeError`` on purpose: the queue's torn-file handlers
    catch ``OSError`` to mean "unreadable, treat as absent" — a
    degraded filesystem must NOT read as an empty queue. The worker
    loop catches this type explicitly and parks."""

    def __init__(self, op, path, attempts, cause, deadline=False):
        what = "deadline" if deadline else "retries"
        super().__init__(
            f"fs op {op!r} on {path!r} exhausted {what} after "
            f"{attempts} attempts: {cause!r}")
        self.op = op
        self.path = os.fspath(path) if path is not None else ""
        self.attempts = attempts
        self.cause = cause
        self.deadline = deadline


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded jittered exponential backoff with a per-op deadline.

    ``retries`` is the number of RE-attempts after the first try;
    backoff for re-attempt ``k`` (1-based) is
    ``min(max_s, base_s * 2**(k-1))`` scaled down by up to
    ``jitter`` (deterministic given the caller's seeded rng — two
    workers retrying the same contended file desynchronise, and a
    test replays identically). ``deadline_s`` caps the total time
    one op may spend retrying regardless of the attempt budget."""

    retries: int = 4
    base_s: float = 0.005
    max_s: float = 0.2
    deadline_s: float = 3.0
    jitter: float = 0.5

    def classify(self, exc):
        """``"semantic"`` (FileNotFoundError — a race outcome the
        caller handles), ``"transient"`` (retryable), or
        ``"permanent"``."""
        if isinstance(exc, FileNotFoundError):
            return "semantic"
        if isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS:
            return "transient"
        return "permanent"

    def backoff_s(self, attempt, rng):
        raw = min(self.max_s, self.base_s * (2.0 ** max(0,
                                                        attempt - 1)))
        return raw * (1.0 - self.jitter * rng.random())


class FsOps:
    """One process's handle on the (possibly faulty) filesystem.

    All mutating fleet ops go through the ``_call`` executor:
    chaos injection (when configured) → the real op → classify /
    retry / degrade. Construct one per worker (``worker=`` labels
    the degraded event; ``clock_offset_s`` skews :meth:`now`) or use
    the module :data:`DEFAULT` for unfaulted coordinator-side use.
    """

    def __init__(self, policy=None, chaos=None, clock_offset_s=0.0,
                 worker="", seed=0):
        self.policy = policy or RetryPolicy()
        self.chaos = chaos
        self.clock_offset_s = float(clock_offset_s)
        self.worker = str(worker)
        self._rng = random.Random(f"fsops:{self.worker}:{seed}")
        self.retries = 0          # cumulative re-attempts
        self.retry_wait_s = 0.0   # cumulative backoff slept
        self.degraded = False

    # ---- the clock --------------------------------------------------
    def now(self):
        """Wall time through this process's (injectable) clock — the
        instant lease stamps and expiry comparisons use."""
        return time.time() + self.clock_offset_s

    # ---- the executor -----------------------------------------------
    def _call(self, op, path, fn, data=None):
        deadline = time.monotonic() + self.policy.deadline_s
        attempt = 1
        while True:
            try:
                if self.chaos is not None:
                    self.chaos.before(op, path, data=data)
                return fn()
            except FileNotFoundError:
                raise                 # semantic, never a fault
            except OSError as e:
                if self.policy.classify(e) != "transient":
                    raise
                self.retries += 1
                _metrics.counter(
                    "fleet_fsop_retries_total",
                    help="transient fs-op failures retried at the "
                         "fleet fsops seam").labels(op=op).inc()
                if attempt > self.policy.retries:
                    self._degrade(op, path, attempt, e)
                if time.monotonic() >= deadline:
                    _metrics.counter(
                        "fleet_fsop_deadline_exceeded_total",
                        help="fs ops abandoned at their per-op "
                             "retry deadline").inc()
                    self._degrade(op, path, attempt, e, deadline=True)
                wait = min(self.policy.backoff_s(attempt, self._rng),
                           max(0.0, deadline - time.monotonic()))
                attempt += 1
                self.retry_wait_s += wait
                if wait > 0:
                    time.sleep(wait)

    def _degrade(self, op, path, attempts, cause, deadline=False):
        self.degraded = True
        slog.log_failure(
            "fleet.fsop_degraded", stage=op, error=cause,
            epoch=os.path.basename(os.fspath(path)) if path else "",
            worker=self.worker, attempts=attempts,
            deadline=bool(deadline))
        raise FsOpDegradedError(op, path, attempts, cause,
                                deadline=deadline) from cause

    # ---- the ops ----------------------------------------------------
    def rename(self, src, dst):
        """Atomic move (``os.rename``) — THE claim primitive.
        ``FileNotFoundError`` (lost race) passes through unretried."""
        src, dst = os.fspath(src), os.fspath(dst)
        return self._call("rename", src, lambda: os.rename(src, dst))

    def replace(self, src, dst):
        src, dst = os.fspath(src), os.fspath(dst)
        return self._call("replace", src,
                          lambda: os.replace(src, dst))

    def unlink(self, path):
        path = os.fspath(path)
        return self._call("unlink", path, lambda: os.unlink(path))

    def listdir(self, path):
        path = os.fspath(path)
        return self._call("listdir", path, lambda: os.listdir(path))

    def makedirs(self, path):
        path = os.fspath(path)
        return self._call("makedirs", path,
                          lambda: os.makedirs(path, exist_ok=True))

    def exists(self, path):
        """Plain stat probe — read-only, never faulted (a drain
        signal must reach a worker whose data plane is degraded)."""
        return os.path.exists(os.fspath(path))

    def read_bytes(self, path):
        path = os.fspath(path)

        def _read():
            with open(path, "rb") as fh:
                return fh.read()

        return self._call("read", path, _read)

    def read_json(self, path):
        """Read + parse. Parse errors (a torn file) raise
        ``ValueError`` unretried — torn is a *state* the protocol
        handles, not a fault retrying would fix."""
        return json.loads(self.read_bytes(path))

    def write_bytes(self, path, data):
        """Atomic write: unique temp + fsync + replace (the
        fleet-safe :func:`~scintools_tpu_torch.parallel.checkpoint.
        atomic_write_bytes` recipe), inside the retry loop — a
        chaos torn-write leaves a torn file *visible to other
        readers* and then fails the op, so the retry overwrites it
        with the complete content."""
        path = os.fspath(path)

        def _write():
            tmp = f"{path}.{os.getpid()}.{next(_TMP_SEQ)}.tmp"
            try:
                with open(tmp, "wb") as fh:
                    fh.write(data)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

        return self._call("write", path, _write, data=data)

    def write_json(self, path, obj):
        return self.write_bytes(path, json.dumps(obj).encode())

    def append_text(self, path, text):
        """Append + flush (the trace-spool channel; torn tails are
        tolerated by every reader of these files)."""
        path = os.fspath(path)

        def _append():
            with open(path, "a") as fh:
                fh.write(text)

        return self._call("append", path, _append)

    def open_write(self, path, mode="w", encoding=None):
        """Open for write/append and return the handle (subprocess
        log sinks, merge temp files). Only the *open* rides the
        retry loop; the stream is the caller's."""
        path = os.fspath(path)
        return self._call(
            "open", path,
            lambda: open(path, mode, encoding=encoding))

    def fdopen(self, fd, mode="w", encoding=None):
        return self._call("open", f"<fd {fd}>",
                          lambda: os.fdopen(fd, mode,
                                            encoding=encoding))

    def fsync(self, fh):
        return self._call("fsync", getattr(fh, "name", "<fh>"),
                          lambda: os.fsync(fh.fileno()))


#: unfaulted default instance — module-level callers (the pod
#: coordinator, merge, serve's shared-spool claim) that don't carry a
#: per-worker FsOps route through this.
DEFAULT = FsOps(worker="default")
