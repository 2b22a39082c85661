"""Epoch sources for the streaming daemon: a spool directory and a queue.

The port's own copy of ``scintools_tpu/serve/watch.py``. A long-lived
survey service does not get its epoch list up front: a telescope backend
drops psrflux or FITS files into a spool directory, a test pushes
payloads into an in-process queue. Both are the same small interface
the daemon (serve/daemon.py) consumes:

- ``get(timeout)`` → the next :class:`ArrivedEpoch` or None (nothing
  arrived within the deadline — the daemon uses the idle tick to drain
  its dispatch window, so ingest→publish latency stays bounded while
  the spool is quiet);
- ``backlog()`` → epochs arrived but not yet taken;
- ``alive()`` / ``last_activity()`` → liveness for ``/healthz``;
- ``close()`` → stop producing.

:class:`SpoolWatcher` hardens the filesystem edge:

- **torn files** — a file whose size still changes between polls, or
  is empty, is not admitted until its size has been stable for
  ``settle_polls`` polls; a writer that renames into place is admitted
  on first sight;
- **duplicates** — every admitted file is content-hashed (sha256 of its
  bytes) and the daemon drops content already published under another
  name;
- **out-of-order arrival** — each poll admits newly stable files in
  sorted-name order; across polls the stream order is arrival order,
  and the daemon resumes by epoch key, so order is a throughput concern
  only;
- **malformed files** — admitted as they are; the pipeline's loader
  raises ``MalformedInputError`` and the epoch is quarantined without
  stalling the stream."""

from __future__ import annotations

import fnmatch
import os
import queue
import threading
import time
from dataclasses import dataclass, field

from ..utils import slog
from .store import content_hash


@dataclass
class ArrivedEpoch:
    """One arrival out of a source: ``epoch`` is the stable key (file
    basename / caller-chosen id), ``payload`` what the pipeline
    loader receives (a path for the spool, anything for the queue),
    ``sha`` the content hash when the source could compute one, and
    ``t_arrive`` the perf-counter instant the source admitted it (the
    start of the epoch's ingest→publish latency span)."""

    epoch: str
    payload: object
    sha: str = None
    t_arrive: float = field(default_factory=time.perf_counter)
    #: multi-tenant namespace the arrival belongs to:
    #: admission control, fair-share lane quotas, and per-tenant
    #: metrics key off this; None = the daemon's default tenant
    tenant: str = None


class QueueSource:
    """In-process epoch source for tests and embedded use: ``put``
    epochs from any thread, the daemon ``get``s them. ``sha`` is
    optional (content dedupe only happens when the producer supplies
    one or ``hash_payloads=True`` hashes the payload repr)."""

    def __init__(self, hash_payloads=False):
        self._q = queue.Queue()
        self._hash = bool(hash_payloads)
        self._closed = threading.Event()
        self._last = time.time()

    def put(self, epoch, payload, sha=None, tenant=None):
        if sha is None and self._hash:
            sha = content_hash(payload)
        self._q.put(ArrivedEpoch(str(epoch), payload, sha=sha,
                                 tenant=tenant))

    def get(self, timeout=None):
        try:
            item = self._q.get(timeout=timeout) if timeout \
                else self._q.get_nowait()
        except queue.Empty:
            return None
        self._last = time.time()
        return item

    def backlog(self):
        return self._q.qsize()

    def alive(self):
        return not self._closed.is_set()

    def last_activity(self):
        return self._last

    def close(self):
        self._closed.set()


class SpoolWatcher:
    """Polling spool-directory source.

    A background thread scans ``spool_dir`` for files matching
    ``pattern`` every ``poll_s`` seconds. A file is ADMITTED — content
    hashed, wrapped in an :class:`ArrivedEpoch`, queued for the
    daemon — once its size is positive and unchanged for
    ``settle_polls`` consecutive polls (the torn-file guard: a writer
    mid-stream keeps moving the size, so the file is only picked up
    complete). Each file is admitted at most once per process; a
    restarted daemon re-admits everything and relies on the results
    store to skip what was already published (resume) or already seen
    under another name (content dedupe).

    **Tenant attribution**: a first-level subdirectory of
    the spool is a tenant namespace — ``<spool>/<tenant>/<file>``
    arrives with ``tenant=<tenant>`` and epoch key
    ``<tenant>/<file>`` (two tenants may drop the same filename
    without colliding), while top-level files keep ``tenant=None``
    (the daemon's default tenant). ``tenant_of(rel_name, path)``
    overrides the mapping (return None for the default tenant). The
    daemon's admission control and fair-share lane quotas key off
    this attribution.

    **Claim mode** (``claim=True`` — the shared-spool fleet shape):
    N daemons watching ONE spool directory must
    never fit the same epoch twice. Before admitting a stable file,
    the watcher claims it with the fleet queue's rename primitive
    (``fleet/queue.py:claim_by_rename``): the file atomically moves
    into this watcher's own claim directory
    (``<spool>/.claims/<owner>/``) — exactly one of N racing watchers
    wins the rename, the losers see the file vanish and drop it
    (counted in ``serve_spool_claims_lost_total``). The admitted
    payload is the file's CLAIMED path, and a restarted daemon
    re-admits whatever is already in its own claim directory (its
    results store then resumes/dedupes as usual), so a crash between
    claim and publish loses nothing.
    """

    def __init__(self, spool_dir, pattern="*.dynspec", poll_s=0.2,
                 settle_polls=1, start=True, claim=False,
                 owner=None, tenant_of=None):
        self.spool_dir = os.fspath(spool_dir)
        self.pattern = pattern
        self.tenant_of = tenant_of
        self.poll_s = max(0.01, float(poll_s))
        self.settle_polls = max(1, int(settle_polls))
        self.claim = bool(claim)
        self.owner = str(owner) if owner else f"d{os.getpid()}"
        self.claim_dir = os.path.join(self.spool_dir, ".claims",
                                      self.owner)
        self._q = queue.Queue()
        self._seen = {}          # name -> (size, stable_polls)
        self._admitted = set()
        self._closed = threading.Event()
        self._last_poll = time.time()
        if self.claim:
            # crash recovery: files claimed by a previous incarnation
            # of this owner but never published — re-admit them (the
            # results store skips what was already published)
            try:
                for name in sorted(os.listdir(self.claim_dir)):
                    if fnmatch.fnmatch(name, self.pattern):
                        self._admit(name, os.path.join(self.claim_dir,
                                                       name))
            except FileNotFoundError:
                pass
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="spool-watcher")
        if start:
            self._thread.start()

    # ---- background poll loop ---------------------------------------
    def _run(self):
        while not self._closed.is_set():
            try:
                self._poll_once()
            except OSError as e:
                # a transient filesystem error (NFS blip, dir swap)
                # must not kill the watcher; surface and keep polling
                slog.log_failure("serve.watch_error", stage="poll",
                                 error=e)
            self._last_poll = time.time()
            self._closed.wait(self.poll_s)

    def _scan_names(self):
        """Spool-relative names of candidate files: top-level matches
        plus one level of tenant-namespace subdirectories
        (``<tenant>/<file>``), sorted."""
        names = []
        for n in os.listdir(self.spool_dir):
            if n.startswith("."):
                continue
            if fnmatch.fnmatch(n, self.pattern):
                names.append(n)
                continue
            sub = os.path.join(self.spool_dir, n)
            if not os.path.isdir(sub):
                continue
            try:
                names.extend(
                    f"{n}/{m}" for m in os.listdir(sub)
                    if not m.startswith(".")
                    and fnmatch.fnmatch(m, self.pattern))
            except OSError:
                continue                 # tenant dir vanished mid-poll
        return sorted(names)

    def _poll_once(self):
        try:
            names = self._scan_names()
        except FileNotFoundError:
            return                       # spool not created yet
        for name in names:
            if name in self._admitted:
                continue
            path = os.path.join(self.spool_dir, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue                 # vanished mid-poll
            prev_size, stable = self._seen.get(name, (None, 0))
            if size <= 0 or size != prev_size:
                self._seen[name] = (size, 0)
                continue
            stable += 1
            self._seen[name] = (size, stable)
            if stable < self.settle_polls:
                continue
            self._admit(name, path)

    def _admit(self, name, path):
        if self.claim and os.path.dirname(path) != self.claim_dir:
            from ..fleet.queue import claim_by_rename
            from ..obs import metrics as _metrics

            won = claim_by_rename(path, self.claim_dir)
            if won is None:
                # another daemon renamed it away first — theirs now;
                # remember the name so we stop re-sizing it
                _metrics.counter(
                    "serve_spool_claims_lost_total",
                    help="stable spool files lost to another "
                         "daemon's claim").inc()
                self._admitted.add(name)
                self._seen.pop(name, None)
                return
            _metrics.counter(
                "serve_spool_claims_won_total",
                help="stable spool files claimed by this daemon"
            ).inc()
            path = won
        try:
            with open(path, "rb") as fh:
                sha = content_hash(fh.read())
        except OSError as e:
            slog.log_failure("serve.watch_error", stage="admit",
                             error=e, epoch=name)
            return
        self._admitted.add(name)
        self._seen.pop(name, None)
        if self.tenant_of is not None:
            tenant = self.tenant_of(name, path)
        else:
            tenant = name.split("/", 1)[0] if "/" in name else None
        self._q.put(ArrivedEpoch(name, path, sha=sha, tenant=tenant))
        slog.log_event("serve.ingest", epoch=name, path=path,
                       sha=sha[:12], tenant=tenant)

    # ---- source interface -------------------------------------------
    def get(self, timeout=None):
        try:
            return self._q.get(timeout=timeout) if timeout \
                else self._q.get_nowait()
        except queue.Empty:
            return None

    def backlog(self):
        return self._q.qsize()

    def alive(self):
        return self._thread.is_alive() and not self._closed.is_set()

    def last_activity(self):
        """Wall time of the last completed poll (the /healthz
        staleness input: a wedged watcher stops advancing this)."""
        return self._last_poll

    def close(self):
        self._closed.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
