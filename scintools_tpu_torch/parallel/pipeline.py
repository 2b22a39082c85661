"""Pipelined execution primitives for the survey layer.

The port's own copy of ``scintools_tpu/parallel/pipeline.py``. A survey
loop that loads an epoch on the host, runs the device work, then blocks
on an fsynced journal line leaves the card idle during every load and
every fsync. This module gives the loop the input-pipeline shape a
training stack uses:

- :class:`PrefetchLoader` — a bounded-queue background epoch loader:
  loading + host preprocessing (parse, crop, ``float32``) run in
  worker threads while the card computes; epochs come back in
  DETERMINISTIC input order, and a loader exception is captured
  per-epoch (it becomes that epoch's quarantine record in the runner,
  never a pipeline crash). Loader threads do host work only: the
  upload to the card happens on the dispatching thread, so no loader
  thread touches the CUDA context;
- :class:`AsyncJournalWriter` — a threaded wrapper over
  :class:`~scintools_tpu_torch.parallel.checkpoint.EpochJournal` that
  moves the CRC/flush/fsync off the critical path, coalescing the
  fsync over whatever backlog accumulated (group commit). ``drain()``
  is the durability barrier; append ORDER is preserved exactly, so a
  pipelined run's journal is byte-identical to the sequential one's;
- :class:`DeferredResult` — an epoch result whose values may still be
  in flight on the card; ``finalize()`` fences and converts to
  JSON-able host scalars. The runner keeps up to K of these pending
  (dispatch-ahead) and only fences when a result is consumed.

The runner (robust/runner.py:run_survey) wires these together;
utils/profiling.py:StageTimeline accounts for the overlap.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .checkpoint import EpochJournal
from ..obs import metrics as _metrics
from ..utils.profiling import clock


@dataclass
class LoadedEpoch:
    """One epoch out of the prefetch queue: either a ``payload`` or
    the ``error`` its loader raised (never both meaningful at once).
    ``load_s`` is the wall time the background load took."""

    epoch: object
    payload: object = None
    error: BaseException = None
    load_s: float = 0.0

    @property
    def ok(self):
        return self.error is None


class PrefetchLoader:
    """Bounded background prefetch of survey epochs.

    ``epochs`` is the runner's usual iterable of ``(epoch_id,
    payload)``. A payload that is CALLABLE is treated as a lazy
    loader — it runs in one of ``workers`` background threads
    (``payload()`` → the real payload: read the file, parse, crop,
    normalize, pad, stack) while the consumer is busy with earlier
    epochs. Non-callable payloads pass through untouched (so eagerly
    loaded epoch lists keep working), and ``load_fn`` optionally maps
    EVERY payload (callable or not) in the background instead.

    Guarantees:

    - **deterministic order** — iteration yields ``(epoch_id,
      LoadedEpoch)`` in exactly the input order, whatever order the
      background loads finish in;
    - **bounded buffering** — at most ``depth`` epochs are loaded (or
      loading) ahead of the consumer; a slow consumer therefore never
      sees unbounded memory growth (tests pin this with a slow-reader
      probe);
    - **per-epoch error capture** — a loader exception is returned as
      ``LoadedEpoch.error`` for THAT epoch; later epochs are
      unaffected. The runner turns it into the epoch's quarantine
      record (MalformedInputError semantics).

    ``epochs`` is consumed LAZILY (one item pulled per free buffer
    slot), so an unbounded/blocking generator (a streaming spool
    feed) works: the feeder thread
    simply blocks inside the generator until the next epoch arrives.
    Use as an iterator (batch runs) or via :meth:`poll` (streaming:
    bounded-latency consumption that never blocks past a deadline);
    ``close()`` cancels outstanding loads (best effort) and joins the
    workers.
    """

    _SENTINEL = object()

    def __init__(self, epochs, depth=4, workers=2, load_fn=None,
                 timeline=None, stage="load"):
        self.depth = max(1, int(depth))
        self.workers = max(1, int(workers))
        self._load_fn = load_fn
        self._timeline = timeline
        self._stage = stage
        self._epochs = iter(epochs)
        # task queue carries (epoch_id, raw_payload, slot) — slot is a
        # one-item queue the feeder inserted into the ordered deque, so
        # results come back in submission order regardless of which
        # worker finishes first
        self._tasks = queue.Queue()
        self._order = collections.deque()
        self._slots = threading.Semaphore(self.depth)
        self._closed = threading.Event()
        self._threads = []
        self._feeder = threading.Thread(target=self._feed, daemon=True,
                                        name="prefetch-feeder")
        for i in range(self.workers):
            t = threading.Thread(target=self._work, daemon=True,
                                 name=f"prefetch-{i}")
            self._threads.append(t)
            t.start()
        self._feeder.start()

    # ---- background side --------------------------------------------
    def _feed(self):
        for epoch_id, payload in self._epochs:
            # bound: one semaphore slot per epoch loaded-or-loading
            # ahead of the consumer; released when the consumer takes
            # the item off the front of the deque
            while not self._slots.acquire(timeout=0.1):
                if self._closed.is_set():
                    return
            if self._closed.is_set():
                return
            slot = queue.Queue(maxsize=1)
            self._order.append(slot)
            self._tasks.put((epoch_id, payload, slot))
        self._order.append(self._SENTINEL)

    def _work(self):
        while not self._closed.is_set():
            try:
                epoch_id, payload, slot = self._tasks.get(timeout=0.1)
            except queue.Empty:
                continue
            t0 = clock()
            try:
                if self._load_fn is not None:
                    payload = self._load_fn(payload)
                elif callable(payload):
                    payload = payload()
                out = LoadedEpoch(epoch_id, payload=payload)
            except BaseException as e:  # noqa: BLE001 — captured
                # per-epoch: the runner quarantines it; a crash here
                # would kill the whole pipeline for one bad file
                out = LoadedEpoch(epoch_id, error=e)
            t1 = clock()
            out.load_s = t1 - t0
            _metrics.histogram(
                "survey_load_seconds",
                help="background epoch load+preprocess wall time",
            ).observe(out.load_s)
            if self._timeline is not None:
                self._timeline.record(epoch_id, self._stage, t0, t1)
            slot.put(out)

    # ---- consumer side ----------------------------------------------
    def _take_head(self, head):
        """Pop the completed head slot and free its buffer slot."""
        self._order.popleft()
        self._slots.release()
        _metrics.gauge(
            "survey_prefetch_queue_depth",
            help="epochs loaded-or-loading ahead of the consumer",
        ).set(self.buffered())

    def __iter__(self):
        while True:
            while not self._order:
                if self._closed.is_set():
                    return
                time.sleep(0.001)
            head = self._order[0]
            if head is self._SENTINEL:
                return
            item = head.get()          # blocks until ITS load is done
            self._take_head(head)
            yield item.epoch, item

    def poll(self, timeout=0.0):
        """Next ``(epoch_id, LoadedEpoch)`` if one completes within
        ``timeout`` seconds, else None. Unlike iteration this never
        blocks past the deadline — a streaming consumer uses it to
        keep draining its dispatch-ahead
        window (bounded ingest→publish latency) while the spool is
        idle. Returns None indefinitely once the input stream is
        exhausted (:attr:`exhausted` distinguishes end-of-stream from
        not-ready) or after :meth:`close`."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        while True:
            if self._order:
                head = self._order[0]
                if head is self._SENTINEL:
                    return None
                try:
                    item = head.get(timeout=max(
                        0.0, deadline - time.monotonic()))
                except queue.Empty:
                    return None
                self._take_head(head)
                return item.epoch, item
            if self._closed.is_set() \
                    or time.monotonic() >= deadline:
                return None
            time.sleep(0.001)

    @property
    def exhausted(self):
        """True once every input epoch has been consumed (the feeder
        reached end-of-stream and the consumer drained the buffer)."""
        return bool(self._order) and self._order[0] is self._SENTINEL

    def buffered(self):
        """Epochs currently loaded-or-loading ahead of the consumer
        (≤ ``depth`` by construction)."""
        n = len(self._order)
        return n - 1 if (self._order
                         and self._order[-1] is self._SENTINEL) else n

    def close(self):
        self._closed.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class AsyncJournalWriter:
    """Threaded, order-preserving writer over :class:`EpochJournal`.

    The sequential runner pays one flush+fsync per completed epoch
    INSIDE the survey loop. This writer enqueues the record and
    returns immediately; a single background thread drains the queue
    and appends the records — in enqueue order, with one fsync per
    drained BATCH (group commit) instead of per line. Line content
    and order are bit-for-bit what ``EpochJournal.append`` writes, so
    a pipelined run's journal is byte-identical to the sequential
    oracle's journal.

    Durability contract (pinned by a real-SIGKILL test): a SIGKILL may lose the enqueued-but-not-yet-fsynced TAIL;
    a resumed run reprocesses exactly those epochs and — results
    being deterministic — reproduces an uninterrupted run's journal
    byte-identically. ``drain()`` is the explicit durability barrier
    (the runner takes it at batch boundaries and before returning);
    a writer-thread failure (disk full, permissions) re-raises there
    and at the next ``append``.
    """

    _CLOSE = object()

    def __init__(self, journal, timeline=None, stage="journal"):
        if not isinstance(journal, EpochJournal):
            journal = EpochJournal(journal)
        self.journal = journal
        self._timeline = timeline
        self._stage = stage
        self._q = queue.Queue()
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="journal-writer")
        self._thread.start()

    def _run(self):
        import os

        while True:
            rec = self._q.get()
            if rec is self._CLOSE:
                return
            # group commit: take everything already queued, write all
            # lines, ONE flush+fsync for the batch — same bytes and
            # order as per-line EpochJournal.append
            batch = [rec]
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is self._CLOSE:
                    self._q.put(self._CLOSE)   # re-deliver after batch
                    break
                batch.append(nxt)
            t0 = clock()
            try:
                lines = [self.journal.format_line(epoch, **fields)
                         for epoch, fields in batch]
                data = "".join(line + "\n" for line in lines)
                with open(self.journal.path, "a") as fh:
                    fh.write(data)
                    fh.flush()
                    os.fsync(fh.fileno())
                _metrics.counter(
                    "survey_journal_bytes_total",
                    help="bytes appended to the epoch journal",
                ).inc(len(data.encode()))
                _metrics.counter(
                    "survey_journal_fsyncs_total",
                    help="journal fsync barriers taken",
                ).inc()
                if self._timeline is not None:
                    self._timeline.record(batch[0][0], self._stage,
                                          t0, clock())
            except BaseException as e:  # noqa: BLE001 — surfaced at
                # the next append()/drain(); a silent loss here would
                # break the resume guarantee
                self._error = e
            finally:
                for _ in batch:
                    self._q.task_done()

    def _check(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async journal writer failed: {err!r}") from err

    def append(self, epoch, **fields):
        """Enqueue one journal record (returns before it is
        durable; see :meth:`drain`)."""
        self._check()
        self._q.put((epoch, fields))

    def drain(self):
        """Block until every enqueued record is written AND fsynced —
        the durability barrier; re-raises a writer failure."""
        self._q.join()
        self._check()

    def close(self):
        """Drain, then stop the writer thread."""
        self.drain()
        self._q.put(self._CLOSE)
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@dataclass
class DeferredResult:
    """An epoch result whose values may still be executing on the
    device. ``process`` may return one of these (or a plain dict) —
    the pipelined runner keeps up to K deferred results in flight and
    calls :meth:`finalize` only when the result is consumed, so the
    device queue stays full instead of being fenced after every
    dispatch.

    ``value`` is a dict whose leaves may be device tensors; ``finalize_fn`` (optional) is called first and may
    itself return the dict (e.g. close over the in-flight device
    buffers and fetch them in one packed transfer)."""

    value: dict = field(default_factory=dict)
    finalize_fn: object = None

    def finalize(self):
        value = self.value
        if self.finalize_fn is not None:
            value = self.finalize_fn()
        return finalize_result(value)


def finalize_result(result):
    """Fence an epoch result into JSON-able host scalars: tensors (on
    any device; ``.detach().cpu()``, then ``.item()`` or
    ``.tolist()``) and arrays (anything with ``__array__``/0-d numpy)
    become Python floats/ints/lists, dicts/lists/tuples recurse, plain
    scalars and strings pass through. This is THE result-consumption
    boundary of the pipelined runner — the one place a dispatch-ahead
    window is allowed to synchronise with the card. A CUDA tensor
    never reaches ``np.asarray`` (it would raise) nor the journal's
    ``json.dumps(default=str)`` (which would write its repr)."""
    if isinstance(result, DeferredResult):
        return result.finalize()
    if isinstance(result, dict):
        return {k: finalize_result(v) for k, v in result.items()}
    if isinstance(result, (list, tuple)):
        return [finalize_result(v) for v in result]
    if isinstance(result, (str, bytes, bool)) or result is None:
        return result
    if isinstance(result, (int, float)):
        return result
    if isinstance(result, torch.Tensor):
        host = result.detach().cpu()
        return host.item() if host.ndim == 0 else host.tolist()
    if hasattr(result, "__array__") or isinstance(result, np.generic):
        arr = np.asarray(result)
        if arr.ndim == 0:
            return arr.item()
        return arr.tolist()
    return result
