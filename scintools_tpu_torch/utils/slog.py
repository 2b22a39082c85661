"""Structured (JSON-lines) logging for pipelines and surveys.

The port's own copy of ``scintools_tpu/utils/slog.py``, record for
record: the same event names, the same fields, the same environment
variables (``SCINTOOLS_LOG=<path>`` enables file logging,
``SCINTOOLS_LOG_ECHO=1`` mirrors to stderr).

- ``log_event(event, **fields)`` — one JSON object per line with a
  wall-clock timestamp and the emitting ``pid``, to stderr and/or a
  file;
- ``configure(path=None, echo=True)`` — process-wide sink;
- ``span(event, **fields)`` — context manager that logs start/end
  with duration and error status;
- ``log_failure(...)`` — the canonical failure record of the survey
  layer (quarantine, ladder transitions);
- ``recent(n, event)`` — the bounded in-memory tail, kept even with no
  sink configured;
- ``reset()`` — clear the in-memory tail and restore the sink to its
  environment defaults (test isolation).

The file sink keeps ONE cached append handle (reopened when the path
changes or after a fork). Writes are flushed per line and serialised
under a lock, so records from the prefetch-loader threads and the
journal writer interleave whole-line. Standard library only.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager


def _env_state():
    return {
        "path": os.environ.get("SCINTOOLS_LOG") or None,
        "echo": bool(int(os.environ.get("SCINTOOLS_LOG_ECHO", "0"))),
    }


_STATE = _env_state()

# cached file-sink handle: {"fh", "path", "pid"} — reopened when the
# configured path changes, on reset(), or when the pid changed (a
# fork must not share the parent's buffered handle position)
_SINK = {"fh": None, "path": None, "pid": None}
_LOCK = threading.Lock()

# in-memory tail of recent events, kept even with no sink configured:
# the robust survey layer reads failure records back for its run
# summary, and a post-mortem can inspect the last events of a run
# that never configured a log file. Bounded, so never a leak.
_RECENT = deque(maxlen=512)


def _close_sink_locked():
    fh = _SINK["fh"]
    _SINK.update(fh=None, path=None, pid=None)
    if fh is not None:
        try:
            fh.close()
        except OSError:  # broad is fine: a failed close of a log
            # handle must never propagate into the survey
            pass


def configure(path=None, echo=None):
    """Set the process-wide log sink. ``path=None`` keeps the current
    file (env ``SCINTOOLS_LOG`` by default); ``echo`` mirrors events
    to stderr. Changing the path closes the cached handle so the next
    event reopens the new file."""
    with _LOCK:
        if path is not None:
            _STATE["path"] = path
            _close_sink_locked()
        if echo is not None:
            _STATE["echo"] = bool(echo)


def reset():
    """Restore the logger to a fresh state: close the cached sink
    handle, clear the in-memory tail, and re-read the environment
    defaults, so a test that filters :func:`recent` sees only its
    own events."""
    with _LOCK:
        _close_sink_locked()
        _RECENT.clear()
        _STATE.clear()
        _STATE.update(_env_state())


def enabled():
    return bool(_STATE["path"] or _STATE["echo"])


def recent(n=None, event=None):
    """The last ``n`` in-memory event records (all when None),
    optionally filtered by exact event name. Records are kept even
    when no sink is configured."""
    recs = list(_RECENT)
    if event is not None:
        recs = [r for r in recs if r.get("event") == event]
    return recs if n is None else recs[-int(n):]


def log_failure(event="robust.failure", epoch=None, stage=None,
                error=None, tier=None, retry=0, **extra):
    """Structured failure record with the canonical field set the
    robust survey layer emits on every quarantine / fallback-ladder
    transition: epoch id, pipeline stage, error
    class + message, the tier that failed (or None before dispatch),
    and the retry count. ``error`` may be an exception instance or a
    string."""
    fields = {"epoch": epoch, "stage": stage, "tier": tier,
              "retry": int(retry)}
    if error is not None:
        if isinstance(error, BaseException):
            fields["error_class"] = type(error).__name__
            fields["error"] = str(error)[:300]
        else:
            fields["error_class"] = "str"
            fields["error"] = str(error)[:300]
    fields.update(extra)
    log_event(event, **fields)


def _sink_handle_locked():
    """The cached append handle for the configured path, (re)opened
    when the path or pid changed. Caller holds ``_LOCK``."""
    path, pid = _STATE["path"], os.getpid()
    if _SINK["fh"] is None or _SINK["path"] != path \
            or _SINK["pid"] != pid:
        _close_sink_locked()
        _SINK.update(fh=open(path, "a"), path=path, pid=pid)
    return _SINK["fh"]


def log_event(event, **fields):
    """Emit one structured event. Always recorded in the in-memory
    tail (:func:`recent`); written to stderr/file only when a sink is
    configured. Each record is stamped with the emitting ``pid``."""
    rec = {"t": round(time.time(), 3), "pid": os.getpid(),
           "event": event, **fields}
    # deque.append is atomic under the GIL
    # (single C-level op, bounded maxlen); _LOCK only serialises the
    # file-sink handle, and taking it here would put every event on
    # the survey hot path behind the writer
    _RECENT.append(rec)
    if not enabled():
        return
    line = json.dumps(rec, default=str)
    if _STATE["echo"]:
        print(line, file=sys.stderr)
    if _STATE["path"]:
        try:
            with _LOCK:
                fh = _sink_handle_locked()
                fh.write(line + "\n")
                fh.flush()
        except OSError as e:  # never let logging kill a survey
            print(f"Warning: structured log write failed ({e})",
                  file=sys.stderr)


@contextmanager
def span(event, **fields):
    """Log ``<event>.start`` / ``<event>.end`` around a block, with
    wall-clock duration and error capture (the error propagates)."""
    log_event(event + ".start", **fields)
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:
        log_event(event + ".end", ok=False, error=repr(e),
                  secs=round(time.perf_counter() - t0, 4), **fields)
        raise
    log_event(event + ".end", ok=True,
              secs=round(time.perf_counter() - t0, 4), **fields)
