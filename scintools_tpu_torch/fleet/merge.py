"""Deterministic merge of per-worker CRC-JSONL journals.

The port's own copy of ``scintools_tpu/fleet/merge.py``: for the same
worker journals the merged output is byte for byte the JAX merge's. A
fleet run leaves one epoch journal per worker (robust/runner.py
journals with the attribution columns ``worker``/``t_commit`` appended
by ``journal_extra``); the merge makes ONE canonical survey journal:

- **epoch-id total order** — lines follow the survey's epoch order (the
  ``order`` argument; ids not listed sort lexicographically at the
  end), never the order in which workers ran them;
- **first-committed-wins** — a stolen task can leave one epoch
  journaled by two workers. The earliest ``t_commit`` wins; ties break
  on worker id, then journal order. Epoch results are deterministic,
  so losers are byte-duplicates after stripping attribution; a
  difference is counted as a ``conflict`` and logged;
- **torn-tail tolerance** — journals are read through
  :meth:`EpochJournal.iter_records`, which CRC-skips a SIGKILLed
  worker's torn tail;
- **byte-reproducibility** — lines are re-serialised through
  :meth:`EpochJournal.format_line` with the attribution stripped; since
  ``journal_extra`` appends it at the END of each record, stripping
  restores a single-process run's exact bytes;
- **bounded memory** — :func:`merge_journals` streams through
  :func:`iter_merged`: an external sort (``chunk_records`` per chunk,
  sorted spill runs on disk) and a ``heapq.merge`` pass, with the same
  lines, winners and stats as the in-memory :func:`merge_records`."""

from __future__ import annotations

import heapq
import json
import os
import tempfile

from ..obs import metrics as _metrics
from ..parallel.checkpoint import EpochJournal
from ..utils import slog
from . import fsops as _fsops

#: the worker-attribution columns stripped from merged lines — the
#: "modulo" of the byte-identity contract.
ATTRIBUTION_FIELDS = ("worker", "t_commit")


def _commit_key(rec, path_index, line_index):
    """First-committed-wins total order: commit stamp, then worker
    id, then (journal, line) position for records without stamps."""
    try:
        t = float(rec.get("t_commit"))
    except (TypeError, ValueError):
        t = float("inf")
    return (t, str(rec.get("worker", "")), path_index, line_index)


def merge_records(journal_paths, order=None,
                  strip=ATTRIBUTION_FIELDS):
    """Merge per-worker journals into ``(lines, stats)`` without
    touching disk: ``lines`` are the canonical merged journal lines
    (sans newline) in epoch total order, ``stats`` counts what the
    merge saw. See the module docstring for the contract."""
    candidates = {}                     # epoch -> (commit_key, rec)
    duplicates = 0
    conflicts = 0
    n_read = 0
    for pi, path in enumerate(sorted(os.fspath(p)
                                     for p in journal_paths)):
        for li, rec in enumerate(EpochJournal(path).iter_records()):
            n_read += 1
            key = str(rec.get("epoch"))
            ck = _commit_key(rec, pi, li)
            held = candidates.get(key)
            if held is None:
                candidates[key] = (ck, rec)
                continue
            duplicates += 1
            first, second = ((held[1], rec) if held[0] <= ck
                             else (rec, held[1]))
            if _stripped(first, strip) != _stripped(second, strip):
                conflicts += 1
                slog.log_failure(
                    "fleet.merge_conflict", epoch=key, stage="merge",
                    error=ValueError(
                        "duplicate records differ after stripping "
                        "attribution — workload is not deterministic"),
                    winner=str(first.get("worker", "")),
                    loser=str(second.get("worker", "")))
            if ck < held[0]:
                candidates[key] = (ck, rec)
    ordered_keys = _total_order(candidates, order)
    lines = []
    for key in ordered_keys:
        rec = _stripped(candidates[key][1], strip)
        epoch = rec.pop("epoch")
        lines.append(EpochJournal.format_line(epoch, **rec))
    stats = {"epochs": len(lines), "records_read": n_read,
             "duplicates": duplicates, "conflicts": conflicts,
             "sources": len(list(journal_paths))}
    return lines, stats


def _stripped(rec, strip):
    return {k: v for k, v in rec.items() if k not in strip}


def _total_order(candidates, order):
    """Canonical epoch order: the caller's survey order first (ids
    not present in the journals are simply absent — an incomplete
    run merges deterministically too), then any journaled ids the
    caller didn't list, sorted."""
    keys = []
    seen = set()
    for key in (order or ()):
        key = str(key)
        if key in candidates and key not in seen:
            keys.append(key)
            seen.add(key)
    keys.extend(sorted(k for k in candidates if k not in seen))
    return keys


# ---------------------------------------------------------------------
# streaming k-way merge: the
# same contract as merge_records in O(chunk_records) memory — a
# 10^6-line fleet journal merges without holding its records resident
# ---------------------------------------------------------------------

def _epoch_rank(order):
    """Epoch id → canonical-order rank (first occurrence wins, the
    _total_order dedupe); unlisted ids share the past-the-end rank
    and fall back to lexicographic epoch-id order."""
    rank = {}
    for i, key in enumerate(order or ()):
        rank.setdefault(str(key), i)
    return rank


def _stream_key(rec, rank_of, pi, li):
    """The external-sort key: (order rank, epoch id, commit key) —
    records of one epoch become ADJACENT in the merged stream with
    the first-committed winner first, and epochs stream out in the
    exact _total_order sequence."""
    key = str(rec.get("epoch"))
    t, worker, _, _ = _commit_key(rec, pi, li)
    return (rank_of.get(key, len(rank_of)), key, t, worker, pi, li)


def _spill_run(buf, tmp_dir, fs=None):
    """Sort one in-memory chunk and spill it as a JSON-lines run
    file (``[key, record]`` per line; json round-trips the inf
    commit stamps of unstamped records)."""
    fs = fs or _fsops.DEFAULT
    buf.sort(key=lambda e: e[0])
    fd, path = tempfile.mkstemp(dir=tmp_dir, suffix=".run")
    with fs.fdopen(fd, "w", encoding="utf-8") as fh:
        for k, rec in buf:
            fh.write(json.dumps([list(k), rec]) + "\n")
    return path


def _iter_run(path):
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            k, rec = json.loads(line)
            yield ((int(k[0]), k[1], float(k[2]), k[3], int(k[4]),
                    int(k[5])), rec)


def iter_merged(journal_paths, order=None, strip=ATTRIBUTION_FIELDS,
                chunk_records=100_000, stats=None, tmp_dir=None,
                fs=None):
    """Stream the canonical merged journal lines (sans newline, in
    epoch total order) holding at most ``chunk_records`` records in
    memory: chunks external-sort into spill runs, a ``heapq.merge``
    k-way pass streams them back with same-epoch records adjacent
    (winner first), and the duplicate/conflict accounting happens on
    the fly. Byte-for-byte the same lines, winners, and stats as
    :func:`merge_records`; pass a
    dict as ``stats`` to receive the counts."""
    if stats is None:
        stats = {}
    paths = sorted(os.fspath(p) for p in journal_paths)
    stats.update(epochs=0, records_read=0, duplicates=0, conflicts=0,
                 sources=len(paths))
    rank_of = _epoch_rank(order)
    chunk_records = max(1, int(chunk_records))
    runs, buf = [], []
    own_tmp = None
    try:
        for pi, path in enumerate(paths):
            for li, rec in enumerate(EpochJournal(path).iter_records()):
                stats["records_read"] += 1
                buf.append((_stream_key(rec, rank_of, pi, li), rec))
                if len(buf) >= chunk_records:
                    if own_tmp is None and tmp_dir is None:
                        own_tmp = tempfile.mkdtemp(
                            prefix="fleet-merge-")
                    runs.append(_spill_run(buf, tmp_dir or own_tmp,
                                           fs=fs))
                    buf = []
        buf.sort(key=lambda e: e[0])
        merged = heapq.merge(*([_iter_run(p) for p in runs]
                               + [iter(buf)]),
                             key=lambda e: e[0])
        cur, winner = None, None
        for k, rec in merged:
            if k[1] != cur:
                if winner is not None:
                    stats["epochs"] += 1
                    yield _format_line(winner, strip)
                cur, winner = k[1], rec
                continue
            # adjacent same-epoch record: the winner streamed first
            # (commit key is in the sort key) — this one lost
            stats["duplicates"] += 1
            if _stripped(winner, strip) != _stripped(rec, strip):
                stats["conflicts"] += 1
                slog.log_failure(
                    "fleet.merge_conflict", epoch=cur, stage="merge",
                    error=ValueError(
                        "duplicate records differ after stripping "
                        "attribution — workload is not "
                        "deterministic"),
                    winner=str(winner.get("worker", "")),
                    loser=str(rec.get("worker", "")))
        if winner is not None:
            stats["epochs"] += 1
            yield _format_line(winner, strip)
    finally:
        for p in runs:
            try:
                # best-effort spill cleanup: retrying or degrading
                # here would mask the real error
                os.unlink(p)
            except OSError:
                pass
        if own_tmp is not None:
            try:
                os.rmdir(own_tmp)
            except OSError:
                pass


def _format_line(rec, strip):
    rec = _stripped(rec, strip)
    epoch = rec.pop("epoch")
    return EpochJournal.format_line(epoch, **rec)


def merge_journals(journal_paths, out_path, order=None,
                   strip=ATTRIBUTION_FIELDS, chunk_records=100_000,
                   fs=None):
    """Merge per-worker journals into the canonical survey journal at
    ``out_path`` (written atomically: temp + fsync + rename, so a
    reader — or a re-merge after a crash — never sees a torn merge).
    The merge STREAMS (:func:`iter_merged`): memory is bounded by
    ``chunk_records``, not the journal size. Writes go through the
    retrying fsops seam (``fs``); returns the merge stats dict; the
    merged file re-verifies line-for-line through the normal
    :class:`EpochJournal` reader."""
    fs = fs or _fsops.DEFAULT
    out_path = os.fspath(out_path)
    stats = {}
    out_dir = os.path.dirname(out_path) or "."
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".merge.tmp")
    try:
        with fs.fdopen(fd, "w", encoding="utf-8") as fh:
            for line in iter_merged(journal_paths, order=order,
                                    strip=strip, stats=stats,
                                    chunk_records=chunk_records,
                                    fs=fs):
                fh.write(line + "\n")
            fh.flush()
            fs.fsync(fh)
        fs.replace(tmp, out_path)
    except BaseException:
        try:
            # best-effort temp cleanup on the failure path: must not
            # retry or mask the raise
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _metrics.counter(
        "fleet_merge_epochs_total",
        help="epochs written to merged fleet journals").inc(
            stats["epochs"])
    slog.log_event("fleet.merge", out=os.fspath(out_path), **stats)
    return stats
