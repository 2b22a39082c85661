"""Program cost ledger: persistent per-site runtime profiling.

The port's own copy of ``scintools_tpu/obs/ledger.py``: every
:func:`obs.retrace.record_build` site may report its build seconds
here (kind ``"compile"``), and every repeatedly-dispatched function
can report steady-state seconds (kind ``"steady"``) via
:func:`record` / the :func:`timed` context manager.

- entries are keyed ``(site, platform, shape, formulation)`` and hold
  a compile total plus a bounded ring buffer of steady samples —
  recording is O(1), and a no-op while
  :func:`obs.metrics.set_enabled` (False) holds;
- samples mirror into the metrics registry as
  ``program_steady_seconds{site=,formulation=}`` /
  ``program_compile_seconds{site=}`` histograms;
- the ledger **persists**: :func:`save`/:func:`load` speak the same
  atomic CRC-JSONL dialect as the epoch journal (torn-tail tolerant,
  ``os.replace`` atomic), one file per workdir
  (:func:`workdir_path`).

The platform key is the torch device type (``"cuda"`` when a card is
present, else ``"cpu"``) where the JAX package stamps its backend
name.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections import deque
from contextlib import contextmanager

#: steady-sample ring size per (site, platform, shape, formulation)
#: entry — bounds memory for any run length while keeping enough
#: samples for a stable median.
RING = 256

#: basename of the per-workdir ledger file (see :func:`workdir_path`).
LEDGER_BASENAME = "program_ledger.jsonl"


def _line_crc(payload):
    """CRC32 of a ledger line's JSON payload (sans the crc field),
    zero-padded hex — same dialect as the epoch journal."""
    return f"{zlib.crc32(payload.encode()):08x}"


def _median(values):
    vals = sorted(values)
    n = len(vals)
    if not n:
        return None
    mid = n // 2
    if n % 2:
        return vals[mid]
    return 0.5 * (vals[mid - 1] + vals[mid])


class ProgramLedger:
    """Process-wide cost ledger; see the module docstring.

    Thread-safe (one lock; loader threads and the dispatch loop
    record concurrently). Entries are created on first record and
    never dropped within a process — sites are code literals, shapes
    are bucket sizes, formulations come from the registered choice
    tuples, so the key space is bounded by construction.
    """

    def __init__(self, ring=RING):
        self._lock = threading.Lock()
        self._entries = {}   # key tuple -> entry dict
        self._ring = int(ring)
        self._platform = None

    # -- keying ----------------------------------------------------

    def platform(self):
        """The platform label stamped on new samples: the torch device
        type of the default device (``"cuda"`` with a card, else
        ``"cpu"``), cached after first resolution."""
        with self._lock:
            if self._platform is None:
                import torch

                self._platform = torch.device(
                    "cuda" if torch.cuda.is_available() else "cpu").type
            return self._platform

    def _key(self, site, platform, shape, formulation):
        return (str(site),
                str(platform) if platform is not None else self.platform(),
                "" if shape is None else str(shape),
                "" if formulation is None else str(formulation))

    def _entry_locked(self, key):
        ent = self._entries.get(key)
        if ent is None:
            ent = self._entries[key] = {
                "compile_s": 0.0, "compile_n": 0,
                "steady": deque(maxlen=self._ring)}
        return ent

    # -- recording -------------------------------------------------

    def record(self, site, seconds, kind="steady", *, shape=None,
               formulation=None, platform=None):
        """Record one wall-time sample for ``site``.

        ``kind`` is ``"steady"`` (a post-warm-up program execution;
        ring-buffered, feeds :func:`steady_median`) or ``"compile"``
        (a program build; totalled). No-op while the metrics switch
        is off — the same ``set_enabled`` gate every probe honours.
        """
        from . import metrics

        if not metrics.enabled():
            return
        seconds = float(seconds)
        site = str(site)
        key = self._key(site, platform, shape, formulation)
        with self._lock:
            ent = self._entry_locked(key)
            if kind == "compile":
                ent["compile_s"] += seconds
                ent["compile_n"] += 1
            else:
                ent["steady"].append(seconds)
        if kind == "compile":
            metrics.histogram(
                "program_compile_seconds",
                help="program build wall time per jit-cache site",
            ).labels(site=site).observe(seconds)
        else:
            metrics.histogram(
                "program_steady_seconds",
                help="steady-state program wall time per ledger site",
            ).labels(site=site, formulation=key[3]).observe(seconds)

    @contextmanager
    def timed(self, site, *, shape=None, formulation=None,
              kind="steady"):
        """Time a block into the ledger (perf_counter; recorded even
        when the block raises — a failing program still cost its
        seconds)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(site, time.perf_counter() - t0, kind,
                        shape=shape, formulation=formulation)

    # -- reading ---------------------------------------------------

    def steady_median(self, site, *, shape=None, formulation=None,
                      platform=None):
        """Median steady seconds over every entry matching ``site``
        (and, when given, ``shape``/``formulation``/``platform``),
        or None with no samples. The gain scheduler's read path."""
        site = str(site)
        shape = None if shape is None else str(shape)
        formulation = None if formulation is None else str(formulation)
        platform = None if platform is None else str(platform)
        samples = []
        with self._lock:
            for (s, p, sh, f), ent in self._entries.items():
                if s != site:
                    continue
                if shape is not None and sh != shape:
                    continue
                if formulation is not None and f != formulation:
                    continue
                if platform is not None and p != platform:
                    continue
                samples.extend(ent["steady"])
        return _median(samples)

    def steady_site_medians(self):
        """``{site: median_steady_seconds}`` aggregated over every
        shape/formulation/platform of each site — the RunReport
        ``slo.sites`` view."""
        sites = {}
        with self._lock:
            for (site, _, _, _), ent in self._entries.items():
                if ent["steady"]:
                    sites.setdefault(site, []).extend(ent["steady"])
        return {s: round(_median(v), 6)
                for s, v in sorted(sites.items())}

    def snapshot(self):
        """JSON-able view: ``{"platform":, "entries": [...]}`` with
        one row per key carrying compile totals and steady-sample
        stats (count / total / best / median)."""
        rows = []
        with self._lock:
            items = sorted(self._entries.items())
            for (site, plat, shape, form), ent in items:
                steady = list(ent["steady"])
                rows.append({
                    "site": site, "platform": plat, "shape": shape,
                    "formulation": form,
                    "compile_s": round(ent["compile_s"], 6),
                    "compile_n": ent["compile_n"],
                    "steady_n": len(steady),
                    "steady_total_s": round(sum(steady), 6),
                    "steady_best_s": round(min(steady), 6)
                    if steady else None,
                    "steady_median_s": round(_median(steady), 6)
                    if steady else None,
                })
        return {"platform": self.platform(), "entries": rows}

    # -- persistence (atomic CRC-JSONL) ----------------------------

    def save(self, path):
        """Atomically write the full ledger as CRC-JSONL: one line
        per entry, each carrying its raw steady ring (rounded) and a
        crc over the rest of the record — the epoch-journal dialect,
        so a reader (or a resume after SIGKILL) sees either the old
        ledger or the complete new one."""
        from ..parallel.checkpoint import atomic_write_bytes

        lines = []
        with self._lock:
            for (site, plat, shape, form), ent in sorted(
                    self._entries.items()):
                rec = {"site": site, "platform": plat, "shape": shape,
                       "formulation": form,
                       "compile_s": round(ent["compile_s"], 6),
                       "compile_n": ent["compile_n"],
                       "steady": [round(s, 6) for s in ent["steady"]]}
                payload = json.dumps(rec)
                lines.append(json.dumps(
                    {**rec, "crc": _line_crc(payload)}))
        atomic_write_bytes(os.fspath(path),
                           ("\n".join(lines) + "\n").encode()
                           if lines else b"")

    def load(self, path):
        """Merge a saved ledger back in (compile totals add, steady
        samples append into the rings). Corrupt or torn lines are
        skipped — a ledger truncated mid-line by a crash loses that
        line, never the file. Missing file is an empty ledger.
        Returns the number of entries merged."""
        path = os.fspath(path)
        if not os.path.exists(path):
            return 0
        merged = 0
        with open(path) as fh:
            for raw in fh:
                line = raw.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    crc = rec.pop("crc")
                    if crc != _line_crc(json.dumps(rec)):
                        raise ValueError("crc mismatch")
                    key = (str(rec["site"]), str(rec["platform"]),
                           str(rec.get("shape", "")),
                           str(rec.get("formulation", "")))
                    compile_s = float(rec.get("compile_s", 0.0))
                    compile_n = int(rec.get("compile_n", 0))
                    steady = [float(s) for s in rec.get("steady", [])]
                except (ValueError, KeyError, TypeError):
                    continue
                with self._lock:
                    ent = self._entry_locked(key)
                    ent["compile_s"] += compile_s
                    ent["compile_n"] += compile_n
                    ent["steady"].extend(steady)
                merged += 1
        return merged

    def reset(self):
        with self._lock:
            self._entries.clear()
            self._platform = None


#: the process-wide ledger every call site records into.
LEDGER = ProgramLedger()


def record(site, seconds, kind="steady", **kw):
    LEDGER.record(site, seconds, kind, **kw)


def timed(site, **kw):
    return LEDGER.timed(site, **kw)


def steady_median(site, **kw):
    return LEDGER.steady_median(site, **kw)


def snapshot():
    return LEDGER.snapshot()


def save(path):
    LEDGER.save(path)


def load(path):
    return LEDGER.load(path)


def reset():
    LEDGER.reset()


def workdir_path(workdir):
    """The per-workdir ledger file a restarted run loads at start
    and saves at stop: ``<workdir>/program_ledger.jsonl``."""
    return os.path.join(os.fspath(workdir), LEDGER_BASENAME)
