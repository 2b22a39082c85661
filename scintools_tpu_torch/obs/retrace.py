"""Build accounting: one registry over every cached program factory.

The port's own copy of ``scintools_tpu/obs/retrace.py``. The port has
no jit, but it keeps built functions (with their device grids, plans
and index maps) per geometry where the JAX package keeps jitted
programs: the arc fit's device functions, the acf1d and acf2d
builders, the fused θ-θ searches, the scenario factory and the
spectrum-database FIFO. A silent rebuild per call costs what a retrace
did, so:

- every cached factory calls :func:`record_build` exactly on a cache
  MISS;
- :func:`compile_counts` / :func:`snapshot` expose per-site build
  counts and distinct-geometry counts (mirrored into the metrics
  registry as ``jit_builds_total{site=...}``, the JAX package's name,
  so the RunReport and Prometheus export carry them);
- while a torch profiler runs, each build also leaves an instant
  ``build`` record carrying its ``site`` among the program spans
  (:func:`.trace.program_spans`), on the device trace's clock;
- :func:`retrace_guard` is the regression gate: wrap a block that
  repeats an already-built workload and it raises
  :class:`RetraceRegression` if ANY site (or a named subset) built
  anew.

Keys are stored as hashes, never retained — geometry keys embed whole
``tau``/``fd`` grids as bytes and must not be kept alive here.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from . import trace as _trace

_LOCK = threading.Lock()
_SITES = {}     # site -> {"builds": int, "keys": set of key hashes}


class RetraceRegression(AssertionError):
    """A workload that should have hit a factory cache built new
    functions (see :func:`retrace_guard`)."""


def record_build(site, key=None, seconds=None):
    """Count one program build at ``site`` (call ONLY on a cache
    miss). ``key`` — the cache key, hashed for the distinct-geometry
    count and then dropped. ``seconds`` — the build's wall time when
    the caller measured it (forwarded to the program cost ledger as
    a ``compile`` sample)."""
    site = str(site)
    _trace.instant("build", site=site)
    with _LOCK:
        rec = _SITES.setdefault(site, {"builds": 0, "keys": set()})
        rec["builds"] += 1
        if key is not None:
            try:
                rec["keys"].add(hash(key))
            except TypeError:
                rec["keys"].add(hash(repr(key)))
    from . import metrics

    metrics.counter(
        "jit_builds_total",
        help="compiled-program builds per jit-cache site",
    ).labels(site=site).inc()
    if seconds is not None:
        from . import ledger

        ledger.record(site, seconds, "compile")


def compile_counts():
    """``{site: build_count}`` over every site seen this process."""
    with _LOCK:
        return {s: rec["builds"] for s, rec in sorted(_SITES.items())}


def snapshot():
    """JSON-able per-site view: builds + distinct geometry keys."""
    with _LOCK:
        return {s: {"builds": rec["builds"],
                    "distinct_keys": len(rec["keys"])}
                for s, rec in sorted(_SITES.items())}


def reset():
    with _LOCK:
        _SITES.clear()


@contextmanager
def retrace_guard(sites=None, allow=0):
    """Regression gate: raise :class:`RetraceRegression` if the block
    builds more than ``allow`` new programs (on ``sites`` — an
    iterable of site names — or anywhere when None).

    >>> fn(batch)                      # warm: compiles once
    >>> with retrace_guard():
    ...     fn(batch)                  # must hit every cache

    Yields a dict filled with the per-site new-build counts on exit
    (useful for reporting even when the guard passes)."""
    want = set(map(str, sites)) if sites is not None else None
    before = compile_counts()
    grew = {}
    try:
        yield grew
    finally:
        after = compile_counts()
        for site, n in after.items():
            if want is not None and site not in want:
                continue
            delta = n - before.get(site, 0)
            if delta > 0:
                grew[site] = delta
        total = sum(grew.values())
        if total > int(allow):
            raise RetraceRegression(
                f"{total} unexpected jit program build(s) "
                f"(allow={allow}): {grew} — a cached entry point is "
                f"retracing per call")
