"""Tiered per-epoch fallback ladder for the survey path.

The port's own copy of ``scintools_tpu/robust/ladder.py``. One epoch
can fail three distinct ways, each wanting a different response:

1. **transient environment errors** — a CUDA out-of-memory error
   (``torch.OutOfMemoryError``, a ``RuntimeError`` saying "out of
   memory") on one geometry. Response: bounded retries, then
   *batch-halving* (an OOM on a B-chunk stack often clears at B/2),
   then the next tier.
2. **tier-specific bugs/limits** — the fused route rejects a geometry
   the staged route handles. Response: drop a tier. The ladder is
   fused → staged (``fused=False`` parity oracle) → the per-chunk
   reference route, each tier strictly simpler than the one above it.
   The tier names are the JAX package's (``"jax_fused"``,
   ``"jax_staged"``, ``"numpy"``), so journals name tiers the same way
   in both packages; here every tier runs on the same device.
3. **corrupt data** — non-finite inputs, malformed files. No tier can
   fix those: the runner quarantines the epoch; the ladder does NOT
   descend.

One deliberate difference from the JAX package: a
:class:`~scintools_tpu_torch.backend.KernelError` (a hand-written
kernel that does not build, load or launch, or no card), and a device
fault that a kernel raised asynchronously ("CUDA error: ...",
:func:`~scintools_tpu_torch.backend.is_kernel_error`), is re-raised at
once — never retried, descended past or quarantined. Descending would
hide the broken kernel behind a slower answer, and a device fault
leaves the CUDA context unusable for every tier below.

Every transition emits one structured slog failure record with the
canonical fields (utils/slog.py:log_failure). The fault-injection hook
(robust/faults.py:maybe_fail) is consulted before every attempt, which
is how the tests drive tiers to fail deterministically.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import faults
from ..backend import is_kernel_error
from ..obs import metrics as _metrics
from ..utils import slog

TIER_FUSED = "jax_fused"
TIER_STAGED = "jax_staged"
TIER_NUMPY = "numpy"

# substrings marking a RuntimeError as a transient environment fault
# (compile/OOM) — worth retrying and batch-halving; the JAX package's
# markers, which take torch's "CUDA out of memory" too.
_TRANSIENT_MARKERS = ("resource_exhausted", "out of memory", "oom",
                      "compile", "compilation", "deadline_exceeded",
                      "unavailable", "internal:", "injected fault")


class LadderError(RuntimeError):
    """Every tier of the fallback ladder failed for one epoch. Carries
    the per-attempt records so the caller can quarantine with a full
    explanation instead of a bare traceback. ``fatal`` marks an abort
    on a corrupt input (:func:`_is_fatal`) — no further tier may be
    tried for it (the pipelined runner checks this before descending
    the remaining tiers on a deferred tier-0 failure)."""

    def __init__(self, epoch, stage, attempts, fatal=False):
        self.epoch = epoch
        self.stage = stage
        self.fatal = bool(fatal)
        self.attempts = list(attempts)
        last = attempts[-1] if attempts else None
        super().__init__(
            f"all {len({a['tier'] for a in attempts})} tiers failed "
            f"for epoch {epoch!r} (stage {stage!r}); last: "
            f"{last['error_class'] if last else '?'}: "
            f"{last['error'] if last else '?'}")


def _is_fatal(exc):
    """Errors no tier can fix (corrupt/malformed input): the ladder
    aborts instead of burning the slower tiers on the same file."""
    from ..io import MalformedInputError

    return isinstance(exc, MalformedInputError)


def is_transient(exc):
    """True for RuntimeErrors that look like transient environment
    faults (compile/OOM) — the class the ladder retries and
    batch-halves. Everything else (ValueError from bad geometry,
    MalformedInputError from a bad file, ...) fails the tier at
    once, and a kernel error or device fault is never transient."""
    if is_kernel_error(exc) or not isinstance(exc, RuntimeError):
        return False
    msg = str(exc).lower()
    return any(m in msg for m in _TRANSIENT_MARKERS)


@dataclass
class LadderReport:
    """What it took to produce one epoch's result."""

    tier: str = ""            # tier that finally succeeded
    retries: int = 0          # total failed attempts across tiers
    halved: bool = False      # batch-halving was needed
    attempts: list = field(default_factory=list)  # failure records


def _record(report, epoch, stage, tier, exc, retry):
    rec = {"epoch": epoch, "stage": stage, "tier": tier,
           "error_class": type(exc).__name__,
           "error": str(exc)[:300], "retry": retry}
    report.attempts.append(rec)
    report.retries += 1
    _metrics.counter(
        "survey_fallback_transitions_total",
        help="failed ladder attempts (per tier that failed)",
    ).labels(tier=str(tier)).inc()  # lint-ok: metric-hygiene: bounded=tier
    slog.log_failure("robust.fallback", epoch=epoch, stage=stage,
                     error=exc, tier=tier, retry=retry)


def run_ladder(tiers, epoch=None, stage="search", retries=1,
               report=None):
    """Run ``tiers`` — an ordered list of ``(name, callable)`` — until
    one succeeds. Transient failures (:func:`is_transient`) are
    retried up to ``retries`` extra times on the SAME tier before
    descending; non-transient failures descend immediately. Returns
    ``(value, LadderReport)``; raises :class:`LadderError` when every
    tier is exhausted. A kernel error or device fault
    (:func:`~scintools_tpu_torch.backend.is_kernel_error`) propagates
    unchanged."""
    report = report or LadderReport()
    for name, fn in tiers:
        attempt = 0
        while True:
            try:
                faults.maybe_fail(name, epoch=epoch, stage=stage)
                value = fn()
            except Exception as exc:  # noqa: BLE001 — ladder boundary
                if is_kernel_error(exc):
                    raise
                _record(report, epoch, stage, name, exc, attempt)
                if _is_fatal(exc):
                    raise LadderError(epoch, stage, report.attempts,
                                      fatal=True)
                if is_transient(exc) and attempt < int(retries):
                    attempt += 1
                    continue
                break  # next tier
            report.tier = name
            return value, report
    raise LadderError(epoch, stage, report.attempts)


def _halved(fn_batch, dspecs, times, depth=3):
    """Run ``fn_batch(dspecs, times)`` with recursive batch-halving on
    transient errors: an OOM on B chunks often clears at B/2 (half
    the θ-θ batch resident per program). Depth-bounded; re-raises
    when halving bottoms out at single chunks."""
    try:
        return fn_batch(dspecs, times)
    except Exception as exc:  # noqa: BLE001 — halving boundary
        if not is_transient(exc) or depth <= 0 or len(dspecs) <= 1:
            raise
        mid = len(dspecs) // 2
        left = _halved(fn_batch, dspecs[:mid], times[:mid],
                       depth=depth - 1)
        right = _halved(fn_batch, dspecs[mid:], times[mid:],
                        depth=depth - 1)
        return list(left) + list(right)


def thth_search_ladder(dspecs, freq, times, etas, edges, fw=0.1,
                       npad=3, coher=True, tau_mask=0.0, epoch=None,
                       retries=1, halve=True, tiers=None, device=None):
    """The θ-θ chunk-batch search behind the full fallback ladder, on
    ``device`` (``None``: the card): the fused search
    (``multi_chunk_search``) → the staged route (``fused=False``: the
    float64 host FFT per chunk, the device eigen curves, the scipy peak
    fit) → the per-chunk ``single_search`` loop (the JAX numpy
    backend's route), with bounded retries and batch-halving on
    transient OOM RuntimeErrors. Every tier runs the warm-start
    eigensolver, so on the card every tier launches ``eig_warmstart``.
    Same signature semantics as ``thth.search.multi_chunk_search``;
    returns ``(results, LadderReport)`` where ``results`` is the usual
    list of ``ChunkSearchResult``. ``tiers`` restricts the ladder
    (default: all three, in order)."""
    from ..backend import resolve_device
    from ..thth.search import multi_chunk_search, single_search

    dev = resolve_device(device)
    kw = dict(fw=fw, npad=npad, coher=coher, tau_mask=tau_mask,
              device=dev)

    def batch_fn(fused):
        def run(ds, ts):
            return multi_chunk_search(list(ds), freq, list(ts), etas,
                                      edges, fused=fused, **kw)

        return run

    def per_chunk(ds, ts):
        return [single_search(d, freq, t, etas, edges, **kw)
                for d, t in zip(ds, ts)]

    def tier_call(fn):
        if halve:
            return lambda: _halved(fn, list(dspecs), list(times))
        return lambda: fn(list(dspecs), list(times))

    all_tiers = [
        (TIER_FUSED, tier_call(batch_fn(True))),
        (TIER_STAGED, tier_call(batch_fn(False))),
        (TIER_NUMPY, tier_call(per_chunk)),
    ]
    if tiers is not None:
        want = list(tiers)
        all_tiers = [t for t in all_tiers if t[0] in want]
    return run_ladder(all_tiers, epoch=epoch, stage="thth_search",
                      retries=retries)
