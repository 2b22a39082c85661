"""robust layer of the PyTorch/CUDA port: the device health guards,
the fallback ladder, the fault injectors and the journaled, pipelined
survey runner. Re-exports every name of
``scintools_tpu/robust/__init__.py``."""

from ..parallel.checkpoint import EpochJournal
from .faults import (corrupt_file_tail, inject_nan_pixels,
                     inject_neginf_db, maybe_fail, tier_failure_hook,
                     truncate_chunk_stack)
from .guards import (BAD_CS, BAD_CURVE, BAD_FIT, BAD_INPUT, BAD_PEAKFIT,
                     OK, chunk_finite_ok, curve_health, describe_health,
                     health_code, sanitize_chunks)
from .ladder import (TIER_FUSED, TIER_NUMPY, TIER_STAGED, LadderError,
                     is_transient, run_ladder, thth_search_ladder)
from .runner import (EpochOutcome, outcome_dicts, run_group, run_survey,
                     run_survey_batched)

__all__ = [
    "OK", "BAD_INPUT", "BAD_CS", "BAD_CURVE", "BAD_PEAKFIT",
    "BAD_FIT", "describe_health", "chunk_finite_ok",
    "sanitize_chunks", "curve_health", "health_code",
    "TIER_FUSED", "TIER_STAGED", "TIER_NUMPY", "LadderError",
    "is_transient", "run_ladder", "thth_search_ladder",
    "inject_nan_pixels", "inject_neginf_db", "truncate_chunk_stack",
    "corrupt_file_tail", "tier_failure_hook", "maybe_fail",
    "EpochOutcome", "run_survey", "run_survey_batched", "run_group",
    "outcome_dicts", "EpochJournal",
]
