"""Survey execution primitives of the port: atomic writes, the epoch
journal, state checkpoints and the pipelined loader / journal writer.
The sharded paths (``parallel/mesh.py``, ``fft.py``, ``survey.py``) and
``initialize_distributed`` wait for the port's multi-GPU layer."""

from .checkpoint import (EpochJournal, SurveyCheckpointer,
                         atomic_write_bytes, atomic_write_json,
                         results_state, run_survey_with_checkpoints)
from .pipeline import (AsyncJournalWriter, DeferredResult, LoadedEpoch,
                       PrefetchLoader, finalize_result)

__all__ = ["EpochJournal", "SurveyCheckpointer", "atomic_write_bytes",
           "atomic_write_json", "results_state",
           "run_survey_with_checkpoints", "PrefetchLoader",
           "AsyncJournalWriter", "DeferredResult", "LoadedEpoch",
           "finalize_result"]
