"""Survey execution of the port: atomic writes, the epoch journal, state
checkpoints, the pipelined loader and journal writer, and the
single-host device mesh with its distributed FFT and sharded survey
paths (``mesh.py``, ``fft.py``, ``survey.py``: one process drives every
card of the host, and a mesh may name one device more than once)."""

from .checkpoint import (EpochJournal, SurveyCheckpointer,
                         atomic_write_bytes, atomic_write_json,
                         results_state, run_survey_with_checkpoints)
from .fft import (make_fft2_sharded, make_gs_sharded,
                  make_sspec_power_sharded)
from .mesh import (DATA_AXIS, SEQ_AXIS, Mesh, batch_freq_sharding,
                   chunk_shardings, data_sharding, device_count, gather,
                   make_mesh, replicated, shard)
from .pipeline import (AsyncJournalWriter, DeferredResult, LoadedEpoch,
                       PrefetchLoader, finalize_result)
from .survey import (make_acf2d_fit_sharded, make_arc_fit_sharded,
                     make_arc_profile_sharded, make_eta_search_sharded,
                     make_fused_grid_search_sharded,
                     make_fused_thin_grid_search_sharded,
                     make_retrieval_sharded,
                     make_scenario_factory_sharded, make_survey_step,
                     make_thth_grid_search_sharded,
                     make_thth_thin_grid_search_sharded)

__all__ = ["EpochJournal", "SurveyCheckpointer", "atomic_write_bytes",
           "atomic_write_json", "results_state",
           "run_survey_with_checkpoints", "PrefetchLoader",
           "AsyncJournalWriter", "DeferredResult", "LoadedEpoch",
           "finalize_result",
           "make_mesh", "device_count", "DATA_AXIS", "SEQ_AXIS", "Mesh",
           "data_sharding", "batch_freq_sharding", "replicated",
           "chunk_shardings", "shard", "gather",
           "make_fft2_sharded", "make_gs_sharded",
           "make_sspec_power_sharded",
           "make_survey_step", "make_eta_search_sharded",
           "make_arc_profile_sharded", "make_arc_fit_sharded",
           "make_acf2d_fit_sharded", "make_retrieval_sharded",
           "make_thth_grid_search_sharded",
           "make_thth_thin_grid_search_sharded",
           "make_fused_grid_search_sharded",
           "make_fused_thin_grid_search_sharded",
           "make_scenario_factory_sharded"]
