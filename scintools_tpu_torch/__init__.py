"""scintools_tpu_torch — the PyTorch/CUDA port of scintools_tpu.

The θ-θ curvature search runs end to end on a CUDA card: windowed,
padded secondary spectrum → per-chunk mean-padded conjugate spectra →
θ-θ gather over the η grid → dominant eigenvalue per (chunk, η) by a
hand-written Hopper kernel (``csrc/eig_warmstart.cu``) → closed-form
parabola peak fit with a per-chunk health mask → weighted global
η ∝ f⁻² fit. The wavefield is then retrieved on the card: per-chunk
θ-θ of a half-overlap chunk grid → dominant eigenpair by a second entry
of the same kernel, warm-started along chains of chunks → inverse map
and cropped ifft2 → device mosaic → Gerchberg–Saxton. Scintillation
parameters come from the ACF: the analytic 2-D ACF model and batched
Levenberg–Marquardt fits run on the card (``fit/``, ``sim/``), the
scipy fits on the host. The simulator (``sim/``: the Coles-2010
``Simulation``, the batched scenario factory and the closed
generate → search → fit workload, ``Brightness``) makes its screens and
propagates them on the card too. Surveys run through the journaled,
pipelined runner with its fallback ladder (``robust/``, ``obs/``,
``parallel/``): ``run_psrflux_survey``, ``run_wavefield_survey`` and
``sim.scenario.run_scenario_survey``. Entry points take
``device=None``, meaning the card; pass ``device="cpu"`` to run the
plain PyTorch versions on the CPU.

The package imports torch, numpy and scipy only: it shares no code
with the JAX package ``scintools_tpu``, whose layout and function
names it keeps.
"""

from .dynspec import (BasicDyn, Dynspec, HoloDyn, MatlabDyn, SimDyn,
                      run_psrflux_survey, run_wavefield_survey, sort_dyn)
from .io.psrflux import load_psrflux, write_psrflux
from .ops.sspec import secondary_spectrum
from .sim import (ACF, DEFAULT_REGIMES, SIM_GROUP_SIZE, Brightness,
                  Simulation,
                  lane_keys_from_seeds, recovery_summary, scenario_truths,
                  simulate_scenarios, simulate_screens)
from .thth.retrieval import (campaign_retrieval_batch, gerchberg_saxton,
                             grid_retrieval_batch, mosaic_device)
from .thth.search import multi_chunk_search, multi_chunk_search_thin

__all__ = ["ACF", "BasicDyn", "Brightness", "DEFAULT_REGIMES", "Dynspec",
           "HoloDyn", "MatlabDyn", "SIM_GROUP_SIZE", "SimDyn", "Simulation",
           "campaign_retrieval_batch", "gerchberg_saxton",
           "grid_retrieval_batch", "lane_keys_from_seeds", "load_psrflux",
           "mosaic_device", "multi_chunk_search", "multi_chunk_search_thin",
           "recovery_summary", "run_psrflux_survey", "run_wavefield_survey",
           "scenario_truths", "secondary_spectrum",
           "simulate_scenarios", "simulate_screens", "sort_dyn",
           "write_psrflux"]
