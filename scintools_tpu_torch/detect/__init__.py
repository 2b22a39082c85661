"""Streaming template-bank arc detection of the PyTorch/CUDA port.

Counterpart of ``scintools_tpu/detect`` (its exports, :41-48):

- :mod:`~.bank`: the log-spaced η template bank on the device;
- :mod:`~.correlate`: the overlap-save correlation of an epoch stack
  against the whole bank (cuFFT spectra, one matrix product);
- :mod:`~.refine`: sub-grid η refinement through the chirp-Z zoom;
- :mod:`~.trigger`: per-template noise floors, the significance
  threshold, the health gate, and the θ-θ confirmation of a hit (the
  ``eig_warmstart`` kernel on the card);
- :mod:`~.online`: :class:`ArcDetector`, scan → trigger → refine →
  confirm per epoch or epoch group, and its daemon hooks.
"""

from .bank import TemplateBank, build_bank, eta_grid  # noqa: F401
from .correlate import (correlate_bank, correlate_program,  # noqa: F401
                        extract_blocks, time_blocks)
from .online import ArcDetector  # noqa: F401
from .refine import (refine_band, refine_eta,  # noqa: F401
                     refine_program, refine_window)
from .trigger import (calibrate_noise_floor, confirm_eta,  # noqa: F401
                      extract_triggers, trigger_program)

__all__ = ["TemplateBank", "build_bank", "eta_grid", "correlate_bank",
           "correlate_program", "extract_blocks", "time_blocks",
           "ArcDetector", "refine_band", "refine_eta", "refine_program",
           "refine_window", "calibrate_noise_floor", "confirm_eta",
           "extract_triggers", "trigger_program"]
