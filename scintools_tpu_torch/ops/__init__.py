"""ops layer of the PyTorch/CUDA port: spectra, ACFs, windows, the
arc fit, normalisation, inpainting and the transform layer."""

from . import xfft
from .acf import acf_from_sspec, autocorr_direct, autocovariance
from .fitarc import ArcFit, fit_arc
from .inpaint import inpaint_biharmonic
from .normsspec import normalise_sspec
from .sspec import secondary_spectrum, secondary_spectrum_power
from .windows import get_window

__all__ = ["secondary_spectrum", "secondary_spectrum_power",
           "autocovariance", "acf_from_sspec", "autocorr_direct",
           "get_window", "fit_arc", "ArcFit", "normalise_sspec",
           "inpaint_biharmonic", "xfft"]
