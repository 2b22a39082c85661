"""fit layer of the PyTorch/CUDA port: lmfit-style parameters, the
scipy host fits, the batched Levenberg–Marquardt fits on the device,
the survey ACF fits and the 2-D ACF fit. Re-exports the names of
``scintools_tpu/fit/__init__.py`` that the port defines (the MCMC
samplers wait for the port's ``mcmc/``)."""

from . import models
from .acf2d import fit_acf2d_batch, fit_acf2d_tpu
from .batch import (acf_cuts_batch, make_acf1d_batch, make_acf1d_fit_one,
                    scint_params_acf2d_batch, scint_params_batch)
from .fitter import fitter, minimize_leastsq
from .lm import lm_covariance, make_lm_fit_fn, make_lm_solver
from .parameters import Parameters

__all__ = ["Parameters", "fitter", "minimize_leastsq", "make_lm_solver",
           "make_lm_fit_fn", "lm_covariance", "make_acf1d_batch",
           "make_acf1d_fit_one", "scint_params_batch",
           "scint_params_acf2d_batch", "acf_cuts_batch", "fit_acf2d_tpu",
           "fit_acf2d_batch", "models"]
