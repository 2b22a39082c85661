"""fit layer of the PyTorch/CUDA port: lmfit-style parameters, the
scipy host fits, the batched Levenberg–Marquardt fits on the device,
the survey ACF fits, the 2-D ACF fit and the ensemble samplers (the host
numpy one and the device one). Re-exports the names of
``scintools_tpu/fit/__init__.py``."""

from . import models
from .acf2d import fit_acf2d_batch, fit_acf2d_tpu
from .batch import (acf_cuts_batch, make_acf1d_batch, make_acf1d_fit_one,
                    scint_params_acf2d_batch, scint_params_batch)
from .ensemble import make_ensemble_sampler, make_logp, sample_emcee_jax
from .fitter import fitter, minimize_leastsq, sample_emcee
from .lm import lm_covariance, make_lm_fit_fn, make_lm_solver
from .parameters import Parameters

__all__ = ["Parameters", "fitter", "minimize_leastsq", "sample_emcee",
           "sample_emcee_jax", "make_ensemble_sampler", "make_logp",
           "make_lm_solver",
           "make_lm_fit_fn", "lm_covariance", "make_acf1d_batch",
           "make_acf1d_fit_one", "scint_params_batch",
           "scint_params_acf2d_batch", "acf_cuts_batch", "fit_acf2d_tpu",
           "fit_acf2d_batch", "models"]
