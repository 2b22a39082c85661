"""Posterior engine of the PyTorch/CUDA port: walkers × epochs batched
ensemble sampling on a torch device, with survey posteriors calibrated
against closed-form truths and model evidence.

Counterpart of ``scintools_tpu/mcmc`` (its ``__all__``, :37-45):

- :mod:`~.sampler`: the batched stretch-move sampler, built once per
  geometry (``mcmc.sampler`` site), with per-lane torch generators and
  guards health bits;
- :mod:`~.likelihood`: the log-likelihood kernels over the fit models
  (acf1d cuts, the analytic 2-D ACF, the η profile, the velocity and
  orbit models) and uniform-box priors;
- :mod:`~.posterior`: chain reductions on the device (quantiles, ESS,
  split-R̂, truth ranks, the tempered-lane evidence);
- :mod:`~.survey`: the scenario factory's posterior survey through the
  runner, with the truth-coverage summary. ``run_mcmc_fleet`` waits for
  ``fleet/``.
"""

from .likelihood import (make_acf1d_loglike, make_acf2d_loglike,
                         make_eta_profile_loglike, make_model_loglike,
                         velocity_model_loglike)
from .posterior import (flatchain_summary, log_evidence, posterior_program,
                        summarize_posterior)
from .sampler import ensemble_program, run_ensemble_batched, walker_init
from .survey import (coverage_summary, mcmc_scenario_workload,
                     model_evidence_batched, run_mcmc_fleet,
                     run_mcmc_survey)

__all__ = [
    "ensemble_program", "run_ensemble_batched", "walker_init",
    "make_model_loglike", "make_acf1d_loglike", "make_acf2d_loglike",
    "make_eta_profile_loglike", "velocity_model_loglike",
    "posterior_program", "summarize_posterior", "flatchain_summary",
    "log_evidence", "mcmc_scenario_workload", "run_mcmc_survey",
    "run_mcmc_fleet", "coverage_summary", "model_evidence_batched",
]
