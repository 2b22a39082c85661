"""sim layer of the PyTorch/CUDA port: the Coles-2010 simulation, the
Rickett-2014 analytic ACF, the Yao-2020 brightness, the batched scenario
factory and the closed-loop scenario workload."""

from .acf_model import ACF
from .brightness import Brightness
from .factory import (SIM_GROUP_SIZE, lane_keys_from_seeds,
                      make_scenario_factory, simulate_scenarios,
                      simulate_screens)
from .scenario import (DEFAULT_REGIMES, recovery_summary, scenario_truths,
                       scenario_workload)
from .simulation import Simulation, simulate_dynspec_batch

__all__ = ["ACF", "Brightness", "DEFAULT_REGIMES", "SIM_GROUP_SIZE",
           "Simulation", "lane_keys_from_seeds", "make_scenario_factory",
           "recovery_summary", "scenario_truths", "scenario_workload",
           "simulate_dynspec_batch", "simulate_scenarios",
           "simulate_screens"]
