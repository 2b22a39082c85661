"""File input and output of the port: psrflux files, par files and
the results CSV."""

from .parfile import pars_to_params, read_par
from .psrflux import MalformedInputError, load_psrflux, write_psrflux
from .results import float_array_from_dict, read_results, write_results

__all__ = ["load_psrflux", "write_psrflux", "MalformedInputError",
           "read_par", "pars_to_params", "write_results", "read_results",
           "float_array_from_dict"]
