"""Reference-name compatibility layer.

scintools uses camelCase/legacy names in ``ththmod``; this package
uses snake_case. Users migrating from the reference can
``from scintools_tpu_torch import compat as thth`` (or import the specific
alias) and keep their call sites. Each alias maps to the function
listed in its docstring-of-origin:

===================  ==========================================
reference name        scintools_tpu_torch implementation
===================  ==========================================
Eval_calc             thth.core.eval_calc
VLBI_chunk_retrieval  thth.retrieval.vlbi_chunk_retrieval
errString             thth.retrieval.err_string
errCalc               thth.search.err_calc
rotMos                thth.retrieval.rot_mos
rotInit               thth.retrieval.rot_init
rotFit / rotDer       thth.retrieval.refine_mosaic(mode='rot')
fullMos* family       thth.retrieval.refine_mosaic(mode='full')
svd_model             utils.misc.svd_model
===================  ==========================================

The fullMos/rot hand-derived gradient/Hessian entry points
(ththmod.py:1708-2310) are intentionally collapsed into
``refine_mosaic`` — autodiff supplies the derivatives. The port's own
copy of ``scintools_tpu/compat.py``.
"""

from .thth.core import (eval_calc as Eval_calc,  # noqa: N811
                        thth_map, thth_redmap, rev_map, modeler,
                        chisq_calc, two_curve_map, singularvalue_calc,
                        min_edges, arc_edges, len_arc, ext_find,
                        fft_axis, unit_checks)
from .thth.search import (single_search, single_search_thin, chi_par,
                          err_calc as errCalc)  # noqa: N811
from .thth.retrieval import (
    single_chunk_retrieval,
    vlbi_chunk_retrieval as VLBI_chunk_retrieval,  # noqa: N811
    mosaic, mask_func, gerchberg_saxton, calc_asymmetry,
    err_string as errString,  # noqa: N811
    rot_mos as rotMos,        # noqa: N811
    rot_init as rotInit,      # noqa: N811
    refine_mosaic)
from .thth.plots import plot_func
from .utils.misc import svd_model
from .ops.acf import autocorr_direct as autocorr  # scint_utils.py:67-84

__all__ = [
    "Eval_calc", "VLBI_chunk_retrieval", "errString", "errCalc",
    "rotMos", "rotInit", "refine_mosaic", "thth_map", "thth_redmap",
    "rev_map", "modeler", "chisq_calc", "two_curve_map",
    "singularvalue_calc", "min_edges", "arc_edges", "len_arc",
    "ext_find", "fft_axis", "unit_checks", "single_search",
    "single_search_thin", "chi_par", "single_chunk_retrieval",
    "mosaic", "mask_func", "gerchberg_saxton", "calc_asymmetry",
    "plot_func", "svd_model", "autocorr",
]


def rotFit(chunks, x0=None, maxiter=200):  # noqa: N802
    """rotFit/rotDer equivalent (ththmod.py:1773-1788): global
    per-chunk phase optimisation; derivatives via autodiff. ``x0``
    seeds the per-chunk phases as in the reference."""
    return refine_mosaic(chunks, mode="rot", maxiter=maxiter, x0=x0)


def fullMosFit(chunks, dspec, noise=None, maxiter=200):  # noqa: N802
    """fullMosFit/fullMosGrad/fullMosHess equivalent
    (ththmod.py:1990-2310): joint phase+amplitude fit against the
    dynamic spectrum; derivatives via autodiff."""
    return refine_mosaic(chunks, dspec=dspec, noise=noise, mode="full",
                         maxiter=maxiter)
