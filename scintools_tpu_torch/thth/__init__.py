"""thth layer of the PyTorch/CUDA port: θ-θ maps, the curvature
searches and the wavefield retrieval. Re-exports the names of
``scintools_tpu/thth/__init__.py`` that the port defines
(``plot_func`` waits for the port's plotting)."""

from .batch import (make_fused_grid_eval_fn, make_fused_search_fn,
                    make_fused_thin_search_fn, make_multi_eval_fn,
                    make_thin_eval_fn)
from .core import (arc_edges, chisq_calc, cs_to_ri, eval_calc,
                   eval_calc_batch, ext_find, fft_axis, len_arc,
                   make_eval_fn, min_edges, modeler, rev_map,
                   singularvalue_calc, thth_map, thth_redmap,
                   two_curve_map, unit_checks)
from .peakfit import fit_eig_peak_batch_device, fit_eig_peak_device
from .retrieval import (calc_asymmetry, campaign_retrieval_batch,
                        chunk_retrieval_batch, err_string,
                        gerchberg_saxton, grid_retrieval_batch, mask_func,
                        mosaic, mosaic_device, refine_mosaic,
                        resolve_retrieval_method, single_chunk_retrieval,
                        vlbi_chunk_retrieval, vlbi_retrieval_batch)
from .search import (chi_par, fit_eig_peak, multi_chunk_search,
                     multi_chunk_search_thin, single_search,
                     single_search_thin)

__all__ = [
    "thth_map", "thth_redmap", "rev_map", "modeler", "eval_calc",
    "eval_calc_batch", "make_eval_fn", "make_multi_eval_fn",
    "chisq_calc", "two_curve_map", "singularvalue_calc", "min_edges",
    "arc_edges", "len_arc", "ext_find", "fft_axis", "cs_to_ri",
    "unit_checks", "single_search", "single_search_thin",
    "multi_chunk_search", "multi_chunk_search_thin",
    "make_thin_eval_fn", "fit_eig_peak", "chi_par",
    "make_fused_search_fn", "make_fused_thin_search_fn",
    "make_fused_grid_eval_fn", "fit_eig_peak_device",
    "fit_eig_peak_batch_device",
    "single_chunk_retrieval", "vlbi_chunk_retrieval",
    "vlbi_retrieval_batch", "chunk_retrieval_batch",
    "grid_retrieval_batch", "campaign_retrieval_batch", "mosaic",
    "mosaic_device", "resolve_retrieval_method", "refine_mosaic",
    "gerchberg_saxton", "calc_asymmetry", "mask_func", "err_string",
]
