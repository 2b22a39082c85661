"""The façade's fitting chunk grid (``dynspec._centred_chunk_grid``, cut
and centred on the search's device from one float64 upload) against the
host chunks (``dynspec._centred_chunk`` cast to float32, the list route
of ``thth.search``): the same values within one float32 ulp of each
chunk's scale, NaN, ±inf, all-NaN chunks and a cropped spectrum
included; ``fit_thetatheta`` on the grid gives the host route's health
bits and curvatures; a list of host arrays still takes the host stack.

Each test runs on the CPU and, with a card, on the card (the ``cuda``
case skips without one). The file imports only the port."""

import warnings

import numpy as np
import pytest
import torch

from scintools_tpu_torch import BasicDyn, Dynspec
from scintools_tpu_torch import dynspec as tdyn
from scintools_tpu_torch.thth import search as tsearch
from scintools_tpu_torch.workloads import make_arc_dynspec

CW = 32
DT, DF, F0, ETA = 2.0, 0.05, 1400.0, 5e-4
PREP = dict(cwf=64, cwt=64, npad=1, eta_min=0.5 * ETA, eta_max=2.0 * ETA,
            neta=24, nedge=32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # tier-1 runs under xdist workers
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["cpu", "cuda"])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(request.param)


def spectrum(case, seed=3):
    """A float64 (nf, nt) spectrum whose values are not float32-exact,
    damaged as ``case`` says."""
    rng = np.random.default_rng(seed)
    shape = (3 * CW + 7, 2 * CW + 5) if case == "cropped" else (
        3 * CW, 2 * CW)
    d = 40.0 + 3.7 * rng.normal(size=shape)
    if case == "nan":
        d[rng.random(shape) < 0.05] = np.nan
    elif case == "all_nan":
        d[CW:2 * CW, :CW] = np.nan
        d[3, 5] = np.nan
    elif case == "inf":
        d[5, 7] = np.inf                    # chunk (0, 0): mean +inf
        d[CW + 2, CW + 3] = -np.inf         # chunk (1, 1): mean -inf
        d[2 * CW + 1, 4] = np.inf           # chunk (2, 0): +inf and -inf
        d[2 * CW + 9, 20] = -np.inf
    return d


def host_grid(d):
    """``_centred_chunk`` of every fitting chunk, cast to float32."""
    ncf, nct = d.shape[0] // CW, d.shape[1] // CW
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.stack([[np.asarray(tdyn._centred_chunk(
            d, *tdyn._chunk_slices(cf, ct, CW, CW)), dtype=np.float32)
            for ct in range(nct)] for cf in range(ncf)])


@pytest.mark.parametrize("case", ["float64", "nan", "all_nan", "inf",
                                  "cropped"])
def test_grid_equals_the_host_chunks(case, device):
    d = spectrum(case)
    want = host_grid(d)
    ncf, nct = want.shape[:2]
    got = tdyn._centred_chunk_grid(
        torch.as_tensor(d[:ncf * CW, :nct * CW], device=device), CW, CW)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.device.type == device.type
    got = got.cpu().numpy()
    assert got.shape == want.shape == (3, 2, CW, CW)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    inf = ~np.isfinite(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    for cf in range(ncf):
        for ct in range(nct):
            w, g = want[cf, ct], got[cf, ct]
            fin = np.isfinite(w)
            if not fin.any():
                continue
            ulp = np.spacing(np.abs(w[fin]).max())
            assert np.abs(g[fin] - w[fin]).max() <= ulp
    if case == "all_nan":
        assert not got[1, 0].any()
    if case == "inf":
        assert np.isposinf(got[0, 0]).sum() == 0       # +inf - inf: NaN → 0
        assert np.isneginf(got[0, 0]).sum() == CW * CW - 1
        assert np.isposinf(got[1, 1]).sum() == CW * CW - 1
        assert not got[2, 0].any()                     # a NaN mean: zeros


def facade(proc, device):
    nf, nt = 2 * PREP["cwf"], 3 * PREP["cwt"]
    dyn = make_arc_dynspec(nt, nf, DT, DF, F0, ETA, n_images=24, seed=11)
    dyn[:PREP["cwf"], PREP["cwt"]:2 * PREP["cwt"]] = np.nan  # all-NaN chunk
    dyn[PREP["cwf"] + 3, 5] = np.nan
    ds = Dynspec(dyn=BasicDyn(dyn, freqs=F0 + DF * np.arange(nf),
                              times=DT * np.arange(nt)),
                 process=False, verbose=False, device=device)
    ds.prep_thetatheta(fitting_proc=proc, **PREP)
    return ds


@pytest.mark.parametrize("proc", ["standard", "thin"])
def test_the_fit_on_the_grid_is_the_host_routes(proc, device):
    ds = facade(proc, device)
    ds.fit_thetatheta()
    eta = np.zeros((ds.ncf_fit, ds.nct_fit))
    ok = np.zeros_like(eta, dtype=int)
    for cf in range(ds.ncf_fit):
        chunks, times = [], []
        for ct in range(ds.nct_fit):
            dspec2, freq2, time2 = ds._chunk(cf, ct)
            chunks.append(dspec2)
            times.append(time2)
        etas, edges = ds._thth_row_geometry(freq2)
        if proc == "thin":
            res = ds._thin_search(chunks, freq2, times, etas, edges)
        else:
            res = tsearch.multi_chunk_search(
                chunks, freq2, times, etas, edges, fw=ds.fw, npad=ds.npad,
                tau_mask=ds.thth_tau_mask, device=ds.device)
        eta[cf] = [r.eta for r in res]
        ok[cf] = [r.ok for r in res]
    np.testing.assert_array_equal(ds.eta_evo_ok, ok)
    assert ok[0, 1] != 0 and np.isfinite(eta).sum() >= 4
    np.testing.assert_allclose(ds.eta_evo, eta, rtol=1e-4)


@pytest.mark.parametrize("proc", ["standard", "thin"])
def test_a_list_still_takes_the_host_stack(proc, device, monkeypatch):
    rng = np.random.default_rng(5)
    chunks = [40.0 + rng.normal(size=(CW, CW)) for _ in range(3)]
    freq = F0 + DF * np.arange(CW)
    times = [DT * (np.arange(CW) + CW * k) for k in range(3)]
    etas = np.geomspace(1e-4, 1e-2, 12)
    edges = np.linspace(-1.0, 1.0, 16)
    stacks, uploads = [], []
    stack_chunks, fused_results = tsearch._stack_chunks, tsearch._fused_results

    def stack_spy(dspecs):
        out = stack_chunks(dspecs)
        stacks.append((type(dspecs), type(out)))
        return out

    def upload_spy(fn, stack, *args):
        uploads.append(stack)
        return fused_results(fn, stack, *args)

    monkeypatch.setattr(tsearch, "_stack_chunks", stack_spy)
    monkeypatch.setattr(tsearch, "_fused_results", upload_spy)

    def search(dspecs):
        if proc == "thin":
            return tsearch.multi_chunk_search_thin(
                dspecs, freq, times, etas, edges, edges[:8], 0.0, npad=1,
                device=device)
        return tsearch.multi_chunk_search(dspecs, freq, times, etas, edges,
                                          npad=1, device=device)

    from_list = search(chunks)
    assert stacks == [(list, np.ndarray)]
    assert isinstance(uploads[0], np.ndarray)
    grid = torch.as_tensor(np.stack(chunks), dtype=torch.float32,
                           device=device)
    from_grid = search(grid)
    assert stacks[1] == (torch.Tensor, torch.Tensor)
    assert uploads[1] is grid                  # nothing left to copy
    for a, b in zip(from_list, from_grid):
        assert a.ok == b.ok
        np.testing.assert_array_equal(a.eigs, b.eigs)
        np.testing.assert_array_equal([a.eta, a.eta_sig], [b.eta, b.eta_sig])


@pytest.mark.parametrize("route", ["staged", "one_chunk", "thin_staged",
                                   "thin_svd"])
def test_a_stack_on_a_host_route_is_fetched(route, device):
    rng = np.random.default_rng(6)
    n = 1 if route == "one_chunk" else 2
    chunks = [(40.0 + rng.normal(size=(CW, CW))).astype(np.float32)
              for _ in range(n)]
    freq = F0 + DF * np.arange(CW)
    times = [DT * (np.arange(CW) + CW * k) for k in range(n)]
    etas = np.geomspace(1e-4, 1e-2, 12)
    edges = np.linspace(-1.0, 1.0, 16)

    def search(dspecs):
        if route.startswith("thin"):
            return tsearch.multi_chunk_search_thin(
                dspecs, freq, times, etas, edges, edges[:8], 0.0, npad=1,
                device=device, fused=False,
                eig="svd" if route == "thin_svd" else "power")
        return tsearch.multi_chunk_search(dspecs, freq, times, etas, edges,
                                          npad=1, device=device,
                                          fused=route != "staged")

    from_list = search(chunks)
    from_stack = search(torch.as_tensor(np.stack(chunks), device=device))
    assert len(from_stack) == n
    for a, b in zip(from_list, from_stack):
        assert a.ok == b.ok
        np.testing.assert_array_equal(a.eigs, b.eigs)
        np.testing.assert_array_equal([a.eta, a.eta_sig], [b.eta, b.eta_sig])
