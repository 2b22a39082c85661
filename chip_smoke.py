"""Drive the PyTorch/CUDA port's θ-θ curvature search and wavefield
retrieval on one card.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs
one CUDA card, ``nvcc`` (``$NVCC``, ``PATH`` or ``$CUDA_HOME/bin``) and
no network, and builds every kernel in ``scintools_tpu_torch/csrc``
(one ``nvcc`` per source, all started together) on first use.

Phases, each of which exits non-zero on failure:

1. device: name, count, and name/power limit from ``nvidia-smi``;
2. every kernel against its plain PyTorch version on the card, on
   (a) a smoothly drifting hermitian batch, (b) the avoided-crossing
   batch of the TPU kernel's tests and (c) θ-θ batches gathered at the
   north-star geometry for one chunk group × 200 η, all at N = 256;
   times of the kernel, its plain version and ``torch.linalg.eigvalsh``
   (a yardstick the port never calls) on the main path's shapes; then
   the eigenvector entry on (a) read as 4 chains of 24 and (b) as one
   chain of 24, with its times beside ``torch.linalg.eigh``'s;
3. the north-star pipeline at 4096² (8×8 chunks of 512², 200 η,
   256 edges), timed end to end from the dynspec on the card, with
   the η gates against truth and against the plain eigensolver;
4. the ``Dynspec`` façade on the same dynspec:
   ``calc_sspec → prep_thetatheta → fit_thetatheta``;
5. wavefield retrieval on that fitted façade (15×15 half-overlap
   chunks of 512², N = 256, chains of 25): ``retrieve_wavefield`` (the
   kernel route, timed by stage); ``calc_wavefield`` (the dense
   ``eigh`` route and numpy mosaic), held to the kernel route per chunk
   where the chunk's θ-θ gap is ≥ 10% (below that the chained warm
   start lags the dense eigenvector by design, as the JAX kernel's
   does); the plain route, held to the kernel route everywhere (the
   stitched intensities to rel L2 < 5e-3 and corr > 0.9999); the
   eigenpair stage's times and its λ and v against plain; a bitwise
   rerun; the quarantine of one poisoned chunk; ``gerchberg_saxton``.

Launch counts are taken per path: zeroed just before the timed
north-star run and read just after it, then zeroed again just before
the façade and read just after ``fit_thetatheta``, and for the
eigenvector entry zeroed just before the timed ``retrieve_wavefield``
and read just after it; each must be > 0. It prints a
``{"kernels": [...]}`` line (``launches`` is the sum over the paths
that run the kernel, with each path's count beside it), the card's
``nvidia-smi`` name and power limit, and as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# CUDA-core FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
GROUP = 32          # north-star chunks per eigensolver launch
N_ETA = 200


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def timed(fn, reps=1):
    """``(result of the last run, mean ms)`` of ``reps`` runs of
    ``fn()`` on the card, by CUDA events (callers warm up first)."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1) / reps


class Marks:
    """Stage timer for the pipelines' ``mark(name)`` callback: the
    time between consecutive marks is added to the later mark's
    name."""

    def __init__(self):
        self.events = []
        self.start()

    def start(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events = [("start", ev)]

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def totals(self):
        torch.cuda.synchronize()
        out = {}
        for (_, e0), (name, e1) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + e0.elapsed_time(e1)
        return out


def random_hermitian(rng, n, batch):
    a = rng.normal(size=(batch, n, n)) + 1j * rng.normal(size=(batch, n, n))
    return (a + np.conj(np.transpose(a, (0, 2, 1)))) / 2


def drift_batch(rng, n=256, B=4, neta=24):
    """(a): a dominant rank-1 part plus a small random hermitian
    background, drifting smoothly along η."""
    u = rng.normal(size=(B, n, 1)) + 1j * rng.normal(size=(B, n, 1))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    base = (random_hermitian(rng, n, B) / np.sqrt(n)
            + 3.0 * u @ np.conj(np.transpose(u, (0, 2, 1))))
    drift = random_hermitian(rng, n, B) / np.sqrt(n) * 0.01
    return np.stack([base + k * drift for k in range(neta)], axis=1)


def crossing_batch(n=256, nsteps=24, eps=0.02, seed=13):
    """(b): the avoided crossing of the TPU kernel's tests
    (tests/test_pallas_eig.py TestWarmStartCrossing) at N = 256, with
    the background scaled to keep its spectral radius as at n = 32."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n))
                        + 1j * rng.normal(size=(n, n)))
    u, w = q[:, 0:1], q[:, 1:2]
    junk = random_hermitian(rng, n, 1)[0] * 0.02 * np.sqrt(32 / n)
    mats = []
    for t in np.linspace(0.0, 1.0, nsteps):
        lam_a, lam_b = 2.0 - t, 1.2 + t
        A = (lam_a * (u @ np.conj(u.T)) + lam_b * (w @ np.conj(w.T))
             + eps * (u @ np.conj(w.T) + w @ np.conj(u.T)) + junk)
        mats.append((A + np.conj(A.T)) / 2)
    return np.array(mats)[None]


def top2(a_ri):
    """(λ₁, λ₂) of every matrix by ``torch.linalg.eigvalsh``."""
    ev = torch.linalg.eigvalsh(torch.complex(a_ri[:, :, 0], a_ri[:, :, 1]))
    return ev[..., -1], ev[..., -2]


def compare(name, kern, plain, lam12=None, rtol=1e-4):
    """Kernel vs plain: within ``rtol`` of the plain value (atol 1e-7 of
    the curve's largest |λ|) where λ₁−λ₂ ≥ 5%·λ₁ (everywhere when
    ``lam12`` is None). At a near-degenerate point the two may take
    different restart branches (a threshold test), so there the kernel
    passes when it agrees with the plain value OR lies within
    [λ₂, λ₁] with 1e-4·λ₁ float32 slack. Returns (max abs err, max
    rel err at gapped points, n caveat)."""
    err = (kern - plain).abs()
    atol = 1e-7 * plain.abs().amax(dim=1, keepdim=True)
    tight = err <= rtol * plain.abs() + atol
    near = torch.zeros_like(tight)
    if lam12 is not None:
        l1, l2 = lam12
        near = (l1 - l2) < 0.05 * l1.abs()
        slack = 1e-4 * l1.abs()
        below, above = kern < l2 - slack, kern > l1 + slack
        inside = ~below & ~above
        p_below, p_above = plain < l2 - slack, plain > l1 + slack
        print(f"  {name}: near-degenerate points below λ₂ / above λ₁: "
              f"kernel {int((near & below).sum())} / "
              f"{int((near & above).sum())}, plain "
              f"{int((near & p_below).sum())} / "
              f"{int((near & p_above).sum())}; of those the kernel agrees "
              f"with plain at {int((near & ~inside & tight).sum())}",
              flush=True)
        check(bool((inside | tight)[near].all()),
              f"{name}: at a near-degenerate point the kernel is neither "
              "within [λ₂, λ₁] nor equal to its plain version")
    bad = ~tight & ~near
    rel = (err / plain.abs().clamp_min(1e-30))[~near]
    print(f"  {name}: {kern.numel()} points, {int(near.sum())} under the "
          f"near-degenerate caveat, max |k-p| {err.max().item():.3e}, "
          f"max rel (gapped) {rel.max().item() if rel.numel() else 0:.3e}",
          flush=True)
    check(not bool(bad.any()), f"{name}: kernel disagrees with its plain "
          f"version at {int(bad.sum())} gapped points (rtol {rtol})")
    return err.max().item(), (rel.max().item() if rel.numel() else 0.0), \
        int(near.sum())


def compare_vec(name, vk, vp, gapped=None):
    """Kernel vs plain eigenvectors ``(..., 2, N)``: phase-aligned
    correlation |⟨v_k, v_p⟩| / (‖v_k‖‖v_p‖) > 0.9999 at gapped points
    (everywhere when ``gapped`` is None). Returns the least
    correlation there."""
    k = torch.complex(vk[..., 0, :].double(), vk[..., 1, :].double())
    p = torch.complex(vp[..., 0, :].double(), vp[..., 1, :].double())
    corr = ((torch.conj(k) * p).sum(-1).abs()
            / (k.norm(dim=-1) * p.norm(dim=-1)).clamp_min(1e-300))
    if gapped is not None:
        corr = corr[gapped]
    low = corr.min().item()
    print(f"  {name}: least aligned eigenvector correlation {low:.9f} over "
          f"{corr.numel()} gapped points", flush=True)
    check(low > 0.9999, f"{name}: kernel eigenvector decorrelated from "
          "its plain version")
    return low


def eig_bound_ms(M, n, n_cold, iters=24, out_floats=1):
    """Least time for the eigensolver's work on this run's data over M
    matrices: input read once + ``out_floats`` per matrix written once
    over HBM bandwidth, against the warm mat-vecs (iters + 2 complex N²
    mat-vecs per warm matrix) plus the cold starts this data needed (15
    complex N³ squarings and 3 mat-vecs each) over the f32 CUDA-core
    peak."""
    nbytes = M * 2 * n * n * 4 + M * out_floats * 4
    flops = (M - n_cold) * (iters + 2) * 8 * n * n \
        + n_cold * (15 * 4 * 2 * n ** 3 + 3 * 8 * n * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from scintools_tpu_torch import BasicDyn, Dynspec, _build
    from scintools_tpu_torch import workloads as W
    from scintools_tpu_torch.thth import eig as E

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[1] device {card} x{count}; nvidia-smi: {smi()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"    kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.sources())})", flush=True)

    # ---- [2] kernel vs plain on the card ------------------------------
    print("[2] eig_warmstart kernel vs plain", flush=True)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(E.pack_padded(drift_batch(rng), 256)).to(dev)
    compare("(a) drift", E.batched_eig_warmstart(a, 128),
            E.batched_eig_warmstart_plain(a, 128))
    a = torch.from_numpy(E.pack_padded(crossing_batch(), 256)).to(dev)
    compare("(b) crossing", E.batched_eig_warmstart(a, 128),
            E.batched_eig_warmstart_plain(a, 128), top2(a))

    nf = nt = 4096
    prob = W.make_north_star_problem(nf, nt, n_variants=2)
    eta_true = prob["eta_true"]
    run = W.make_north_star_pipeline(
        nf, nt, prob["cf"], prob["ct"], prob["npad"], prob["wins"],
        prob["tau"], prob["fd"], prob["edges"], GROUP, fw=0.2, device=dev)
    ev = run.eval_fn
    d0 = torch.as_tensor(prob["dyns"][0], dtype=torch.float32, device=dev)
    etas = torch.as_tensor(prob["etas"], dtype=torch.float64, device=dev)
    cf, ct, npad = prob["cf"], prob["ct"], prob["npad"]
    chunks = d0.reshape(nf // cf, cf, nt // ct, ct).transpose(1, 2) \
        .reshape(-1, cf, ct)[:GROUP]
    mu = chunks.mean(dim=(1, 2), keepdim=True)
    padded = torch.nn.functional.pad(chunks - mu, (0, npad * ct, 0,
                                                   npad * cf)) + mu
    CS = torch.fft.fftshift(torch.fft.fft2(padded), dim=(1, 2))
    a = ev.gather(torch.stack([CS.real, CS.imag], dim=1), etas)
    del CS, padded
    mid = ev.n_th // 2
    # warm-ups (the first call of each also loads or builds its code)
    E.batched_eig_warmstart(a[:1, :2].contiguous(), mid)
    E.batched_eig_warmstart_plain(a[:1, :2], mid)
    top2(a[:1, :2])
    kern, ms = timed(lambda: E.batched_eig_warmstart(a, mid), reps=3)
    stats = {}
    plain, plain_ms = timed(
        lambda: E.batched_eig_warmstart_plain(a, mid, stats=stats))
    lam12, library_ms = timed(lambda: top2(a))
    max_abs, max_rel, n_near = compare(
        f"(c) north-star θ-θ {GROUP} chunks x {N_ETA} eta", kern, plain,
        lam12)
    B, neta, _, n, _ = a.shape
    bound_ms, bound_by = eig_bound_ms(B * neta, n, stats["cold"])
    print(f"    shape {tuple(a.shape)}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, eigvalsh {library_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}; {stats['cold']} cold starts)",
          flush=True)
    del a, kern, plain, lam12

    print("[2] eigvec_warmstart kernel vs plain (iters 64)", flush=True)
    EV = E.batched_eigvec_warmstart
    a = torch.from_numpy(E.pack_padded(drift_batch(rng), 256)).to(dev)
    lk, vk = EV(a, 128, iters=64)
    lp, vp = E.batched_eigvec_warmstart_plain(a, 128, iters=64)
    compare("(a) drift, 4 chains of 24", lk, lp)
    compare_vec("(a) drift, 4 chains of 24", vk, vp)
    _, vec_ms = timed(lambda: EV(a, 128, iters=64), reps=3)
    stats = {}
    _, vec_plain_ms = timed(lambda: E.batched_eigvec_warmstart_plain(
        a, 128, iters=64, stats=stats))
    c = torch.complex(a[:, :, 0], a[:, :, 1])
    _, vec_eigh_ms = timed(lambda: torch.linalg.eigh(c))
    b_ms, b_by = eig_bound_ms(a.shape[0] * a.shape[1], 256, stats["cold"],
                              iters=64, out_floats=2 * 256 + 1)
    print(f"    shape {tuple(a.shape)}: kernel {vec_ms:.3f} ms, plain "
          f"{vec_plain_ms:.3f} ms, eigh {vec_eigh_ms:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by}; {stats['cold']} cold starts)", flush=True)
    a = torch.from_numpy(E.pack_padded(crossing_batch()[0], 256)).to(dev)
    lk, vk = EV(a, 128, iters=64)
    lp, vp = E.batched_eigvec_warmstart_plain(a, 128, iters=64)
    l1, l2 = top2(a[None])
    compare("(b) crossing, one chain of 24", lk[None], lp[None], (l1, l2))
    compare_vec("(b) crossing, one chain of 24", vk, vp,
                ((l1 - l2) >= 0.05 * l1.abs())[0])
    del a, c, lk, vk, lp, vp

    # ---- [3] north star, full size (main path) ------------------------
    print(f"[3] north star {nf}x{nt}, group {GROUP}", flush=True)
    e_np = prob["etas"]
    dyn1 = torch.as_tensor(prob["dyns"][1], dtype=torch.float32, device=dev)
    _, eigs0, peak0 = run(d0, e_np)                  # warm-up variant
    E.batched_eig_warmstart.launches = 0
    marks = Marks()
    _, eigs, peak = run(dyn1, e_np, mark=marks)
    stages = marks.totals()
    launches_ns = E.batched_eig_warmstart.launches
    print(f"    eig_warmstart launches in this run: {launches_ns}",
          flush=True)
    check(launches_ns > 0, "north star never launched eig_warmstart")
    ns_ms = sum(stages.values())
    peak = peak.cpu().numpy()
    print("    stages ms: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in stages.items())
          + f"; end to end {ns_ms:.3f} ms", flush=True)
    check(np.isfinite(peak[:, 0]).all(),
          f"{int((~np.isfinite(peak[:, 0])).sum())} non-finite chunk η")
    med = float(np.median(np.abs(peak[:, 0] - eta_true) / eta_true))
    print(f"    median |η-η_true|/η_true = {med:.4%} over {len(peak)} "
          "chunks", flush=True)
    check(med < 0.01, "north-star median η error ≥ 1%")
    run_plain = W.make_north_star_pipeline(
        nf, nt, cf, ct, npad, prob["wins"], prob["tau"], prob["fd"],
        prob["edges"], GROUP, fw=0.2, eig="plain", device=dev)
    peak_p = run_plain(dyn1, e_np)[2].cpu().numpy()
    d_eta = np.abs(peak[:4, 0] - peak_p[:4, 0]) / np.abs(peak_p[:4, 0])
    print(f"    kernel vs plain η, chunks 0-3: max rel {d_eta.max():.3e}",
          flush=True)
    check(bool((d_eta < 0.01).all()), "kernel vs plain η differs ≥ 1%")
    del eigs, eigs0, peak0, d0, dyn1

    # ---- [4] the façade (main path) -----------------------------------
    print("[4] Dynspec façade", flush=True)
    E.batched_eig_warmstart.launches = 0
    t0 = time.perf_counter()
    bd = BasicDyn(prob["dyns"][1], name="north_star",
                  freqs=prob["f0"] + prob["df"] * np.arange(nf),
                  times=prob["dt"] * np.arange(nt))
    ds = Dynspec(dyn=bd, process=False, verbose=False)
    ds.calc_sspec()
    ds.prep_thetatheta(cwf=512, cwt=512, npad=1, eta_min=0.5 * eta_true,
                       eta_max=2 * eta_true, neta=N_ETA, nedge=256,
                       edges_lim=prob["th_lim"])
    ds.fit_thetatheta()
    torch.cuda.synchronize()
    facade_s = time.perf_counter() - t0
    launches_f = E.batched_eig_warmstart.launches
    med_f = float(np.nanmedian(np.abs(ds.eta_evo - eta_true) / eta_true))
    print(f"    wall {facade_s:.3f} s; sspec {ds.sspec.shape}; median "
          f"eta_evo error {med_f:.4%}; ththeta {ds.ththeta:.6g} "
          f"(truth {eta_true}); eta_evo_ok nonzero "
          f"{int((ds.eta_evo_ok != 0).sum())}; eig_warmstart launches "
          f"{launches_f}", flush=True)
    check(launches_f > 0, "façade never launched eig_warmstart")
    check(np.isfinite(ds.sspec).any(), "sspec has no finite value")
    check(med_f < 0.01, "façade median eta_evo error ≥ 1%")
    check(bool((ds.eta_evo_ok == 0).all()), "façade chunks flagged")
    check(np.isfinite(ds.ththeta)
          and abs(ds.ththeta - eta_true) / eta_true < 0.05,
          "façade ththeta not within 5% of truth")

    ret = retrieval_phase(ds, dev)

    print(json.dumps({"kernels": [{
        "name": "eig_warmstart", "route": "cuda",
        "source": "scintools_tpu_torch/csrc/eig_warmstart.cu",
        "replaces": "scintools_tpu/thth/pallas_eig.py:217",
        "launches": launches_ns + launches_f,
        "launches_north_star": launches_ns, "launches_facade": launches_f,
        "max_abs_err": max_abs, "max_rel_err_vs_plain": max_rel,
        "near_degenerate_points": n_near,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "shape": [B, neta, 2, n, n]}, ret.pop("kernel")],
        "north_star_ms": ns_ms, "north_star_stage_ms": stages,
        "facade_s": facade_s, **ret}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": card,
                                             "count": count}}), flush=True)


def aligned_corr(a, b):
    """Per-chunk |⟨a, b⟩| / (‖a‖‖b‖) of complex ``[M, ...]`` tensors."""
    a, b = a.flatten(1).to(torch.complex128), b.flatten(1).to(torch.complex128)
    return ((torch.conj(a) * b).sum(-1).abs()
            / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-300))


def intensity_gap(a, b):
    """(rel L2, Pearson corr) of |a|² against |b|² (numpy, float64)."""
    Ia = np.abs(a).astype(float) ** 2
    Ib = np.abs(b).astype(float) ** 2
    return (float(np.linalg.norm(Ia - Ib) / np.linalg.norm(Ib)),
            float(np.corrcoef(Ia.ravel(), Ib.ravel())[0, 1]))


def retrieval_phase(ds, dev):
    """Phase 5 on the fitted façade ``ds``; returns the eigvec kernel's
    entry of the ``kernels`` line (key ``kernel``) and the retrieval
    numbers."""
    from scintools_tpu_torch.robust import guards
    from scintools_tpu_torch.thth import eig as E
    from scintools_tpu_torch.thth import retrieval as R

    EV = E.batched_eigvec_warmstart
    n_grid = ds.ncf_ret * ds.nct_ret
    print(f"[5] wavefield retrieval: {ds.ncf_ret}x{ds.nct_ret} chunks of "
          f"{ds.cwf}x{ds.cwt}, {len(ds.edges)} edges, npad {ds.npad}",
          flush=True)
    ds.retrieve_wavefield()                  # warm-up (FFT plans, caches)

    # 5.1 the kernel route (main path)
    EV.launches = 0
    marks = Marks()
    t0 = time.perf_counter()
    wf = ds.retrieve_wavefield(mark=marks)
    torch.cuda.synchronize()
    retrieval_s = time.perf_counter() - t0
    stages = marks.totals()
    launches = EV.launches
    print(f"    retrieve_wavefield wall {retrieval_s:.3f} s; stages ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; eigvec_warmstart launches {launches}", flush=True)
    check(launches > 0, "retrieve_wavefield never launched eigvec_warmstart")
    check(bool((ds.wavefield_ok == 0).all()),
          f"{int((ds.wavefield_ok != 0).sum())} retrieval chunks flagged")
    check(wf.shape == ds.dyn.shape, f"wavefield shape {wf.shape}")
    check(bool(np.isfinite(wf).all()) and bool(np.any(wf != 0)),
          "wavefield not finite, or all zero")

    # 5.2 the dense route and the plain route against the kernel route.
    # The chained warm start (the JAX package's 'pallas'/'warm' algorithm)
    # contracts a warm error by ((λ₂+1.05λ₁)/(2.05λ₁))^64 per chunk, so
    # where a chunk's θ-θ gap is a few percent it lags the dense
    # eigenvector, as the JAX kernel does (tests/test_torch_retrieval.py);
    # its wavefield is held to the dense one where the gap is ≥ 10%, and
    # to the plain version of the same algorithm everywhere.
    t0 = time.perf_counter()
    wf_dense = ds.calc_wavefield()
    calc_s = time.perf_counter() - t0
    rel, corr = intensity_gap(wf, wf_dense)
    print(f"    calc_wavefield (eigh + numpy mosaic) wall {calc_s:.3f} s; "
          f"kernel vs dense intensity: rel L2 {rel:.3e}, corr {corr:.9f}",
          flush=True)
    chunks, edges_rows, etas_rows = ds._retrieval_grid_inputs()
    nct = ds.nct_ret
    grid = (chunks.reshape(n_grid, ds.cwf, ds.cwt),
            np.repeat(edges_rows, nct, axis=0), np.repeat(etas_rows, nct),
            *ds._steps())
    kw = dict(npad=ds.npad, with_ok=True, device_out=True, device=dev)
    E_k, ok_k = R.grid_retrieval_batch(*grid, method="kernel", **kw)
    fn = R.make_chunk_retrieval_fn(ds.cwf, ds.cwt, *ds._steps(),
                                   len(ds.edges), npad=ds.npad, device=dev)
    group = R.hbm_group(n_grid)
    x = torch.as_tensor(grid[0], dtype=torch.float32, device=dev)
    e = torch.as_tensor(grid[1], dtype=torch.float64, device=dev)
    et = torch.as_tensor(grid[2], dtype=torch.float64, device=dev)
    thth = torch.cat([fn.front(x[s:s + group], e[s:s + group],
                               et[s:s + group], ds.thth_tau_mask)[0]
                      for s in range(0, n_grid, group)])
    del x
    ev = torch.linalg.eigvalsh(thth)
    l1, l2 = ev[:, -1], ev[:, -2]
    rgap = (l1 - l2) / l1.abs()
    gapped = rgap >= 0.05
    c_dense = aligned_corr(E_k, torch.as_tensor(ds.chunks.reshape(
        n_grid, ds.cwf, ds.cwt), device=dev))
    bands = []
    for lo, hi in ((0.10, float("inf")), (0.05, 0.10), (0.0, 0.05)):
        sel = (rgap >= lo) & (rgap < hi)
        low = c_dense[sel].min().item() if bool(sel.any()) else None
        bands.append((f"[{lo:.0%}, {hi:.0%})", int(sel.sum()), low))
    print("    per chunk, kernel vs dense, least aligned corr by θ-θ gap "
          "(λ₁−λ₂)/λ₁: " + "; ".join(f"{band} {cnt} chunks {low}"
                                    for band, cnt, low in bands),
          flush=True)
    check(bool((c_dense[rgap >= 0.10] > 0.99).all()),
          "a chunk with a 10% θ-θ gap decorrelates from eigh")
    E_p, ok_p = R.grid_retrieval_batch(*grid, method="plain", **kw)
    c_plain = aligned_corr(E_k, E_p)
    rel_p, corr_p = intensity_gap(
        wf, R.mosaic_device(E_p, grid_shape=(ds.ncf_ret, nct), device=dev))
    print(f"    kernel vs plain route: intensity rel L2 {rel_p:.3e}, corr "
          f"{corr_p:.9f}; per chunk least aligned corr "
          f"{c_plain[gapped].min().item():.9f} (gapped), "
          f"{c_plain.min().item():.9f} (all)", flush=True)
    check(torch.equal(ok_p, ok_k) and rel_p < 5e-3 and corr_p > 0.9999
          and bool((c_plain[gapped] > 0.999).all()),
          "plain-route wavefield disagrees with the kernel route")
    del E_p

    # 5.3 the eigenpair stage's times, and λ and v against plain
    a = fn.pack(thth, group)
    mid = fn.n_th // 2
    EV(a[:1, :2].contiguous(), mid, iters=64)               # warm-ups
    E.batched_eigvec_warmstart_plain(a[:1, :2], mid, iters=64)
    (lk, vk), ms = timed(lambda: EV(a, mid, iters=64), reps=3)
    stats = {}
    (lp, vp), plain_ms = timed(lambda: E.batched_eigvec_warmstart_plain(
        a, mid, iters=64, stats=stats))
    _, library_ms = timed(lambda: torch.linalg.eigh(thth))
    G, L, _, n, _ = a.shape
    lam12 = (l1.reshape(G, L), l2.reshape(G, L))
    max_abs, max_rel, n_near = compare(
        f"retrieval eig, {G} chains of {L}", lk, lp, lam12)
    low = compare_vec(f"retrieval eig, {G} chains of {L}", vk, vp,
                      gapped.reshape(G, L))
    bound_ms, bound_by = eig_bound_ms(G * L, n, stats["cold"], iters=64,
                                      out_floats=2 * n + 1)
    print(f"    eig stage {tuple(a.shape)}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, eigh ({n_grid}, {fn.n_th}, {fn.n_th}) "
          f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
          f"{stats['cold']} cold starts)", flush=True)
    del a, thth, lk, vk, lp, vp

    # 5.4 reproducibility and quarantine
    check(np.array_equal(ds.retrieve_wavefield(), wf),
          "a rerun of retrieve_wavefield changed the wavefield")
    poisoned = group + 3                         # chain 1, position 3
    bad = grid[0].copy()
    bad[poisoned, ds.cwf // 5, ds.cwt // 3] = np.nan
    E_b, ok_b = R.grid_retrieval_batch(bad, *grid[1:], method="kernel", **kw)
    mates = torch.zeros(n_grid, dtype=torch.bool, device=dev)
    mates[group:2 * group] = True
    mates[poisoned] = False
    others = torch.ones_like(mates)
    others[group:2 * group] = False
    c_mates = aligned_corr(E_b[mates], E_k[mates])
    print(f"    quarantine: ok {int(ok_b[poisoned])} at the poisoned chunk; "
          f"{int(others.sum())} chunks of other chains bitwise equal: "
          f"{torch.equal(E_b[others], E_k[others])}; chain-mates least "
          f"corr {c_mates.min().item():.9f}", flush=True)
    check(int(ok_b[poisoned]) == guards.BAD_INPUT
          and not bool(E_b[poisoned].any()),
          "the poisoned chunk is not zero with BAD_INPUT")
    check(torch.equal(E_b[others], E_k[others])
          and torch.equal(ok_b[others], ok_k[others]),
          "quarantine moved a chunk of another chain")
    check(bool((c_mates > 0.999).all()), "a chain-mate of the poisoned "
          "chunk decorrelated")
    del E_b, E_k

    # 5.5 Gerchberg–Saxton on the kernel-route wavefield
    ds.wavefield = wf
    t0 = time.perf_counter()
    gs = ds.gerchberg_saxton(niter=3)
    gs_s = time.perf_counter() - t0
    good = np.isfinite(ds.dyn) & (ds.dyn > 0)
    err = float(np.max(np.abs(np.abs(gs[good]) - np.sqrt(ds.dyn[good]))
                       / np.sqrt(ds.dyn[good])))
    print(f"    gerchberg_saxton(niter=3) wall {gs_s * 1e3:.3f} ms; "
          f"max rel | |E| - sqrt(dyn) | at good pixels {err:.3e}",
          flush=True)
    check(bool(np.isfinite(gs).all()) and err < 1e-5,
          "GS wavefield not finite, or |E| != sqrt(dyn) at good pixels")

    return {"kernel": {
        "name": "eigvec_warmstart", "route": "cuda",
        "source": "scintools_tpu_torch/csrc/eig_warmstart.cu",
        "replaces": "scintools_tpu/thth/pallas_eig.py:296",
        "launches": launches, "max_abs_err": max_abs,
        "max_rel_err_vs_plain": max_rel, "min_vec_corr_vs_plain": low,
        "near_degenerate_points": n_near, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "shape": [G, L, 2, n, n]},
        "retrieval_s": retrieval_s, "retrieval_stage_ms": stages,
        "calc_wavefield_s": calc_s, "gs_s": gs_s,
        "kernel_vs_dense_intensity": [rel, corr],
        "kernel_vs_plain_intensity": [rel_p, corr_p],
        "kernel_vs_dense_chunk_corr_by_gap": bands}


if __name__ == "__main__":
    main()
