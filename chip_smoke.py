"""Drive the PyTorch/CUDA port of the θ-θ curvature search on one card.

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
   (a yardstick the port never calls) on the main path's shapes;
3. the north-star pipeline at 4096² (8×8 chunks of 512², 200 η,
   256 edges), timed end to end from the dynspec on the card, with
   the η gates against truth and against the plain eigensolver;
4. the ``Dynspec`` façade on the same dynspec:
   ``calc_sspec → prep_thetatheta → fit_thetatheta``.

Launch counts are taken per path: zeroed just before the timed
north-star run and read just after it, then zeroed again just before
the façade and read just after ``fit_thetatheta``; each must be > 0.
It prints a ``{"kernels": [...]}`` line (``launches`` is the sum of
the two, with each path's count beside it), the card's ``nvidia-smi``
name and power limit, and as its last line
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


def eig_bound_ms(B, neta, n, n_cold):
    """Least time for the eigensolver's work on this run's data: input
    read once + output written once over HBM bandwidth, against the
    warm mat-vecs (26 complex N² mat-vecs per warm η) plus the cold
    starts this data needed (15 complex N³ squarings each) over the f32
    CUDA-core peak."""
    nbytes = B * neta * 2 * n * n * 4 + B * neta * 4
    flops = (B * neta - n_cold) * 26 * 8 * n * n \
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
    bound_ms, bound_by = eig_bound_ms(B, neta, n, stats["cold"])
    print(f"    shape {tuple(a.shape)}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, eigvalsh {library_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}; {stats['cold']} cold starts)",
          flush=True)
    del a, kern, plain, lam12

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
        "shape": [B, neta, 2, n, n]}],
        "north_star_ms": ns_ms, "north_star_stage_ms": stages,
        "facade_s": facade_s}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": card,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
