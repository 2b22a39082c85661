"""What bounds one step of the eigensolver (``csrc/eig_warmstart.cu``),
which ``chip_smoke.py``, timing whole calls on the main path's data,
cannot separate. Two probes of the card: the rate of the tensor cores'
``mma.sync`` m16n8k8 TF32 (the cold start's squarings), and the latency
of one thread-block cluster barrier, bare and after every CTA stores
into its peers' shared memory (one warm step's exchange). And a sweep
of the eigensolver alone over its launch plans on synthetic chains (a
dominant rank-1 part plus a hermitian background drifting along the
chain, N = 256, one cold start per chain), which gives one warm step's
time and one cold start's at each cluster size: λ-only chains of 200 at
G = 8, 16, 30 and 32; the eigenvector entry at (9, 25) with 24 and 64
steps (the 9 chains run side by side, so their difference over a
chain's 40 × 25 extra steps is one warm step's time at C = 8); and the
cold-only entry on 1 to 256 matrices.

Run on a card, from the root of the repository (needs ``nvcc``)::

    python3 -m scintools_tpu_torch.microbench

It builds each program with ``nvcc`` into the git-ignored
``scintools_tpu_torch/_build/``, runs it, runs the sweep (CUDA events,
mean of 2 after a warm-up), and prints its lines and the card's
``nvidia-smi`` name and power limit. It exits non-zero when a build or
a run fails.
"""

from __future__ import annotations

import os
import subprocess
import sys

from . import _build

MMA = r"""
#include <cstdio>
#include <cstdint>
// 8 independent accumulators a warp, as the squaring's column tiles
__global__ void k(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b0 = 5, b1 = 6;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* o;
  cudaMalloc(&o, sms * 512 * 4);
  const int iters = 4096;
  for (int warps : {8, 16}) {
    k<<<sms, 32 * warps>>>(o, 16);
    cudaDeviceSynchronize();
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0);
    k<<<sms, 32 * warps>>>(o, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    const double mmas = (double)sms * warps * iters * 8;
    printf("mma.sync m16n8k8 tf32, %d SMs x %d warps: %.1f TFLOP/s, "
           "%.3f ns per mma per SM (%s)\n", sms, warps,
           mmas * 2048 / ms / 1e9, ms * 1e6 / (mmas / sms),
           cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
"""

BARRIER = r"""
#include <cstdio>
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
// 256 threads a CTA, as the eigensolver; with `push`, lane q < C of
// every warp stores one float into rank q's shared memory first
__global__ void k(float* out, int iters, int push) {
  __shared__ float buf[2048];
  cg::cluster_group cl = cg::this_cluster();
  const int c = cl.num_blocks();
  cl.sync();
  float acc = 0;
  for (int i = 0; i < iters; ++i) {
    if (push && (threadIdx.x & 31) < c)
      cl.map_shared_rank(buf, threadIdx.x & 31)
          [(threadIdx.x >> 5) * 16 + (i & 15)] = (float)i;
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    acc += buf[threadIdx.x & 255];
  }
  cl.sync();
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
int main() {
  float* o;
  cudaMalloc(&o, 16 * 256 * 4);
  const int iters = 20000;
  cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int c : {4, 8, 16})
    for (int push : {0, 1}) {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = c;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(c);
      cfg.blockDim = dim3(256);
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      cudaLaunchKernelEx(&cfg, k, o, 100, push);
      cudaDeviceSynchronize();
      cudaEvent_t e0, e1;
      cudaEventCreate(&e0);
      cudaEventCreate(&e1);
      cudaEventRecord(e0);
      cudaLaunchKernelEx(&cfg, k, o, iters, push);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      printf("cluster barrier, C = %d, %s: %.1f ns (%s)\n", c,
             push ? "after DSMEM stores" : "bare", ms * 1e6 / iters,
             cudaGetErrorString(cudaGetLastError()));
    }
  return 0;
}
"""


def _run(name, src):
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, f"microbench_{name}.cu")
    exe = cu[:-3]
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", exe, cu], check=True)
    return subprocess.run([exe], check=True, capture_output=True,
                          text=True).stdout


def _ms(fn, reps=2):
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def eig_sweep(seed=9):
    """Times of the eigensolver's entries over launch plans (module
    docstring); prints one line each with the plan."""
    import numpy as np
    import torch

    from .thth import eig as E

    n, rng = 256, np.random.default_rng(seed)
    a = rng.normal(size=(2, 32, n, n)) + 1j * rng.normal(size=(2, 32, n, n))
    h = (a + np.conj(np.swapaxes(a, -1, -2))) / 2 / np.sqrt(n)
    u = rng.normal(size=(32, n, 1)) + 1j * rng.normal(size=(32, n, 1))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    base = h[0] + 3.0 * u @ np.conj(np.swapaxes(u, -1, -2))
    two = np.stack([base, base + 0.01 * h[1]], axis=1)
    d2 = torch.from_numpy(E.pack_padded(two, n)).cuda()
    steps = torch.arange(200, device="cuda", dtype=torch.float32)
    chains = (d2[:, :1] + steps[None, :, None, None, None]
              * (d2[:, 1] - d2[:, 0])[:, None]).contiguous()

    def plan(fn, x):
        stats = {}
        fn(x, n // 2, stats=stats)
        return " + ".join(f"{p['chains']} at C={p['cluster']}"
                          for p in stats["plan"])

    for G in (8, 16, 30, 32):
        sub = chains[:G].contiguous()
        t = _ms(lambda: E.batched_eig_warmstart(sub, n // 2))
        print(f"eig_warmstart ({G}, 200, 2, {n}, {n}), "
              f"{plan(E.batched_eig_warmstart, sub)}: {t:.3f} ms")
    sub = chains[:9, :25].contiguous()
    t24, t64 = (_ms(lambda: E.batched_eigvec_warmstart(sub, n // 2, iters=i))
                for i in (24, 64))
    print(f"eigvec_warmstart (9, 25, 2, {n}, {n}), "
          f"{plan(E.batched_eigvec_warmstart, sub)}: iters 24 "
          f"{t24:.3f} ms, iters 64 {t64:.3f} ms; one warm step "
          f"{(t64 - t24) / (40 * 25) * 1e3:.3f} µs")
    flat = chains[:, ::25].reshape(-1, 2, n, n)
    for B in (1, 8, 16, 30, 256):
        sub = flat[:B].contiguous()
        t = _ms(lambda: E.batched_eig_cold(sub, n // 2))
        print(f"eig_cold ({B}, 2, {n}, {n}), "
              f"{plan(E.batched_eig_cold, sub)}: {t:.3f} ms, "
              f"{t / -(-B // min(B, 30)):.3f} ms per wave of cold starts")


def main():
    for name, src in (("mma", MMA), ("barrier", BARRIER)):
        sys.stdout.write(_run(name, src))
    eig_sweep()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
