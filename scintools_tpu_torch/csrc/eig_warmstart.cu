// Warm-started dominant eigenvalue (and eigenvector) of a batch of
// hermitian θ-θ matrices, walking each chain of matrices in order.
//
// Replaces three kernels of scintools_tpu/thth/pallas_eig.py:
//  - _make_warm_kernel (entry batched_eig_warmstart, :217), through
//    eig_warmstart_launch: a chain is one chunk's η axis; λ only;
//  - _make_warm_vec_kernel (entry batched_eigvec_warmstart, :296), through
//    eigvec_warmstart_launch: a chain is a run of retrieval chunks; λ and
//    the unit eigenvector v, which is the retrieved wavefield row;
//  - _make_kernel (entry batched_eig_pallas, :334), through
//    eig_cold_launch: the cold start alone, one matrix per CTA — the same
//    kernel on chains of length one, whose only step is cold().
// Both compute what those kernels compute — the cold two-phase squaring
// start (_eig_body) at a chain's first matrix and after every stale warm
// step, otherwise `iters` shifted power steps from the previous matrix's
// eigenvector (_warm_body) — but are not a block-by-block copy: on the
// TPU the chain is a sequential grid axis and the vector lives in VMEM
// scratch between grid steps; here blocks run in no order, so ONE CTA
// owns one chain and runs the loop itself, keeping the current
// eigenvector (2·N floats) in shared memory. Both entries run the same
// kernel; a non-null `vout` makes it write v after every step.
//
// Input  a    : (G, L, 2, N, N) float32, (re, im) planes, N % 128 == 0;
//               G chains of L matrices
// Output out  : (G, L) float32, the largest-algebraic eigenvalue λ
//               (the caller takes |λ|)
//        vout : (G, L, 2, N) float32, v as (re, im) rows, or null
// Scratch     : (G, 2, 2, N, N) float32 — two (re, im) ping-pong buffers
//               per chain for the cold start's squarings (allocated by the
//               caller; the kernel allocates nothing).
//
// What bounds it on an H100. Bytes read once: G·L·2·N²·4, plus
// G·L·(2N+1)·4 written for the eigenvector entry. Operations: ≈ (iters+2)
// complex N² mat-vecs (8N² flops each) per warm matrix, plus 15·4·2N³ per
// cold start and 3 mat-vecs. For one 32-chunk group of the north star's
// curvature search (200 η, N=256, iters 24) that is 3.4 GB (≈ 1 ms at
// 3.35 TB/s) against ≈ 0.09 TFLOP of warm steps plus ≈ 2 GFLOP per cold
// start (a few hundred of them on that data): operations bound it, at
// ≈ 10 ms at 67 TFLOP/s f32. For the wavefield retrieval of a 4096²
// spectrum (225 chunks in 9 chains of 25, N=256, iters 64) it is 0.12 GB
// (≈ 0.04 ms) against ≈ 7.5 GFLOP of warm steps plus ≈ 2 GFLOP per cold
// start (at least 9): operations again, ≈ 0.4 ms. This simple design is
// far from either bound:
//  - warm steps read A from global memory / L2 once per mat-vec (one warp
//    per row, lanes striding the row with float4 loads, warp-shuffle
//    reduction): at N=256 the complex matrix is 512 KiB, more than the
//    227 KB of shared memory a block can use, so it cannot stay resident
//    in one CTA. Splitting its rows over a 4-CTA cluster (DSMEM) or fusing
//    the θ-θ gather into the kernel is later work;
//  - the cold start's 15 complex squarings run as a tiled f32 GEMM
//    (64×128 output tile, 4×4 complex outputs per thread) inside the
//    block, through the global scratch buffers;
//  - one CTA per chain fills only G of the 132 SMs: 32 for a curvature-
//    search group of 32 chunks, and 9 for the retrieval of a 4096²
//    spectrum (225 chunks in 9 chains of 25). That is the first thing to
//    fix.
//
// The cold entry's work is the cold start alone: per matrix 2·N²·4 bytes
// against ≈ 15·4·2N³ + 3·8N² operations (2 GFLOP at N = 256), so
// operations bound it (256 matrices ≈ 8 ms at 67 TFLOP/s f32); one CTA per
// matrix fills the card once the batch passes 132, and each CTA's
// squarings run at what one SM's tiled GEMM gives.
//
// Reductions use a fixed-order tree (warp xor-butterfly, then warp 0
// over the per-warp partials) and no float atomics, so a rerun gives the
// same bits and one chain's result never depends on another's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileM = 64;    // GEMM output tile rows (16 thread rows × 4)
constexpr int kTileN = 128;   // GEMM output tile cols (32 thread cols × 4)
constexpr int kTileK = 16;
constexpr float kEps = 1e-30f;

// A matrix operand: element (i, j) reads as ((re + δij·shift) + i·im) / div
struct Src {
  const float* re;
  const float* im;
  float div;
  float shift;
};

struct Tiles {
  float ar[kTileK][kTileM];
  float ai[kTileK][kTileM];
  float br[kTileK][kTileN];
  float bi[kTileK][kTileN];
};

__device__ __forceinline__ void load(const Src& x, int n, int i, int j,
                                     float& vr, float& vi) {
  const size_t o = (size_t)i * n + j;
  vr = (x.re[o] + (i == j ? x.shift : 0.f)) / x.div;
  vi = x.im[o] / x.div;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fixed-order block sum; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[kWarps] = t;
  }
  __syncthreads();
  const float total = red[kWarps];
  __syncthreads();
  return total;
}

// y = X·x for shared-memory vectors x, y (complex, as re/im arrays).
__device__ void matvec(const Src& x, int n, const float* xr, const float* xi,
                       float* yr, float* yi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool raw = (x.div == 1.f && x.shift == 0.f);
  const int n4 = n >> 2;
  const float4* vr4 = reinterpret_cast<const float4*>(xr);
  const float4* vi4 = reinterpret_cast<const float4*>(xi);
  for (int i = warp; i < n; i += kWarps) {
    const float4* rr = reinterpret_cast<const float4*>(x.re + (size_t)i * n);
    const float4* ri = reinterpret_cast<const float4*>(x.im + (size_t)i * n);
    float sr = 0.f, si = 0.f;
    for (int j4 = lane; j4 < n4; j4 += 32) {
      float4 a = rr[j4], b = ri[j4];
      if (!raw) {
        const int j = 4 * j4;
        a.x = (a.x + (i == j ? x.shift : 0.f)) / x.div;
        a.y = (a.y + (i == j + 1 ? x.shift : 0.f)) / x.div;
        a.z = (a.z + (i == j + 2 ? x.shift : 0.f)) / x.div;
        a.w = (a.w + (i == j + 3 ? x.shift : 0.f)) / x.div;
        b.x /= x.div;
        b.y /= x.div;
        b.z /= x.div;
        b.w /= x.div;
      }
      const float4 u = vr4[j4], w = vi4[j4];
      sr += a.x * u.x - b.x * w.x + a.y * u.y - b.y * w.y
          + a.z * u.z - b.z * w.z + a.w * u.w - b.w * w.w;
      si += a.x * w.x + b.x * u.x + a.y * w.y + b.y * u.y
          + a.z * w.z + b.z * u.z + a.w * w.w + b.w * u.w;
    }
    sr = warp_sum(sr);
    si = warp_sum(si);
    if (lane == 0) {
      yr[i] = sr;
      yi[i] = si;
    }
  }
  __syncthreads();
}

// (yre, yim) = X·X, unnormalised; returns sqrt(Σ|Y|²) + ε, the Frobenius
// norm the next step divides by (pallas_eig.py:_eig_body sq_body).
__device__ float square(const Src& x, float* yre, float* yim, int n,
                        Tiles& t, float* red) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int tiles_n = n / kTileN, tiles = (n / kTileM) * tiles_n;
  float part = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int row0 = (tile / tiles_n) * kTileM;
    const int col0 = (tile % tiles_n) * kTileN;
    float cr[4][4], ci[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) cr[r][c] = ci[r][c] = 0.f;
    for (int k0 = 0; k0 < n; k0 += kTileK) {
      for (int s = tid; s < kTileM * kTileK; s += kThreads) {
        const int r = s / kTileK, kk = s % kTileK;
        load(x, n, row0 + r, k0 + kk, t.ar[kk][r], t.ai[kk][r]);
      }
      for (int s = tid; s < kTileK * kTileN; s += kThreads) {
        const int kk = s / kTileN, c = s % kTileN;
        load(x, n, k0 + kk, col0 + c, t.br[kk][c], t.bi[kk][c]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        const float4 a4r = *reinterpret_cast<const float4*>(&t.ar[kk][ty * 4]);
        const float4 a4i = *reinterpret_cast<const float4*>(&t.ai[kk][ty * 4]);
        const float4 b4r = *reinterpret_cast<const float4*>(&t.br[kk][tx * 4]);
        const float4 b4i = *reinterpret_cast<const float4*>(&t.bi[kk][tx * 4]);
        const float ar[4] = {a4r.x, a4r.y, a4r.z, a4r.w};
        const float ai[4] = {a4i.x, a4i.y, a4i.z, a4i.w};
        const float br[4] = {b4r.x, b4r.y, b4r.z, b4r.w};
        const float bi[4] = {b4i.x, b4i.y, b4i.z, b4i.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            cr[r][c] += ar[r] * br[c] - ai[r] * bi[c];
            ci[r][c] += ar[r] * bi[c] + ai[r] * br[c];
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const size_t o = (size_t)(row0 + ty * 4 + r) * n + col0 + tx * 4;
      *reinterpret_cast<float4*>(yre + o) =
          make_float4(cr[r][0], cr[r][1], cr[r][2], cr[r][3]);
      *reinterpret_cast<float4*>(yim + o) =
          make_float4(ci[r][0], ci[r][1], ci[r][2], ci[r][3]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part += cr[r][c] * cr[r][c] + ci[r][c] * ci[r][c];
    }
  }
  return sqrtf(block_sum(part, red)) + kEps;
}

// Shared-memory working vectors of one CTA (N floats each).
struct Vecs {
  float *vr, *vi, *wr, *wi, *ur, *ui;
};

// λ = Re(v†Av)/(v†v + ε) and the residual ‖Av − λv‖ at the current v.
__device__ void rayleigh(const Src& a, int n, const Vecs& s, float* red,
                         float& lam, float& res) {
  matvec(a, n, s.vr, s.vi, s.wr, s.wi);
  float num = 0.f, den = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    num += s.vr[i] * s.wr[i] + s.vi[i] * s.wi[i];
    den += s.vr[i] * s.vr[i] + s.vi[i] * s.vi[i];
  }
  num = block_sum(num, red);
  den = block_sum(den, red) + kEps;
  lam = num / den;
  float r2 = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float dr = s.wr[i] - lam * s.vr[i];
    const float di = s.wi[i] - lam * s.vi[i];
    r2 += dr * dr + di * di;
  }
  res = sqrtf(block_sum(r2, red));
}

// Cold two-phase squaring start (pallas_eig.py:_eig_body).
__device__ void cold(const Src& a, int n, int mid, int squarings,
                     float* const sre[2], float* const sim[2], const Vecs& s,
                     Tiles& t, float* red, float& lam, float& res) {
  // phase 0: ρ ≈ sqrt(Rayleigh of A²) from C = A², squared 4× more
  float nrm = square(a, sre[0], sim[0], n, t, red);
  int cur = 0;
  for (int q = 0; q < 4; ++q) {
    nrm = square(Src{sre[cur], sim[cur], nrm, 0.f}, sre[1 - cur],
                 sim[1 - cur], n, t, red);
    cur = 1 - cur;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s.vr[i] = sre[cur][(size_t)i * n + mid] / nrm;
    s.vi[i] = sim[cur][(size_t)i * n + mid] / nrm;
  }
  __syncthreads();
  matvec(a, n, s.vr, s.vi, s.wr, s.wi);          // u = A v
  float su = 0.f, sv = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    su += s.wr[i] * s.wr[i] + s.wi[i] * s.wi[i];
    sv += s.vr[i] * s.vr[i] + s.vi[i] * s.vi[i];
  }
  su = block_sum(su, red);
  sv = block_sum(sv, red);
  const float shift = 1.05f * sqrtf((su + kEps) / (sv + kEps));

  // phase 1: B = A + shift·I squared `squarings` times
  Src b{a.re, a.im, 1.f, shift};
  if (squarings > 0) {
    nrm = square(b, sre[0], sim[0], n, t, red);
    cur = 0;
    for (int q = 1; q < squarings; ++q) {
      nrm = square(Src{sre[cur], sim[cur], nrm, 0.f}, sre[1 - cur],
                   sim[1 - cur], n, t, red);
      cur = 1 - cur;
    }
    b = Src{sre[cur], sim[cur], nrm, 0.f};
  }
  // v = B^(2^k) u0 with u0 the column `mid` of A, normalised
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s.ur[i] = a.re[(size_t)i * n + mid];
    s.ui[i] = a.im[(size_t)i * n + mid];
  }
  __syncthreads();
  matvec(b, n, s.ur, s.ui, s.vr, s.vi);
  float sq = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads)
    sq += s.vr[i] * s.vr[i] + s.vi[i] * s.vi[i];
  const float vn = sqrtf(block_sum(sq, red)) + kEps;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s.vr[i] /= vn;
    s.vi[i] /= vn;
  }
  __syncthreads();
  rayleigh(a, n, s, red, lam, res);
}

// Shifted power steps from the previous η's vector (pallas_eig.py:_warm_body).
__device__ void warm(const Src& a, int n, int iters, const Vecs& s,
                     float* red, float& lam, float& res) {
  matvec(a, n, s.vr, s.vi, s.wr, s.wi);
  float num = 0.f, den = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    num += s.vr[i] * s.wr[i] + s.vi[i] * s.wi[i];
    den += s.vr[i] * s.vr[i] + s.vi[i] * s.vi[i];
  }
  num = block_sum(num, red);
  den = block_sum(den, red);
  const float shift = 1.05f * fabsf(num / (den + kEps));
  for (int it = 0; it < iters; ++it) {
    matvec(a, n, s.vr, s.vi, s.wr, s.wi);
    float sq = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s.wr[i] += shift * s.vr[i];
      s.wi[i] += shift * s.vi[i];
      sq += s.wr[i] * s.wr[i] + s.wi[i] * s.wi[i];
    }
    const float wn = sqrtf(block_sum(sq, red)) + kEps;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s.vr[i] = s.wr[i] / wn;
      s.vi[i] = s.wi[i] / wn;
    }
    __syncthreads();
  }
  rayleigh(a, n, s, red, lam, res);
}

__global__ void __launch_bounds__(kThreads)
eig_warmstart_kernel(const float* __restrict__ a, float* __restrict__ out,
                     float* __restrict__ vout, float* scratch, int len, int n,
                     int mid, int squarings, int iters) {
  extern __shared__ __align__(16) float vec[];
  __shared__ __align__(16) Tiles tiles;
  __shared__ float red[kWarps + 1];
  const Vecs s{vec, vec + n, vec + 2 * n, vec + 3 * n, vec + 4 * n,
               vec + 5 * n};
  const size_t nn = (size_t)n * n;
  const int b = blockIdx.x;
  float* base = scratch + (size_t)b * 4 * nn;
  float* const sre[2] = {base, base + 2 * nn};
  float* const sim[2] = {base + nn, base + 3 * nn};
  for (int k = 0; k < len; ++k) {
    const float* ar = a + ((size_t)b * len + k) * 2 * nn;
    const Src am{ar, ar + nn, 1.f, 0.f};
    float lam, res;
    if (k == 0) {
      cold(am, n, mid, squarings, sre, sim, s, tiles, red, lam, res);
    } else {
      warm(am, n, iters, s, red, lam, res);
      // stale warm vector: λ < 0 (locked onto a negative eigenvalue) or a
      // Rayleigh residual above 3%·|λ| (a dominant-eigenvector crossing)
      if (lam < 0.f || res > 0.03f * fabsf(lam) + kEps)
        cold(am, n, mid, squarings, sre, sim, s, tiles, red, lam, res);
    }
    if (threadIdx.x == 0) out[(size_t)b * len + k] = lam;
    if (vout != nullptr) {
      float* vo = vout + ((size_t)b * len + k) * 2 * n;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        vo[i] = s.vr[i];
        vo[n + i] = s.vi[i];
      }
    }
  }
}

int launch(const float* a, float* out, float* vout, float* scratch, int G,
           int len, int n, int mid, int squarings, int iters, void* stream) {
  const int smem = 6 * n * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      eig_warmstart_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  eig_warmstart_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      a, out, vout, scratch, len, n, mid, squarings, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// λ of B chunks' η chains of length neta, one CTA per chunk on `stream`;
// returns cudaGetLastError().
int eig_warmstart_launch(const float* a, float* out, float* scratch, int B,
                         int neta, int n, int mid, int squarings, int iters,
                         void* stream) {
  return launch(a, out, nullptr, scratch, B, neta, n, mid, squarings, iters,
                stream);
}

// λ and v of G chains of L retrieval matrices, one CTA per chain on
// `stream`; returns cudaGetLastError().
int eigvec_warmstart_launch(const float* a, float* lam_out, float* v_out,
                            float* scratch, int G, int L, int n, int mid,
                            int squarings, int iters, void* stream) {
  return launch(a, lam_out, v_out, scratch, G, L, n, mid, squarings, iters,
                stream);
}

// λ of B matrices by the cold start alone (chains of length one), one CTA
// per matrix on `stream`; returns cudaGetLastError().
int eig_cold_launch(const float* a, float* out, float* scratch, int B, int n,
                    int mid, int squarings, void* stream) {
  return launch(a, out, nullptr, scratch, B, 1, n, mid, squarings, 0,
                stream);
}

const char* eig_warmstart_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
