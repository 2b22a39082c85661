// Arc-normalised Doppler profile of a batch of masked secondary spectra.
//
// Replaces scintools_tpu/ops/arc_pallas.py:make_arc_profile_pallas_fn (the
// kernel at :75, pl.pallas_call at :117). For each epoch b and query q it
// computes the masked mean over delay rows r of the row's linear
// interpolation at the arc-scaled Doppler xq = fq[q]·scale[b, r]:
//
//   pos  = clip((xq − f0)/dfd, 0, nc − 1)
//   val  = Σ_k tent(pos − k)·s[b, r, k],  nanw = Σ_k tent(pos − k)·(1 − good)
//   ok   = (|xq| ≤ fmax) & (nanw ≤ 0)        (support on the UNclipped xq)
//   out  = Σ_r ok·val / Σ_r ok, or 0 where no row contributes
//
// with tent(u) = max(0, 1 − |u|). What it computes is the TPU kernel's
// function; how differs:
//  - the TPU kernel builds a dense (ncp, Qp) tent per row in VMEM and
//    contracts it on the MXU. Only two taps of each tent column are
//    non-zero, k0 = floor(pos) and k0 + 1 (when k0 + 1 ≤ nc − 1), so here
//    each thread computes those two weights directly, in f32, with the
//    tent formula: a zero weight is exactly zero, so a NaN bin with zero
//    weight does not poison its query and one with any positive weight
//    does (s is pre-masked to 0 at NaN; `good` carries the mask). A ±inf
//    pixel reaches only the queries whose taps touch it, where the dense
//    contraction spread 0·inf = NaN over the whole row; the device arc fit
//    quarantines such epochs anyway (ops/fitarc_device.py);
//  - the TPU carries num/den from row to row in VMEM scratch along a
//    sequential grid axis. Blocks here run in no order, so the row loop is
//    inside the block: one block per (tile of kThreads queries, epoch);
//    the block stages row r of s and of the bad mask in shared memory
//    (2·nc floats), every thread accumulates its query's num/den in
//    registers in row order, and writes once. No atomics: a rerun gives
//    the same bits and one epoch never depends on another. Every float
//    operation rounds once (the _rn intrinsics forbid FMA contraction),
//    in the order of the plain version's row loop, so the two agree to
//    the bit wherever the compilers round alike;
//  - no 128-padding of columns or queries, no 1e30 sentinel query and no
//    (8, Qp) broadcast of the output: the kernel masks its ragged edge.
//
// Inputs  s      : (B, R, nc) float32, the masked rows (0 where NaN)
//         good   : (B, R, nc) float32, 1 where the pixel is finite, else 0
//         scales : (B, R) float32, sqrt(tdel_r / η_b)
//         fq     : (Q,) float32, the normalised Doppler grid
// Output  out    : (B, Q) float32
// f0 = fdop[0], dfd = mean(diff(fdop)) and fmax = max|fdop| come from the
// caller, computed in f64 and rounded to f32 as the TPU bakes them.
//
// What bounds it on an H100. Bytes: s and good read once, 2·B·R·nc·4, plus
// scales, fq and the output; at the survey arc fit (B = 128 epochs,
// R = 252 rows, nc = 512, Q = 2000) that is 2 × 66 MB + 1 MB, ≈ 0.04 ms at
// 3.35 TB/s. Operations: ≈ 20 per (b, r, q), ≈ 1.3 GFLOP, ≈ 0.02 ms at
// 67 TFLOP/s f32: bytes bound it. The design reads each row into shared
// memory once per query tile (⌈Q/256⌉ = 8 tiles, the repeats served from
// the 50 MB L2, which holds an epoch's 1 MB many times over) and keeps
// the tent out of memory altogether; the TPU's dense tent made the work
// nc/2 times larger. One barrier pair per row and a gather from shared
// memory per tap are what it pays instead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // queries per block

__global__ void __launch_bounds__(kThreads)
arc_profile_kernel(const float* __restrict__ s, const float* __restrict__ good,
                   const float* __restrict__ scales,
                   const float* __restrict__ fq, float* __restrict__ out,
                   int R, int nc, int Q, float f0, float dfd, float fmax) {
  extern __shared__ __align__(16) float row[];
  float* srow = row;       // s[b, r, :]
  float* brow = row + nc;  // 1 − good[b, r, :]
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool live = q < Q;
  const float f = live ? fq[q] : 0.f;
  const float last = (float)(nc - 1);
  const size_t base = (size_t)b * R * nc;
  float num = 0.f, den = 0.f;
  for (int r = 0; r < R; ++r) {
    __syncthreads();  // every thread is done with the previous row
    const size_t o = base + (size_t)r * nc;
    for (int k = threadIdx.x; k < nc; k += kThreads) {
      srow[k] = s[o + k];
      brow[k] = 1.f - good[o + k];
    }
    __syncthreads();
    if (live) {
      // every operation rounds once, as the plain version's do (no FMA
      // contraction): the profile rests on a dB spectrum whose
      // neighbouring bins can differ by ~300 dB, so one rounding of pos
      // moves a value by 1e-3
      const float xq = __fmul_rn(f, scales[(size_t)b * R + r]);
      const float pos = fminf(fmaxf(__fdiv_rn(__fsub_rn(xq, f0), dfd), 0.f),
                              last);
      const float k0 = floorf(pos);
      const int i0 = (int)k0;
      const float w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, k0))));
      float val = __fmul_rn(w0, srow[i0]);
      float nanw = __fmul_rn(w0, brow[i0]);
      if (i0 + 1 <= nc - 1) {
        const float w1 = fmaxf(
            0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, __fadd_rn(k0, 1.f)))));
        val = __fadd_rn(val, __fmul_rn(w1, srow[i0 + 1]));
        nanw = __fadd_rn(nanw, __fmul_rn(w1, brow[i0 + 1]));
      }
      const float ok = (fabsf(xq) <= fmax && nanw <= 0.f) ? 1.f : 0.f;
      num = __fadd_rn(num, __fmul_rn(val, ok));
      den += ok;
    }
  }
  if (live) out[(size_t)b * Q + q] = den > 0.f ? __fdiv_rn(num, den) : 0.f;
}

}  // namespace

extern "C" {

// Profiles of B epochs on `stream`; returns cudaGetLastError() (or the
// error of raising the dynamic shared-memory limit).
int arc_profile_launch(const float* s, const float* good, const float* scales,
                       const float* fq, float* out, int B, int R, int nc,
                       int Q, float f0, float dfd, float fmax, void* stream) {
  const int smem = 2 * nc * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        arc_profile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Q + kThreads - 1) / kThreads, B);
  arc_profile_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      s, good, scales, fq, out, R, nc, Q, f0, dfd, fmax);
  return (int)cudaGetLastError();
}

const char* arc_profile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
