// Arc-normalised Doppler profile of a batch of secondary spectra, read in
// place: the delay crop, the NaN mask and the central cut happen here.
//
// Replaces scintools_tpu/ops/arc_pallas.py:make_arc_profile_pallas_fn (the
// kernel at :75, pl.pallas_call at :117) together with the preparation
// around it in the JAX program (scintools_tpu/ops/normsspec.py:269-281:
// crop, cut, isnan, where, the float `good` plane). For each epoch b and
// query q it computes the masked mean over the delay rows r = startbin …
// startbin + R − 1 of the row's linear interpolation at the arc-scaled
// Doppler xq = fq[q]·scale[b, r]:
//
//   pos  = clip((xq − f0)/dfd, 0, nc − 1)
//   bad  = isnan(s) or c0 ≤ column < c1          (the central cut)
//   val  = Σ_k tent(pos − k)·(bad ? 0 : s[b, r, k]),
//   ok   = (|xq| ≤ fmax) and no bad tap has positive weight
//          (support on the UNclipped xq)
//   out  = Σ_r ok·val / Σ_r ok, or 0 where no row contributes
//
// with tent(u) = max(0, 1 − |u|): two taps, k0 = floor(pos) and
// min(k0 + 1, nc − 1), the second with weight 0 past the last column.
// Every float operation rounds once (the _rn intrinsics forbid FMA
// contraction) in the order of the plain version (ops/arc_profile.py:
// arc_profile_plain after the crop and mask of arc_profile_rows_plain),
// and each query's num/den is summed by one thread in row order, so the
// two agree to the bit and no launch plan moves a bit.
//
// What bounds it on an H100. Bytes: the cropped rows read once,
// B·R·nc·4, plus scales, fq and the output; at the survey arc fit
// (B = 128, R = 252, nc = 512, Q = 2000) 66.1 MB of rows, 67.2 MB in
// all, ≈ 0.020 ms at 3.35 TB/s. Operations: ≈ 20 per (b, r, q), 1.29 GFLOP, ≈ 0.019 ms at
// 67 TFLOP/s f32. Bytes bound it, just.
//
// The design:
//  - one work unit per epoch covers all Q queries, so each row crosses
//    from HBM once: a thread-block cluster of C CTAs (C ∈ {1, 2, 4, 8},
//    the plan of ops/arc_profile.py:_plan) splits the queries; each
//    consumer thread holds kQpt queries' num/den in registers;
//  - rows stream through a ring of S shared-memory stages of k rows each.
//    One producer lane issues one cp.async.bulk of k·nc·4 contiguous bytes
//    per stage (the epoch's cropped rows are contiguous), against full/
//    empty mbarriers; with C > 1 the copy is multicast to every CTA of the
//    cluster (.multicast::cluster), so the cluster reads a row once. The
//    consumer warps wait on the stage's full barrier and release it on
//    the empty barrier of the CTA that issues the copies: no
//    __syncthreads per row;
//  - where a bulk copy cannot be used (nc·4 or the base or the epoch
//    stride not 16-byte aligned) the producer warp fills the same ring
//    with ordinary loads, each lane arriving on the full barrier: the
//    consumers run the same code;
//  - a query outside a row's support (|xq| > fmax) adds val·0 to num and
//    0 to den: with val finite that leaves both bits unchanged, so a
//    query outside the support of every row of a stage skips the stage.
//    Its position is clipped into the edge taps {0, 1} or {nc − 2,
//    nc − 1} (the host checks that for this f0, dfd, fmax), so val is
//    finite when those values are at most 1e37 in magnitude (NaN and cut
//    are masked to 0): one warp vote over the stage's edge values allows
//    the skip, and a stage with a larger or infinite edge value computes
//    every query in full. In the survey fit 80% of (r, q) lie outside;
//  - a query that does not skip computes the stage's k ≤ 8 rows as
//    independent, branch-free chains (the divisions first), then adds
//    them in row order: the latency of one row's chain (a division, a
//    floor, two shared-memory taps) is paid once a stage, not once a
//    row.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kQpt = 4;          // query slots per consumer thread
constexpr int kMaxWarps = 16;    // consumer warps per CTA
constexpr int kMaxRows = 8;      // rows per stage (one bulk copy) at most
constexpr int kMaxCluster = 8;   // portable cluster sizes only
static_assert(kMaxRows <= 8, "one warp vote covers 8 rows' edge values");

struct Args {
  const float* s;       // spectra (B, ntdel, nc), rows contiguous
  const float* scales;  // (B, R)
  const float* fq;      // (Q,)
  float* out;           // (B, Q)
  long long stride;     // epoch stride of s, in floats
  int R, nc, Q, startbin, c0, c1;
  float f0, dfd, fmax;
  int passes, warps, k, stages;
  int bulk;  // rows arrive by cp.async.bulk (else ordinary loads)
  int skip;  // out-of-support queries may be skipped (edge taps only)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Wait until the phase of parity `parity` of a barrier of this CTA has
// completed; acquire at CTA scope (full barriers: local arrivals and
// bulk-copy bytes) or at cluster scope (empty barriers peers arrive on).
template <bool kCluster>
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    if constexpr (kCluster) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(a), "r"(parity) : "memory");
    } else {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(a), "r"(parity) : "memory");
    }
  } while (!done);
}

__device__ __forceinline__ void arrive_local(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Arrive on the barrier at the same offset in CTA `rank` of the cluster.
__device__ __forceinline__ void arrive_remote(uint64_t* bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(remote) : "memory");
}

// This CTA's arrival on a full barrier, expecting `bytes` from the copy.
__device__ __forceinline__ void arm(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// One bulk copy of `bytes` into dst, completing on bar; with c > 1 into
// the same offsets of every CTA of the cluster.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar,
                                          int c) {
  if (c == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  } else {
    const uint16_t mask = (uint16_t)((1u << c) - 1u);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
           "h"(mask) : "memory");
  }
}

// A tap value that keeps two-tap sums finite: NaN (masked to 0) or at
// most 1e37 in magnitude (the weights are at most 1).
__device__ __forceinline__ bool tame(float v) { return !(fabsf(v) > 1e37f); }

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Dynamic shared memory: 2·S mbarriers (full, then empty), then the ring
// of S stages of k rows, 128-byte aligned.
__host__ __device__ inline size_t ring_offset(int stages) {
  return ((size_t)16 * stages + 127) / 128 * 128;
}

__host__ __device__ inline size_t smem_layout(int nc, int k, int stages) {
  return ring_offset(stages) + (size_t)stages * k * nc * sizeof(float);
}

// The producer warp: fills stage t % S with rows t·k … of the epoch.
__device__ __forceinline__ void produce(const Args& a, uint64_t* full,
                                        uint64_t* empty, float* ring,
                                        const float* src, int c, int rank) {
  const int lane = threadIdx.x & 31;
  const int n_tiles = (a.R + a.k - 1) / a.k;
  const size_t stage_floats = (size_t)a.k * a.nc;
  if (a.bulk) {
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % a.stages, round = t / a.stages;
        const int rows = min(a.k, a.R - t * a.k);
        const uint32_t bytes = (uint32_t)rows * a.nc * sizeof(float);
        // this stage's previous round has landed here, so its phase is
        // over and this CTA may arm the next one
        if (round > 0) bar_wait<false>(&full[st], (round - 1) & 1);
        arm(&full[st], bytes);
        if (rank == 0) {
          // every consumer warp of the cluster is done with the stage
          if (round > 0) bar_wait<true>(&empty[st], (round - 1) & 1);
          bulk_copy(ring + st * stage_floats,
                    src + (size_t)t * a.k * a.nc, bytes, &full[st], c);
        }
      }
    }
    __syncwarp();
    return;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % a.stages, round = t / a.stages;
    const int n = min(a.k, a.R - t * a.k) * a.nc;
    if (round > 0) bar_wait<false>(&empty[st], (round - 1) & 1);
    float* dst = ring + st * stage_floats;
    const float* from = src + (size_t)t * a.k * a.nc;
    for (int i = lane; i < n; i += 32) dst[i] = from[i];
    arrive_local(&full[st]);  // one arrival per lane, after its stores
  }
}

__global__ void __launch_bounds__(32 * (kMaxWarps + 1), 1)
arc_profile_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + a.stages;
  float* ring = reinterpret_cast<float*>(smem + ring_offset(a.stages));
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  // consumers release a multicast stage at the CTA that issues the copies
  const bool multicast = a.bulk && c > 1;
  const int b = blockIdx.y;
  const float* src = a.s + (size_t)b * a.stride + (size_t)a.startbin * a.nc;
  if (threadIdx.x == 0) {
    for (int st = 0; st < a.stages; ++st) {
      bar_init(&full[st], a.bulk ? 1 : 32);
      bar_init(&empty[st], multicast ? c * a.warps : a.warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA's barriers exist before any peer arrives on them or any
  // multicast signals them
  if (c > 1) cluster_sync(); else __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp == a.warps) {
    produce(a, full, empty, ring, src, c, rank);
  } else {
    const int lane = threadIdx.x & 31;
    const int threads = 32 * a.warps;
    const int per_cta = (a.Q + c * a.passes - 1) / (c * a.passes);
    const int q_lo = ((int)blockIdx.z * c + rank) * per_cta;
    const int q_hi = min(a.Q, q_lo + per_cta);
    const float last = (float)(a.nc - 1);
    const unsigned cut_w = (unsigned)(a.c1 - a.c0);
    float f[kQpt], num[kQpt], den[kQpt];
    bool live[kQpt];
#pragma unroll
    for (int j = 0; j < kQpt; ++j) {
      const int q = q_lo + (int)threadIdx.x + j * threads;
      live[j] = q < q_hi;
      f[j] = live[j] ? a.fq[q] : 0.f;
      num[j] = 0.f;
      den[j] = 0.f;
    }
    const float* sc_row = a.scales + (size_t)b * a.R;
    const int n_tiles = (a.R + a.k - 1) / a.k;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % a.stages;
      bar_wait<false>(&full[st], (t / a.stages) & 1);
      const float* tile = ring + (size_t)st * a.k * a.nc;
      const int rows = min(a.k, a.R - t * a.k);
      // Slots past the stage's last row repeat it (branch-free chains) and
      // are not summed. A query outside the support of every row of the
      // stage reads only edge taps there: it is skipped when they keep its
      // val finite (it then adds exactly nothing), which one warp vote
      // over the stage's edge values decides. |RN(f·s)| grows with |s|, so
      // the stage's least |scale| tells whether any row holds the query.
      float sc[kMaxRows];
      float sc_min = INFINITY;
      bool sc_nan = false;
#pragma unroll
      for (int rr = 0; rr < kMaxRows; ++rr) {
        sc[rr] = __ldg(sc_row + t * a.k + min(rr, rows - 1));
        sc_min = fminf(sc_min, fabsf(sc[rr]));
        sc_nan = sc_nan || isnan(sc[rr]);
      }
      const int e = lane & 3, edge_col = e < 2 ? e : a.nc - 4 + e;
      const bool skip =
          a.skip && !sc_nan &&
          __all_sync(0xffffffffu,
                     tame(tile[(size_t)min(lane >> 2, rows - 1) * a.nc +
                               edge_col]));
#pragma unroll
      for (int j = 0; j < kQpt; ++j) {
        if (!live[j]) continue;
        if (skip && fabsf(__fmul_rn(f[j], sc_min)) > a.fmax) continue;
        // every operation rounds once, as the plain version's do (no FMA
        // contraction): neighbouring dB bins can differ by ~300 dB, so
        // one rounding of pos moves a value by 1e-3
        float xq[kMaxRows];
#pragma unroll
        for (int rr = 0; rr < kMaxRows; ++rr) xq[rr] = __fmul_rn(f[j], sc[rr]);
        // the stage's rows as independent chains, then summed in row
        // order; the divisions first, each behind its own slow-path branch
        float quo[kMaxRows], val[kMaxRows], ok[kMaxRows];
#pragma unroll
        for (int rr = 0; rr < kMaxRows; ++rr)
          quo[rr] = __fdiv_rn(__fsub_rn(xq[rr], a.f0), a.dfd);
#pragma unroll
        for (int rr = 0; rr < kMaxRows; ++rr) {
          const float* row = tile + (size_t)min(rr, rows - 1) * a.nc;
          const float pos = fminf(fmaxf(quo[rr], 0.f), last);
          const float k0 = floorf(pos);
          const float k1 = __fadd_rn(k0, 1.f);
          const int i0 = (int)k0;
          const int i1 = min(i0 + 1, a.nc - 1);
          const float w0 =
              fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, k0))));
          const float w1 =
              k1 <= last
                  ? fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, k1))))
                  : 0.f;
          const float v0 = row[i0], v1 = row[i1];
          const bool b0 = isnan(v0) || (unsigned)(i0 - a.c0) < cut_w;
          const bool b1 = isnan(v1) || (unsigned)(i1 - a.c0) < cut_w;
          val[rr] = __fadd_rn(__fmul_rn(w0, b0 ? 0.f : v0),
                              __fmul_rn(w1, b1 ? 0.f : v1));
          // the plain version's Σ w·bad ≤ 0, with w ≥ 0 and bad ∈ {0, 1}
          const bool poisoned = (b0 && w0 > 0.f) || (b1 && w1 > 0.f);
          ok[rr] = fabsf(xq[rr]) <= a.fmax && !poisoned ? 1.f : 0.f;
        }
#pragma unroll
        for (int rr = 0; rr < kMaxRows; ++rr) {
          const bool in = rr < rows;
          const float sum = __fadd_rn(num[j], __fmul_rn(val[rr], ok[rr]));
          num[j] = in ? sum : num[j];
          den[j] = in ? __fadd_rn(den[j], ok[rr]) : den[j];
        }
      }
      __syncwarp();
      if (lane == 0) {
        if (multicast)
          arrive_remote(&empty[st], 0);
        else
          arrive_local(&empty[st]);
      }
    }
    float* out_row = a.out + (size_t)b * a.Q;
#pragma unroll
    for (int j = 0; j < kQpt; ++j) {
      if (live[j])
        out_row[q_lo + threadIdx.x + j * threads] =
            den[j] > 0.f ? __fdiv_rn(num[j], den[j]) : 0.f;
    }
  }
  // no CTA leaves while a peer may still arrive on its barriers
  if (c > 1) cluster_sync();
}

// May the kernel skip queries outside the support? Only if every such
// query's clipped position lands in the edge taps {0, 1} or
// {nc − 2, nc − 1}. pos(xq) is monotone in xq, so the extremes are the
// floats just outside ±fmax, computed as the kernel computes them.
int skip_allowed(int nc, float f0, float dfd, float fmax) {
  if (nc < 2 || !std::isfinite(f0) || !std::isfinite(dfd) ||
      !std::isfinite(fmax) || dfd == 0.f)
    return 0;
  const float last = (float)(nc - 1);
  const float hi = std::nextafter(fmax, INFINITY);
  auto pos = [&](float xq) {
    return std::fmin(std::fmax((xq - f0) / dfd, 0.f), last);
  };
  const float pa = pos(hi), pb = pos(-hi);
  const float right = dfd > 0.f ? pa : pb, left = dfd > 0.f ? pb : pa;
  return right >= (float)(nc - 2) && left < 1.f;
}

cudaError_t prepare(int smem) {
  return cudaFuncSetAttribute(arc_profile_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" {

// Profiles of B epochs of `s` (B, ntdel, nc) float32, rows contiguous,
// epoch stride `stride` floats: rows startbin … startbin + R − 1, cut
// columns [c0, c1), scales (B, R), fq (Q,), into out (B, Q). One cluster
// of c CTAs (cluster size 1: a plain launch) per (epoch, query pass),
// `warps` consumer warps each, a ring of `stages` stages of `k` rows
// (smem: arc_profile_smem_bytes). bulk: rows by cp.async.bulk, which
// needs s and the stride 16-byte aligned and nc % 4 == 0. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the kernel
// does not take).
int arc_profile_launch(const float* s, const float* scales, const float* fq,
                       float* out, int B, int R, int nc, int Q,
                       long long stride, int startbin, int c0, int c1,
                       float f0, float dfd, float fmax, int c, int passes,
                       int warps, int k, int stages, int smem, int bulk,
                       void* stream) {
  const bool aligned = nc % 4 == 0 && stride % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(s) % 16 == 0;
  if (B < 1 || B > 65535 || R < 0 || nc < 1 || Q < 1 || startbin < 0 ||
      c0 < 0 || c1 < c0 || c1 > nc || (c != 1 && c != 2 && c != 4 &&
      c != kMaxCluster) || passes < 1 || passes > 65535 || warps < 1 ||
      warps > kMaxWarps || k < 1 || k > kMaxRows || stages < 1 ||
      (size_t)smem != smem_layout(nc, k, stages) ||
      (long long)warps * 32 * kQpt * c * passes < Q || (bulk && !aligned))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return (int)err;
  Args a{s, scales, fq, out, stride, R, nc, Q, startbin, c0, c1, f0, dfd,
         fmax, passes, warps, k, stages, bulk, skip_allowed(nc, f0, dfd,
                                                            fmax)};
  const dim3 grid(c, B, passes), block(32 * (warps + 1));
  if (c == 1) {
    arc_profile_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(a);
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, arc_profile_kernel, a);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Work units of c CTAs (warps consumer warps, smem bytes each) that the
// card keeps resident at once, into *count: clusters by
// cudaOccupancyMaxActiveClusters, single CTAs (c = 1) by blocks per SM
// times the SMs.
int arc_profile_max_active(int c, int warps, int smem, int* count) {
  cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * (warps + 1);
  if (c == 1) {
    int dev = 0, per_sm = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, arc_profile_kernel, threads, smem);
    *count = per_sm * sms;
    return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(count, arc_profile_kernel, &cfg);
}

// The dynamic shared memory bytes the kernel lays out for a ring of
// `stages` stages of k rows of nc floats, into *bytes, or 0 where the
// current card cannot give a block that much.
int arc_profile_smem_bytes(int nc, int k, int stages, int* bytes) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t need = smem_layout(nc, k, stages);
  *bytes = need <= (size_t)most ? (int)need : 0;
  return 0;
}

// Query slots per consumer thread, consumer warps per CTA and rows per
// stage at most.
int arc_profile_limits(int* qpt, int* max_warps, int* max_rows) {
  *qpt = kQpt;
  *max_warps = kMaxWarps;
  *max_rows = kMaxRows;
  return 0;
}

// Whether the kernel skips queries outside a row's support for this
// Doppler grid (see skip_allowed), into *allowed.
int arc_profile_skip(int nc, float f0, float dfd, float fmax, int* allowed) {
  *allowed = skip_allowed(nc, f0, dfd, fmax);
  return 0;
}

const char* arc_profile_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
