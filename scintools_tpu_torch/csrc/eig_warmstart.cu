// Warm-started dominant eigenvalue (and eigenvector) of a batch of
// hermitian θ-θ matrices, walking each chain of matrices in order, one
// thread-block cluster per chain.
//
// Replaces three kernels of scintools_tpu/thth/pallas_eig.py:
//  - _make_warm_kernel (entry batched_eig_warmstart, :217), through
//    eig_warmstart_launch: a chain is one chunk's η axis; λ only;
//  - _make_warm_vec_kernel (entry batched_eigvec_warmstart, :296), through
//    eigvec_warmstart_launch: a chain is a run of retrieval chunks; λ and
//    the unit eigenvector v, which is the retrieved wavefield row;
//  - _make_kernel (entry batched_eig_pallas, :334), through
//    eig_cold_launch: the cold start alone — the same kernel on chains of
//    length one, whose only step is cold().
// All compute what those kernels compute — the cold two-phase squaring
// start (_eig_body) at a chain's first matrix and after every stale warm
// step, otherwise `iters` shifted power steps from the previous matrix's
// eigenvector (_warm_body) — but are not a block-by-block copy: on the
// TPU the chain is a sequential grid axis and the vector lives in VMEM
// scratch between grid steps; here a cluster of C CTAs (C ∈ {4, 8, 16},
// chosen by thth/eig.py:_cluster_plan) owns one chain and runs the loop
// itself. Rank r owns rows [r·N/C, (r+1)·N/C) of every matrix.
//
// Input  a    : (G, L, 2, N, N) float32, (re, im) planes, N % 128 == 0;
//               G chains of L matrices
// Output out  : (G, L) float32, the largest-algebraic eigenvalue λ
//               (the caller takes |λ|)
//        vout : (G, L, 2, N) float32, v as (re, im) rows, or null
//        colds: (G,) int32, cold starts per chain, or null
// Scratch     : (G, 2, 2, N, N) float32 — two (re, im) ping-pong buffers
//               per chain for the cold start's squarings (allocated by the
//               caller; the kernel allocates nothing).
//
// What bounds it on an H100. Bytes read once: G·L·2·N²·4 (3.4 GB for a
// 32-chunk north-star group of 200 η at N = 256, ≈ 1 ms at 3.35 TB/s).
// Operations: (iters+2) complex N² mat-vecs per warm matrix (8N² flops
// each) and per cold start 15 hermitian squarings (4N³ each, a herk) plus
// 3 mat-vecs: the operations bound it, ≈ 5.4 ms for that group at the
// f32 CUDA-core peak. But a chain is sequential: its 200 × 26 mat-vecs
// are each a dependent step of a few µs, so what sets the time is the
// latency of one step and of one cold start, times the steps of the
// chain with the most cold starts. What the design does about it:
//  - a cluster of C CTAs per chain (C ∈ {4, 8, 16}, the plan of
//    thth/eig.py:_cluster_plan): C = 4 puts 30 chains on 120 SMs (the
//    card seats 30 such clusters), C = 8 a façade row of 8 on 64;
//  - warm steps: each CTA copies its band of A (R = N/C rows, both planes;
//    128 KiB at N = 256, C = 4) from HBM into shared memory once per matrix
//    (cp.async.bulk against an mbarrier; when two bands fit, the next
//    matrix's band streams in while this one iterates), so every mat-vec
//    of that matrix reads shared memory, not L2. Each CTA computes its R
//    entries of y = A·v and stores them into every CTA's shared memory
//    (DSMEM); after one cluster barrier each CTA holds the whole vector
//    and computes the norm, the shift or the Rayleigh quotient itself:
//    one barrier per mat-vec. Where no C holds the band (N ≥ 640 here),
//    the same kernel reads the band from L2;
//  - cold starts: X·X of a hermitian X is hermitian, so only the 64×64
//    output tiles on and above the diagonal are computed (10 of 16 at
//    N = 256), dealt out over the cluster's CTAs, each off-diagonal tile
//    also written, conjugated, to its mirror. They run on the tensor cores
//    (mma.sync m16n8k8) as split TF32 — x = hi + lo, hi·hi + hi·lo + lo·hi
//    accumulated in f32, which keeps f32 accuracy where plain TF32 keeps
//    about three digits — from two shared-memory stages, through the
//    chain's global scratch (L2-resident, 2 × 512 KiB at N = 256), ordered
//    between squarings by the cluster barrier's release/acquire.
//
// Determinism. The arithmetic order depends on N alone, never on C or G:
// a row's dot product is one warp's, lanes striding the row in order,
// then an xor butterfly; a sum over the vector is lane-strided in order,
// then an xor butterfly, computed alike by every warp of every CTA from
// the same pushed vector; a squaring's norm adds its tiles' sums (each in
// a fixed order) lane-strided over the tiles, then a butterfly. So every
// CTA of a cluster takes the same stale/cold branch (a CTA that branched
// alone would deadlock at the next cluster barrier), a chain's bits do
// not depend on the launch plan or on the other chains, and a rerun gives
// the same bits. No float atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // squaring output tile (complex)
constexpr int kTileK = 16;                 // squaring depth per stage
constexpr int kStride = kTileK + 4;        // stage row stride (floats)
constexpr int kPlane = kTile * kStride;    // one 64 × 16 operand plane
constexpr int kStage = 8 * kPlane;         // A, B × (re, im) × (hi, lo)
constexpr int kSqFloats = 2 * kStage;      // two stage buffers
constexpr int kMaxCluster = 16;
constexpr float kEps = 1e-30f;

// Dynamic shared memory of one CTA, in floats (thth/eig.py:_cluster_plan
// asks for its size through eig_smem_bytes): two mbarriers, nbuf bands
// of R rows × N × (re, im), the squaring stage, four whole vectors, two
// mailbox slots (a whole vector,
// re then im, then the partials of the squaring's p upper-triangle
// tiles), 32 floats of reduction space.
struct Layout {
  int r, p, ms;
  size_t band, sq, vec, mail, red, bytes;
};

__host__ __device__ inline Layout layout(int n, int c, int nbuf) {
  Layout l;
  l.r = n / c;
  l.p = (n / kTile) * (n / kTile + 1) / 2;
  l.ms = (2 * n + l.p + 3) / 4 * 4;
  l.band = 4;
  l.sq = l.band + (size_t)nbuf * 2 * l.r * n;
  l.vec = l.sq + kSqFloats;
  l.mail = l.vec + 4 * (size_t)n;
  l.red = l.mail + 2 * (size_t)l.ms;
  l.bytes = (l.red + 32) * sizeof(float);
  return l;
}

// A matrix operand: element (i, j) reads as ((re + δij·shift) + i·im) / div
struct Src {
  const float* re;
  const float* im;
  float div;
  float shift;
};

// Per-CTA state: geometry, the whole current vector v (vr, vi) and a
// second whole vector (ur, ui), the mailbox, the squaring stage.
struct Ctx {
  int n, c, rank, r, ms, slot;
  float *vr, *vi, *ur, *ui, *mail, *red, *sq;
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kGlobal>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if constexpr (kGlobal) return __ldcg(p);
  else return *p;
}

// The mailbox slot in use: a whole vector (re, then im), then partials.
// Every CTA stores what it computed into every CTA's slot (pushes through
// DSMEM) before a cluster barrier; after it, all reads are local.
__device__ __forceinline__ float* slot_ptr(const Ctx& x) {
  return x.mail + x.slot * x.ms;
}

__device__ __forceinline__ float* part_ptr(const Ctx& x) {
  return slot_ptr(x) + 2 * x.n;
}

// y = M·v (+ add·v) over this CTA's R rows, stored at y[row0 + lr] and
// y[N + row0 + lr] of the whole-vector slot y: this CTA's alone, or with
// `push` every CTA's (lane q stores to rank q). m.re / m.im point at the
// CTA's first row (row stride N), whose global index is row0. Warp w
// takes rows w, w + 8, ..., kRows of them at once so that their loads and
// butterflies overlap; each row's sum runs in the same order whatever R
// and kRows are. Callers synchronise before reading y.
template <bool kGlobal, int kRows>
__device__ void matvec_rows(const Ctx& x, const Src& m, int row0,
                            const float* xr, const float* xi, float* y,
                            bool push, bool with_add, float add) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = x.n, n4 = n >> 2, per_warp = x.r / kWarps;
  const bool raw = (m.div == 1.f && m.shift == 0.f);
  const float4* vr4 = reinterpret_cast<const float4*>(xr);
  const float4* vi4 = reinterpret_cast<const float4*>(xi);
  for (int q0 = 0; q0 < per_warp; q0 += kRows) {
    float sr[kRows], si[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) sr[u] = si[u] = 0.f;
    for (int j4 = lane; j4 < n4; j4 += 32) {
      const float4 u = vr4[j4], w = vi4[j4];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (q0 + q >= per_warp) break;
        const int lr = warp + kWarps * (q0 + q), i = row0 + lr;
        float4 a = ld4<kGlobal>(
            reinterpret_cast<const float4*>(m.re + (size_t)lr * n) + j4);
        float4 b = ld4<kGlobal>(
            reinterpret_cast<const float4*>(m.im + (size_t)lr * n) + j4);
        if (!raw) {
          const int j = 4 * j4;
          a.x = (a.x + (i == j ? m.shift : 0.f)) / m.div;
          a.y = (a.y + (i == j + 1 ? m.shift : 0.f)) / m.div;
          a.z = (a.z + (i == j + 2 ? m.shift : 0.f)) / m.div;
          a.w = (a.w + (i == j + 3 ? m.shift : 0.f)) / m.div;
          b.x /= m.div;
          b.y /= m.div;
          b.z /= m.div;
          b.w /= m.div;
        }
        sr[q] += a.x * u.x - b.x * w.x + a.y * u.y - b.y * w.y
               + a.z * u.z - b.z * w.z + a.w * u.w - b.w * w.w;
        si[q] += a.x * w.x + b.x * u.x + a.y * w.y + b.y * u.y
               + a.z * w.z + b.z * u.z + a.w * w.w + b.w * u.w;
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      sr[q] = warp_sum(sr[q]);
      si[q] = warp_sum(si[q]);
    }
    if (push ? lane < x.c : lane == 0) {
      float* dst = push ? cg::this_cluster().map_shared_rank(y, lane) : y;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (q0 + q >= per_warp) break;
        const int i = row0 + warp + kWarps * (q0 + q);
        dst[i] = with_add ? sr[q] + add * xr[i] : sr[q];
        dst[n + i] = with_add ? si[q] + add * xi[i] : si[q];
      }
    }
  }
}

template <bool kGlobal>
__device__ void matvec(const Ctx& x, const Src& m, int row0, const float* xr,
                       const float* xi, float* y, bool push,
                       bool with_add = false, float add = 0.f) {
  if (x.r >= 8 * kWarps)       // 8 rows a warp (C = 4 at N = 256)
    matvec_rows<kGlobal, 8>(x, m, row0, xr, xi, y, push, with_add, add);
  else
    matvec_rows<kGlobal, 4>(x, m, row0, xr, xi, y, push, with_add, add);
}

// Σ f(i) over the whole vector in one fixed order: lane l sums elements
// l, l + 32, ... in order, then an xor butterfly. Every warp computes it
// alike from the pushed vector, so every thread of every CTA holds the
// same bits, whatever C is.
template <class F>
__device__ float vec_sum(const Ctx& x, F f) {
  float s = 0.f;
  for (int i = threadIdx.x & 31; i < x.n; i += 32) s += f(i);
  return warp_sum(s);
}

// Cluster barrier, then the sum of the squaring's tile partials that every
// CTA pushed into this slot, lanes striding the tiles in order, then an
// xor butterfly: the same bits in every thread of every CTA.
__device__ float tile_total(const Ctx& x) {
  cluster_sync();
  const int lane = threadIdx.x & 31, tn = x.n / kTile;
  const int tiles = tn * (tn + 1) / 2;
  const float* part = part_ptr(x);
  float s = 0.f;
  for (int k = lane; k < tiles; k += 32) s += part[k];
  return warp_sum(s);
}

// v = w / d over the whole vector, w the slot's pushed vector.
__device__ void normalise(const Ctx& x, const float* w, float d) {
  for (int i = threadIdx.x; i < x.n; i += kThreads) {
    x.vr[i] = w[i] / d;
    x.vi[i] = w[x.n + i] / d;
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// Four 8×8 b16 matrices from shared memory: lane l gives the row address
// of matrix l / 8, and gets, of each matrix, the 32 bits at row l / 4,
// column l mod 4 (of TF32 values) — the mma's A fragment, or two B
// fragments.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four operand elements (i, j..j+3) of s, as loaded (re, im), read as
// Src says (the division as a product with inv = 1/div, within an ulp of
// it), conjugated if asked, and split into TF32 hi and lo parts, stored
// to four planes.
__device__ __forceinline__ void stage(const Src& s, float inv, float4 vr,
                                      float4 vi, int i, int j, bool conj,
                                      float* rh, float* rl, float* ih,
                                      float* il) {
  const float re[4] = {vr.x, vr.y, vr.z, vr.w};
  const float im[4] = {vi.x, vi.y, vi.z, vi.w};
  float o[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float a = (re[e] + (i == j + e ? s.shift : 0.f)) * inv;
    const float b = conj ? -(im[e] * inv) : im[e] * inv;
    const uint32_t ah = tf32(a), bh = tf32(b);
    o[0][e] = __uint_as_float(ah);
    o[1][e] = __uint_as_float(tf32(a - __uint_as_float(ah)));
    o[2][e] = __uint_as_float(bh);
    o[3][e] = __uint_as_float(tf32(b - __uint_as_float(bh)));
  }
  float* const dst[4] = {rh, rl, ih, il};
#pragma unroll
  for (int p = 0; p < 4; ++p)
    *reinterpret_cast<float4*>(dst[p]) =
        make_float4(o[p][0], o[p][1], o[p][2], o[p][3]);
}

// (yre, yim) = X·X, unnormalised, in split TF32 on the tensor cores. X is
// hermitian, so is X·X: only the 64×64 output tiles on and above the
// diagonal are computed, each off-diagonal one also written, conjugated,
// to its mirror. Those tiles go to the cluster's CTAs in turn (tile t to
// rank t mod C); each CTA's 8 warps hold 16×32 of a tile. Operands come
// from global memory (the input or the chain's scratch, through L2), are
// read as Src says and split while staged into shared memory: the A tile
// is rows i0.. of X, and as X is hermitian, the B tile transposed is the
// conjugate of rows j0.., staged the same way, so both feed the mma
// through ldmatrix. Returns sqrt(Σ|Y|²) + ε, the Frobenius norm the next
// step divides by (pallas_eig.py:_eig_body sq_body), the same bits in
// every CTA.
__device__ float square(Ctx& x, const Src& s, float* yre, float* yim) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, q = lane >> 3, r8 = lane & 7;
  const int wm = warp >> 1, wn = warp & 1;
  const int n = x.n, tn = n / kTile, tiles = tn * (tn + 1) / 2;
  const int s_row = tid >> 2, s_k = (tid & 3) * 4;    // staging: 64 × 16
  const int so = s_row * kStride + s_k;
  // ldmatrix row addresses (floats into a plane): A's fragment, and the B
  // fragments of column tiles 2p and 2p + 1 (p = 0, 1)
  const int la = (wm * 16 + r8 + (q & 1) * 8) * kStride + (q >> 1) * 4;
  const int lb = (wn * 32 + (q >> 1) * 8 + r8) * kStride + (q & 1) * 4;
  float* part = part_ptr(x);
  const float inv = 1.f / s.div;
  for (int tile = x.rank; tile < tiles; tile += x.c) {
    int ti = 0, tj = tile;               // upper-triangle tile (ti ≤ tj)
    while (tj >= tn - ti) tj -= tn - ti++;
    tj += ti;
    const int i0 = ti * kTile, j0 = tj * kTile;
    float cr[4][4], ci[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) cr[a][b] = ci[a][b] = 0.f;
    float4 par, pai, pbr, pbi;
    auto fetch = [&](int k0) {
      const size_t oa = (size_t)(i0 + s_row) * n + k0 + s_k;
      const size_t ob = (size_t)(j0 + s_row) * n + k0 + s_k;
      par = __ldcg(reinterpret_cast<const float4*>(s.re + oa));
      pai = __ldcg(reinterpret_cast<const float4*>(s.im + oa));
      pbr = __ldcg(reinterpret_cast<const float4*>(s.re + ob));
      pbi = __ldcg(reinterpret_cast<const float4*>(s.im + ob));
    };
    // stage k0's operands into buffer `buf`: A's four planes, then B's
    auto put = [&](int k0, int buf) {
      float* a = x.sq + buf * kStage + so;
      float* b = a + 4 * kPlane;
      stage(s, inv, par, pai, i0 + s_row, k0 + s_k, false, a, a + kPlane,
            a + 2 * kPlane, a + 3 * kPlane);
      stage(s, inv, pbr, pbi, j0 + s_row, k0 + s_k, true, b, b + kPlane,
            b + 2 * kPlane, b + 3 * kPlane);
    };
    // two stage buffers: step k reads buffer k & 1 while the next
    // operands are fetched and staged into the other; one barrier a step
    __syncthreads();
    fetch(0);
    put(0, 0);
    __syncthreads();
    for (int k0 = 0, buf = 0; k0 < n; k0 += kTileK, buf ^= 1) {
      const bool more = k0 + kTileK < n;
      if (more) fetch(k0 + kTileK);
      const float* sa = x.sq + buf * kStage;
      const float* sb = sa + 4 * kPlane;
#pragma unroll
      for (int kk = 0; kk < kTileK; kk += 8) {
        uint32_t rh[4], rl[4], ih[4], il[4], nih[4], nil[4];
        ldsm4(rh, sa + la + kk);
        ldsm4(rl, sa + kPlane + la + kk);
        ldsm4(ih, sa + 2 * kPlane + la + kk);
        ldsm4(il, sa + 3 * kPlane + la + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          nih[e] = ih[e] ^ 0x80000000u;
          nil[e] = il[e] ^ 0x80000000u;
        }
        // B fragments of the warp's four column tiles, per plane
        // (re hi, re lo, im hi, im lo): bf[nt][2·plane + (0: b0, 1: b1)]
        uint32_t bf[4][8];
#pragma unroll
        for (int pl = 0; pl < 4; ++pl)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            uint32_t t[4];
            ldsm4(t, sb + pl * kPlane + lb + p * 16 * kStride + kk);
            bf[2 * p][2 * pl] = t[0];
            bf[2 * p][2 * pl + 1] = t[1];
            bf[2 * p + 1][2 * pl] = t[2];
            bf[2 * p + 1][2 * pl + 1] = t[3];
          }
        // Re += Ar·Br − Ai·Bi, Im += Ar·Bi + Ai·Br, small products first;
        // term by term over the four column tiles, so that no accumulator
        // waits on its previous mma
#define SQ_TERM(acc, a, lo)                                  \
  _Pragma("unroll") for (int nt = 0; nt < 4; ++nt)           \
      mma(acc[nt], a, bf[nt][lo], bf[nt][lo + 1]);
        SQ_TERM(cr, rh, 2)
        SQ_TERM(ci, rh, 6)
        SQ_TERM(cr, rl, 0)
        SQ_TERM(ci, rl, 4)
        SQ_TERM(cr, rh, 0)
        SQ_TERM(ci, rh, 4)
        SQ_TERM(cr, nih, 6)
        SQ_TERM(ci, ih, 2)
        SQ_TERM(cr, nil, 4)
        SQ_TERM(ci, il, 0)
        SQ_TERM(cr, nih, 4)
        SQ_TERM(ci, ih, 0)
#undef SQ_TERM
      }
      // the other buffer was last read in the previous step, which ended
      // in a barrier
      if (more) put(k0 + kTileK, buf ^ 1);
      __syncthreads();
    }
    float pt = 0.f;
    const int row = i0 + wm * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = j0 + wn * 32 + nt * 8 + 2 * t4;
      const size_t o0 = (size_t)row * n + col, o1 = o0 + 8 * (size_t)n;
      __stcg(reinterpret_cast<float2*>(yre + o0),
             make_float2(cr[nt][0], cr[nt][1]));
      __stcg(reinterpret_cast<float2*>(yre + o1),
             make_float2(cr[nt][2], cr[nt][3]));
      __stcg(reinterpret_cast<float2*>(yim + o0),
             make_float2(ci[nt][0], ci[nt][1]));
      __stcg(reinterpret_cast<float2*>(yim + o1),
             make_float2(ci[nt][2], ci[nt][3]));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pt += cr[nt][e] * cr[nt][e] + ci[nt][e] * ci[nt][e];
      if (ti != tj) {      // the mirror tile (tj, ti) holds the conjugate
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const size_t o = (size_t)(col + (e & 1)) * n + row + 8 * (e >> 1);
          __stcg(yre + o, cr[nt][e]);
          __stcg(yim + o, -ci[nt][e]);
        }
      }
    }
    if (ti != tj) pt += pt;
    pt = warp_sum(pt);
    if (lane == 0) x.red[warp] = pt;
    __syncthreads();
    if (tid < x.c) {              // thread q pushes the tile's sum to rank q
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += x.red[w];
      cg::this_cluster().map_shared_rank(part, tid)[tile] = t;
    }
  }
  const float tot = tile_total(x);
  x.slot ^= 1;
  return sqrtf(tot) + kEps;
}

// Each exchange below: matvec pushes this CTA's rows of a whole vector
// into every CTA's current slot, a cluster barrier, then every CTA reads
// the whole vector locally and flips the slot.

// λ = Re(v†Av)/(v†v + ε) and the residual ‖Av − λv‖ at the current v.
template <bool kL2>
__device__ void rayleigh(Ctx& x, const Src& band, int row0, float& lam,
                         float& res) {
  const int n = x.n;
  const float* w = slot_ptr(x);
  matvec<kL2>(x, band, row0, x.vr, x.vi, slot_ptr(x), true);
  cluster_sync();
  const float num = vec_sum(x, [&](int i) {
    return x.vr[i] * w[i] + x.vi[i] * w[n + i];
  });
  const float den = vec_sum(x, [&](int i) {
    return x.vr[i] * x.vr[i] + x.vi[i] * x.vi[i];
  });
  const float l = num / (den + kEps);
  res = sqrtf(vec_sum(x, [&](int i) {
    const float dr = w[i] - l * x.vr[i], di = w[n + i] - l * x.vi[i];
    return dr * dr + di * di;
  }));
  lam = l;
  x.slot ^= 1;
}

// Cold two-phase squaring start (pallas_eig.py:_eig_body). `am` is the
// whole matrix in global memory, `band` this CTA's rows of it.
template <bool kL2>
__device__ void cold(Ctx& x, const Src& am, const Src& band, int row0,
                     int mid, int squarings, float* const sre[2],
                     float* const sim[2], float& lam, float& res) {
  const int n = x.n;
  // phase 0: ρ ≈ sqrt(Rayleigh of A²) from C = A², squared 4× more
  float nrm = square(x, am, sre[0], sim[0]);
  int cur = 0;
  for (int q = 0; q < 4; ++q) {
    nrm = square(x, Src{sre[cur], sim[cur], nrm, 0.f}, sre[1 - cur],
                 sim[1 - cur]);
    cur = 1 - cur;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    x.vr[i] = __ldcg(sre[cur] + (size_t)i * n + mid) / nrm;
    x.vi[i] = __ldcg(sim[cur] + (size_t)i * n + mid) / nrm;
  }
  __syncthreads();
  const float* u = slot_ptr(x);
  matvec<kL2>(x, band, row0, x.vr, x.vi, slot_ptr(x), true);    // u = A v
  cluster_sync();
  const float su = vec_sum(x, [&](int i) {
    return u[i] * u[i] + u[n + i] * u[n + i];
  });
  const float sv = vec_sum(x, [&](int i) {
    return x.vr[i] * x.vr[i] + x.vi[i] * x.vi[i];
  });
  x.slot ^= 1;
  const float shift = 1.05f * sqrtf((su + kEps) / (sv + kEps));

  // phase 1: B = A + shift·I squared `squarings` times
  Src b{am.re, am.im, 1.f, shift};
  if (squarings > 0) {
    nrm = square(x, b, sre[0], sim[0]);
    cur = 0;
    for (int q = 1; q < squarings; ++q) {
      nrm = square(x, Src{sre[cur], sim[cur], nrm, 0.f}, sre[1 - cur],
                   sim[1 - cur]);
      cur = 1 - cur;
    }
    b = Src{sre[cur], sim[cur], nrm, 0.f};
  }
  // v = B^(2^k) u0 with u0 the column `mid` of A, normalised
  for (int i = threadIdx.x; i < n; i += kThreads) {
    x.ur[i] = __ldcg(am.re + (size_t)i * n + mid);
    x.ui[i] = __ldcg(am.im + (size_t)i * n + mid);
  }
  __syncthreads();
  const float* w = slot_ptr(x);
  const size_t o = (size_t)row0 * n;
  matvec<true>(x, Src{b.re + o, b.im + o, b.div, b.shift}, row0, x.ur, x.ui,
               slot_ptr(x), true);
  cluster_sync();
  normalise(x, w, sqrtf(vec_sum(x, [&](int i) {
    return w[i] * w[i] + w[n + i] * w[n + i];
  })) + kEps);
  x.slot ^= 1;
  rayleigh<kL2>(x, band, row0, lam, res);
}

// Shifted power steps from the previous matrix's vector
// (pallas_eig.py:_warm_body).
template <bool kL2>
__device__ void warm(Ctx& x, const Src& band, int row0, int iters,
                     float& lam, float& res) {
  const int n = x.n;
  const float* w = slot_ptr(x);
  matvec<kL2>(x, band, row0, x.vr, x.vi, slot_ptr(x), true);
  cluster_sync();
  const float num = vec_sum(x, [&](int i) {
    return x.vr[i] * w[i] + x.vi[i] * w[n + i];
  });
  const float den = vec_sum(x, [&](int i) {
    return x.vr[i] * x.vr[i] + x.vi[i] * x.vi[i];
  });
  x.slot ^= 1;
  const float shift = 1.05f * fabsf(num / (den + kEps));
  for (int it = 0; it < iters; ++it) {
    const float* wi = slot_ptr(x);
    matvec<kL2>(x, band, row0, x.vr, x.vi, slot_ptr(x), true, true, shift);
    cluster_sync();
    normalise(x, wi, sqrtf(vec_sum(x, [&](int i) {
      return wi[i] * wi[i] + wi[n + i] * wi[n + i];
    })) + kEps);
    x.slot ^= 1;
  }
  rayleigh<kL2>(x, band, row0, lam, res);
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One thread: copy this CTA's band (rows row0.., both planes) of matrix
// m into dst by the bulk-copy engine, completing on bar.
__device__ __forceinline__ void band_load(const float* m, float* dst,
                                          uint64_t* bar, int n, int r,
                                          int row0) {
  const uint32_t plane = (uint32_t)r * n * sizeof(float);
  const uint32_t b = smem_addr(bar);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(b), "r"(2 * plane) : "memory");
  const size_t nn = (size_t)n * n, o = (size_t)row0 * n;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(m + o), "r"(plane), "r"(b) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst + (size_t)r * n)), "l"(m + nn + o), "r"(plane),
         "r"(b) : "memory");
}

// The chain walk; kL2: the band is read from global memory (L2) because
// no cluster size holds it in shared memory.
template <bool kL2>
__device__ void walk(Ctx& x, float* smem, const Layout& l, const float* a,
                     float* out, float* vout, int* colds, float* scratch,
                     int chain, int len, int mid, int squarings, int iters,
                     int nbuf) {
  const int n = x.n, r = x.r, row0 = x.rank * r;
  const size_t nn = (size_t)n * n;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* band_buf = smem + l.band;
  float* base = scratch + (size_t)chain * 4 * nn;
  float* const sre[2] = {base, base + 2 * nn};
  float* const sim[2] = {base + nn, base + 3 * nn};
  const float* chain_a = a + (size_t)chain * len * 2 * nn;
  if (!kL2 && threadIdx.x == 0)
    band_load(chain_a, band_buf, &bar[0], n, r, row0);
  int n_cold = 0;
  for (int k = 0; k < len; ++k) {
    const float* m = chain_a + (size_t)k * 2 * nn;
    Src band;
    if constexpr (kL2) {
      band = Src{m + (size_t)row0 * n, m + nn + (size_t)row0 * n, 1.f, 0.f};
    } else {
      const int b = k % nbuf;
      bar_wait(&bar[b], (uint32_t)((k / nbuf) & 1));
      // the other buffer was last read in step k − 1, which ended in
      // cluster barriers: the next band may stream into it now
      if (nbuf == 2 && k + 1 < len && threadIdx.x == 0)
        band_load(m + 2 * nn, band_buf + (size_t)(1 - b) * 2 * r * n,
                  &bar[1 - b], n, r, row0);
      const float* p = band_buf + (size_t)b * 2 * r * n;
      band = Src{p, p + (size_t)r * n, 1.f, 0.f};
    }
    const Src am{m, m + nn, 1.f, 0.f};
    float lam, res;
    if (k == 0) {
      cold<kL2>(x, am, band, row0, mid, squarings, sre, sim, lam, res);
      ++n_cold;
    } else {
      warm<kL2>(x, band, row0, iters, lam, res);
      // stale warm vector: λ < 0 (locked onto a negative eigenvalue) or a
      // Rayleigh residual above 3%·|λ| (a dominant-eigenvector crossing);
      // every CTA holds the same λ and residual bits, so all branch alike
      if (lam < 0.f || res > 0.03f * fabsf(lam) + kEps) {
        cold<kL2>(x, am, band, row0, mid, squarings, sre, sim, lam, res);
        ++n_cold;
      }
    }
    if (x.rank == 0 && threadIdx.x == 0) out[(size_t)chain * len + k] = lam;
    if (vout != nullptr) {
      float* vo = vout + ((size_t)chain * len + k) * 2 * n;
      for (int lr = threadIdx.x; lr < r; lr += kThreads) {
        vo[row0 + lr] = x.vr[row0 + lr];
        vo[n + row0 + lr] = x.vi[row0 + lr];
      }
    }
    if constexpr (!kL2) {
      if (nbuf == 1 && k + 1 < len) {
        __syncthreads();
        if (threadIdx.x == 0)
          band_load(m + 2 * nn, band_buf, &bar[0], n, r, row0);
      }
    }
  }
  if (colds != nullptr && x.rank == 0 && threadIdx.x == 0)
    colds[chain] = n_cold;
}

__global__ void __launch_bounds__(kThreads, 1)
eig_warmstart_kernel(const float* __restrict__ a, float* __restrict__ out,
                     float* __restrict__ vout, int* __restrict__ colds,
                     float* scratch, int len, int n, int mid, int squarings,
                     int iters, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const Layout l = layout(n, c, nbuf);
  Ctx x{n, c, rank, l.r, l.ms, 0,
        smem + l.vec, smem + l.vec + n, smem + l.vec + 2 * n,
        smem + l.vec + 3 * n, smem + l.mail, smem + l.red, smem + l.sq};
  if (threadIdx.x == 0) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    for (int b = 0; b < nbuf; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&bar[b])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster runs before any reads a peer's shared memory
  cluster_sync();
  const int chain = blockIdx.x / c;
  if (nbuf == 0)
    walk<true>(x, smem, l, a, out, vout, colds, scratch, chain, len, mid,
               squarings, iters, nbuf);
  else
    walk<false>(x, smem, l, a, out, vout, colds, scratch, chain, len, mid,
                squarings, iters, nbuf);
  // no CTA leaves while a peer may still read its shared memory
  cluster_sync();
}

cudaError_t prepare(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      eig_warmstart_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(eig_warmstart_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

int launch(const float* a, float* out, float* vout, int* colds,
           float* scratch, int G, int len, int n, int mid, int squarings,
           int iters, int c, int nbuf, int smem, void* stream) {
  if (c < 1 || c > kMaxCluster || n % kTile || n % (8 * c) ||
      nbuf < 0 || nbuf > 2 || (size_t)smem != layout(n, c, nbuf).bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, eig_warmstart_kernel, a, out, vout, colds,
                           scratch, len, n, mid, squarings, iters, nbuf);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// λ of B chunks' η chains of length neta, one cluster of c CTAs per chunk
// on `stream` (nbuf bands in shared memory, 0: read from L2; smem the
// bytes eig_smem_bytes gives); `colds` (B,) int32 or null gets each
// chain's cold starts. Returns cudaGetLastError().
int eig_warmstart_launch(const float* a, float* out, int* colds,
                         float* scratch, int B, int neta, int n, int mid,
                         int squarings, int iters, int c, int nbuf, int smem,
                         void* stream) {
  return launch(a, out, nullptr, colds, scratch, B, neta, n, mid, squarings,
                iters, c, nbuf, smem, stream);
}

// λ and v of G chains of L retrieval matrices, one cluster per chain.
int eigvec_warmstart_launch(const float* a, float* lam_out, float* v_out,
                            int* colds, float* scratch, int G, int L, int n,
                            int mid, int squarings, int iters, int c,
                            int nbuf, int smem, void* stream) {
  return launch(a, lam_out, v_out, colds, scratch, G, L, n, mid, squarings,
                iters, c, nbuf, smem, stream);
}

// λ of B matrices by the cold start alone (chains of length one);
// `colds` (B,) int32 or null gets each chain's cold starts (1 each).
int eig_cold_launch(const float* a, float* out, int* colds, float* scratch,
                    int B, int n, int mid, int squarings, int c, int nbuf,
                    int smem, void* stream) {
  return launch(a, out, nullptr, colds, scratch, B, 1, n, mid, squarings, 0,
                c, nbuf, smem, stream);
}

// Clusters of c CTAs with smem bytes each that the card keeps resident
// at once (cudaOccupancyMaxActiveClusters), into *count.
int eig_max_active_clusters(int c, int smem, int* count) {
  cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(count, eig_warmstart_kernel,
                                             &cfg);
}

// The dynamic shared memory bytes the kernel lays out for (n, c, nbuf)
// into *bytes, or 0 where the current card cannot give a block that much.
int eig_smem_bytes(int n, int c, int nbuf, int* bytes) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t need = layout(n, c, nbuf).bytes;
  *bytes = need <= (size_t)most ? (int)need : 0;
  return 0;
}

const char* eig_warmstart_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
