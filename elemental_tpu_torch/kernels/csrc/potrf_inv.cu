// potrf_inv: lower Cholesky factor L of a (w, w) symmetric block AND its
// inverse L^{-1}, for Hopper (sm_90a), float and double.
//
// Replaces the Pallas kernel elemental_tpu/kernels/chol_panel.py::potrf_inv
// (body _potrf_inv_kernel, with _chol_unb and _trinv_unb), which keeps the
// whole block in a TPU core's VMEM and runs the blocked recurrence in one
// launch.  This kernel computes the same function, (L, L^{-1}) from the
// lower triangle of D, in ONE cooperative launch (at most one CTA per SM,
// all resident), right-looking over NB-column diagonal blocks (32 in
// float, 64 in double) for the factor AND the inverse: after block
// s = [b0, b1),
//     L[b1:, b0:b1]  = W[b1:, b0:b1] Lkk^{-T}        (panel)
//     Li[b0:b1, :b0] = Lkk^{-1} R[b0:b1, :b0]         (inverse rows)
//     W[b1:, b1:]   -= L[b1:, b0:b1] L[b1:, b0:b1]^T  (lower triangle)
//     R[b1:, :b1]   -= L[b1:, b0:b1] Li[b0:b1, :b1]
// W lives in place in L's lower triangle and R in place in Li's (only the
// next block's rows of R go through an NB x w row buffer); no w x w
// scratch.  Each step is two phases:
//   P  the panel in 64-row strips and the inverse rows in 128-column
//      tiles, one tile per CTA;
//   Q  look-ahead: CTA 0, which computed the panel strip of block s + 1's
//      rows in P and kept those rows in shared memory, does not wait at
//      the barrier (it arrives and goes on): it updates diagonal block
//      s + 1 in shared memory and factors and inverts it with one warp
//      (the column recurrence in registers, the same elimination on the
//      identity), while the other CTAs apply the rest of step s's update
//      in 64 x 128 tiles.  So the serial diagonal chain runs beside the
//      products.
// Every product tile (tile_job) requests the old values of its output and
// all of both operands at once (K <= 32: tile_mma_short of fast_gemm.cuh),
// so it waits on one round trip to L2, and loads and stores 16 bytes a
// thread.  The grid barrier (grid_sync.cuh) backs off while it waits, so
// idle CTAs do not slow the working ones with polls.  Nothing is allocated
// here (the wrapper passes L, Li, the row buffer and the barrier's words),
// nothing synchronizes with the host, and no library is called; every
// product is full precision (FMA, or DMMA in float64; no TF32).  Each
// entry point returns the first cudaError_t that is not cudaSuccess.
//
// The float64 route.  potrf_kernel<double> runs the same schedule with
// other parts, for the card's FP64 units: the FMA route in double held the
// card's FP64 FMA pipe (half of DMMA's rate, half of FP32 FMA's) and
// spilled at 255 registers (32-element double rows beside double tiles),
// its one-warp diagonal factor took about 30 of a step's 45 us, and each
// of its 64 steps read and wrote the trailing matrix and R through L2
// once more.  So:
//   - every product tile runs on the FP64 tensor cores (tile_job_dmma:
//     mma.sync m16n8k8 f64, fast_gemm.cuh's dm_issue / dm_mma), its
//     operands staged by cp.async so that no register holds them on the
//     way and the old values share their round trip; the diagonal
//     block's shared-memory products too (dm_smem_mm).  DMMA computes
//     IEEE float64 fused multiply-adds: no precision is given up;
//   - the diagonal blocks are 64 columns wide: 32 steps, so half the
//     trailing traffic and half the grid barriers; a product tile's
//     K is 64 and the panel strip of RT = 64 rows is one block's rows;
//   - a diagonal block is factored in 16-column sub-blocks (warp_base16:
//     16-element rows, 64 registers, one rsqrt a pivot and no division),
//     joined by DMMA products; the bs cap is at most 16 (NB64_BASE);
//   - the grid barriers count arrivals (grid_count_arrive / _wait), so
//     CTA 0 never waits at the P barrier;
//   - the look-ahead and the in-place layout are the float route's.
// The float32 route is unchanged (FMA tiles; no TF32).
//
// Bound.  The least work is 2w^3/3 flops (potrf w^3/3 + trtri w^3/3)
// against 2.5 w^2 elements moved (D's lower triangle read, L and Li
// written).  At w = 2048 float that is ~5.7 GFLOP, ~0.086 ms at the
// data-sheet 67 TFLOP/s FP32, against ~42 MB, ~0.013 ms at 3.35 TB/s: the
// kernel is compute-bound.  In double the same work takes 0.0855 ms at the
// 67 TFLOP/s of the FP64 tensor cores (0.168 ms at the 34 TFLOP/s of FP64
// FMA) against ~84 MB, ~0.025 ms: compute-bound too.  The first design
// spent 1.17 ms in 127 launches of K = 32 GEMMs (launch gaps, one round
// trip per k-tile, scalar epilogues) and 0.62 ms in 64 launches of the
// one-warp base, in series; here the products are one launch's tiles with
// one round trip each, and the base runs beside them.  Wider diagonal
// blocks (64 and 128 columns, factored by a whole CTA in 32-column
// sub-blocks) were measured slower in float: one CTA's small shared-memory
// products and barriers cost more than the products they save (PERF.md).
// What it still leaves on the table, in both routes: the chain of steps,
// each a panel strip, the diagonal update and the base's serial columns
// on one CTA, and two grid barriers a step, far above the bound's share
// of a step; tiles of short K at a fraction of the product rate; and the
// workers' update carries the inverse's rows (about half its tiles).

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "fast_gemm.cuh"
#include "grid_sync.cuh"

namespace {

// The outer diagonal block of each route: NB columns (float: 32, one
// warp's rows; double: 64, factored in 16-column sub-blocks), LS, the
// leading dimension of S and X in shared memory, and LT, that of the
// diagonal factor's scratch.  Float's odd LS lets a warp read a column
// of 4-byte words without a bank conflict; double's NB + 4 lets the DMMA
// fragments' 8-byte reads (rows g, columns q of a quad) hit 16 distinct
// bank pairs in each half-warp.
template <typename T>
struct Blk {
  static constexpr bool F64 = std::is_same<T, double>::value;
  static constexpr int NB = F64 ? 64 : 32;
  static constexpr int LS = F64 ? NB + 4 : NB + 1;
  static constexpr int LT = F64 ? NB + 4 : NB;
};
constexpr int NB_MAX = 64;           // the row buffer's rows
constexpr int RT = 64;               // rows of a product tile (TM = 4)

template <typename T>
struct Args {
  const T* D;
  long long ldd;
  int w;
  int b;                             // sub-block cap: 1..NB64_BASE or NB
  T* L;
  T* Li;
  T* Rb;                             // NB x w: the next block's rows of R
  unsigned* bar;                     // the grid barrier's two words, zero
};

// Shared memory: the product tiles' operands (also the diagonal factor's
// scratch, NB x LT), then S and X.
template <typename T>
__host__ __device__ constexpr size_t gemm_elems() {
  constexpr int NB = Blk<T>::NB;
  constexpr size_t bytes = Blk<T>::F64 ? dm_smem_bytes<8, NB>()
                                       : fg_short_smem_bytes<T, 4, NB>();
  static_assert(bytes >= (size_t)NB * Blk<T>::LT * sizeof(T),
                "the diagonal factor's scratch lives in the tiles' region");
  return bytes / sizeof(T);
}

// The float64 route factors a diagonal block in sub-blocks of at most
// NB64_BASE columns (warp_base16), the float route in one of NB.
constexpr int NB64_BASE = 16;

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return (gemm_elems<T>() + 2 * (size_t)Blk<T>::NB * Blk<T>::LS) * sizeof(T);
}

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }

// One b x b sub-block (b <= 32) on one warp: Lkk = chol(lower(A)) in place
// in A and Likk = Lkk^{-1} into X (shared memory, leading dimension ld).
// Lane i holds row i of the running factor and of the running inverse in
// registers; a column step broadcasts the pivot, the scaled column of L and
// the finished row of the inverse with shuffles, so the recurrence runs
// without a barrier.  The strict upper part of the factor collects garbage
// (the update is branch-free) and is written as zero.
template <typename T>
__device__ void warp_base(T* A, T* X, int ld, int b) {
  constexpr int NB = Blk<T>::NB;
  constexpr unsigned FULL = 0xffffffffu;
  const int i = threadIdx.x % 32;
  T s[NB], x[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    s[k] = (i < b && k <= i) ? A[i * ld + k] : T(0);
    x[k] = (i < b && k == i) ? T(1) : T(0);
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j >= b) break;                        // warp-uniform
    const T d = dsqrt(__shfl_sync(FULL, s[j], j));
    const T inv = T(1) / d;
    const T lj = (i > j) ? s[j] * inv : T(0);  // L[i][j]
    if (i == j) {
      s[j] = d;
#pragma unroll
      for (int c = 0; c <= j; ++c) x[c] *= inv;
    } else if (i > j) {
      s[j] = lj;
    }
#pragma unroll
    for (int k = j + 1; k < NB; ++k) s[k] -= lj * __shfl_sync(FULL, lj, k);
#pragma unroll
    for (int c = 0; c <= j; ++c) x[c] -= lj * __shfl_sync(FULL, x[c], j);
  }
  if (i < b) {
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (k < b) {
        A[i * ld + k] = (k <= i) ? s[k] : T(0);
        X[i * ld + k] = x[k];                 // zero above the diagonal
      }
    }
  }
}

// 1 / sqrt(p) with neither a branch nor a division: the hardware's
// approximation (rsqrt.approx.ftz.f64) refined by two Newton steps in
// DFMA, to within an ulp or two of the rounded value.  p <= 0 gives NaN
// (p = 0: inf times 0), as the plain version gives NaNs on a block that
// is not positive definite.
__device__ __forceinline__ double rsqrt_nr(double p) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(p));
#pragma unroll
  for (int it = 0; it < 2; ++it) y = fma(0.5 * y, fma(-p * y, y, 1.0), y);
  return y;
}

// The float64 route's base: one b x b sub-block (b <= NB64_BASE) on one
// warp, as warp_base, with 16-element rows (64 registers, where warp_base's
// 32-element double rows take 128 and spill beside a product tile) and one
// rsqrt_nr a pivot: its value r scales the column, and the pivot times it
// is the diagonal.  The inverse's rows stay unscaled until the end (lane
// i scales its row by its own r once): a column's elimination uses
// L[i][j] r, one product a lane instead of one a column of the pivot's
// row.  No branch: the lanes select, and with FULL (b = NB64_BASE, the
// main path) the columns unroll without a test, so the next pivot's rsqrt
// issues while this column's updates do.  Lanes b.. hold zero rows.
template <bool FULL>
__device__ void warp_base16_cols(double* A, double* X, int ld, int b) {
  constexpr unsigned ALL = 0xffffffffu;
  constexpr int BW = NB64_BASE;
  const int i = threadIdx.x % 32;
  double s[BW], x[BW], ri = 1.0;             // ri: this row's r
#pragma unroll
  for (int k = 0; k < BW; ++k) {
    s[k] = (i < b && k <= i) ? A[i * ld + k] : 0.0;
    x[k] = (i < b && k == i) ? 1.0 : 0.0;
  }
#pragma unroll
  for (int j = 0; j < BW; ++j) {
    if (!FULL && j >= b) break;               // warp-uniform
    const double p = __shfl_sync(ALL, s[j], j);
    const double r = rsqrt_nr(p);
    const double lj = (i > j) ? s[j] * r : 0.0;  // L[i][j]
    s[j] = (i == j) ? p * r : ((i > j) ? lj : s[j]);
    ri = (i == j) ? r : ri;
    const double ljr = lj * r;                // times the unscaled row j
#pragma unroll
    for (int k = j + 1; k < BW; ++k) s[k] -= lj * __shfl_sync(ALL, lj, k);
#pragma unroll
    for (int c = 0; c <= j; ++c) x[c] -= ljr * __shfl_sync(ALL, x[c], j);
  }
  if (i < b) {
#pragma unroll
    for (int k = 0; k < BW; ++k) {
      if (k < b) {
        A[i * ld + k] = (k <= i) ? s[k] : 0.0;
        X[i * ld + k] = x[k] * ri;
      }
    }
  }
}

__device__ void warp_base16(double* A, double* X, int ld, int b) {
  if (b == NB64_BASE)
    warp_base16_cols<true>(A, X, ld, b);
  else
    warp_base16_cols<false>(A, X, ld, b);
}

// C (m x n) = A B (mode 0), -= A B (mode 1, only c <= r when lower) or
// = -A B (mode 2), all in shared memory: A (m x K) row-major, B (K x n)
// row-major, or B^T stored (n x K) row-major when BT.  A warp takes 4 rows
// and 128 columns (lane + 32 v), so B's reads are conflict-free (the
// leading dimensions are odd) and A's are broadcasts.  C must not overlap
// A or B.  All threads call it.
template <bool BT, typename T>
__device__ void smem_mm(T* C, int ldc, const T* A, int lda, const T* B,
                        int ldb, int m, int n, int K, int mode, bool lower) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nrb = (m + 3) / 4, ncg = (n + 127) / 128;
  for (int it = warp; it < nrb * ncg; it += FG_THREADS / 32) {
    const int r0 = (it % nrb) * 4, c0 = (it / nrb) * 128 + lane;
    T acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
    for (int k = 0; k < K; ++k) {
      T a[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = r0 + u < m ? A[(r0 + u) * lda + k] : T(0);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = c0 + 32 * v;
        bv[v] = c < n ? (BT ? B[c * ldb + k] : B[k * ldb + c]) : T(0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * bv[v];
    }
    T old[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = r0 + u, c = c0 + 32 * v;
        old[u][v] = (mode == 1 && r < m && c < n) ? C[r * ldc + c] : T(0);
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = r0 + u, c = c0 + 32 * v;
        if (r >= m || c >= n || (lower && c > r)) continue;
        C[r * ldc + c] = mode == 0 ? acc[u][v]
                         : (mode == 1 ? old[u][v] - acc[u][v] : -acc[u][v]);
      }
  }
}

// The smem product of each route: FP32 FMA (smem_mm), or DMMA in float64.
template <bool BT, typename T>
__device__ void smem_prod(T* C, int ldc, const T* A, int lda, const T* B,
                          int ldb, int m, int n, int K, int mode,
                          bool lower) {
  if constexpr (Blk<T>::F64)
    dm_smem_mm<BT>(C, ldc, A, lda, B, ldb, m, n, K, mode, lower);
  else
    smem_mm<BT>(C, ldc, A, lda, B, ldb, m, n, K, mode, lower);
}

// Factor and invert the nb x nb block held in S (lower triangle valid,
// zero above) into S = L and X = L^{-1} (X zero on entry), both with
// leading dimension LS in shared memory; tmp holds NB x LT elements.  With
// the whole block one sub-block (b = nb, the float main path) this is one
// warp_base.  A smaller cap b (at most NB64_BASE in float64, whose main
// path takes four 16-column sub-blocks) factors b-column sub-blocks: the base
// (warp_base, warp_base16 in float64), the rows below it times its
// inverse, the trailing lower triangle (smem_prod), then the inverse's
// off-diagonal block rows left-looking, X[c, :c0] = -X_cc (L[c, :c0]
// X[:c0, :c0]).  All threads call it.
template <typename T>
__device__ void diag_factor(T* S, T* X, T* tmp, int nb, int b) {
  constexpr int LS = Blk<T>::LS, LT = Blk<T>::LT;
#pragma unroll 1
  for (int c0 = 0; c0 < nb; c0 += b) {
    const int cb = b < nb - c0 ? b : nb - c0;
    T* Lcc = S + c0 * LS + c0;
    T* Xcc = X + c0 * LS + c0;
    if (threadIdx.x < 32) {
      if constexpr (Blk<T>::F64)
        warp_base16(Lcc, Xcc, LS, cb);
      else
        warp_base(Lcc, Xcc, LS, cb);
    }
    __syncthreads();
    const int r0 = c0 + cb, nr = nb - r0;
    if (nr > 0) {
      // rows below: S[r0:, c0:c0+cb] X_cc^T (through tmp), then the
      // trailing lower triangle S[r0:, r0:] -= P P^T
      smem_prod<true>(tmp, LT, S + r0 * LS + c0, LS, Xcc, LS, nr, cb, cb,
                      0, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * cb; idx += FG_THREADS)
        S[(r0 + idx / cb) * LS + c0 + idx % cb] = tmp[(idx / cb) * LT + idx % cb];
      __syncthreads();
      const T* Pn = S + r0 * LS + c0;
      smem_prod<true>(S + r0 * LS + r0, LS, Pn, LS, Pn, LS, nr, nr, cb, 1,
                      true);
      __syncthreads();
    }
  }
#pragma unroll 1
  for (int c0 = b; c0 < nb; c0 += b) {
    const int cb = b < nb - c0 ? b : nb - c0;
    smem_prod<false>(tmp, LT, S + c0 * LS, LS, X, LS, cb, c0, c0, 0, false);
    __syncthreads();
    smem_prod<false>(X + c0 * LS, LS, X + c0 * LS + c0, LS, tmp, LT, cb,
                     c0, cb, 2, false);
    __syncthreads();
  }
}

// One 64 x 16 TN output tile, K <= NB, and its epilogue: dst = acc (sub ==
// 0) or dst = src - acc (sub == 1; src read through L2, may be dst), only
// where c <= r + lower_off when lower.  The old values are requested
// before the operands, and all of both operands at once
// (tile_mma_short), so a tile waits on one round trip to L2, not one per
// k-tile.  Not inlined: every tile of the kernel runs this one copy.
template <typename T, int TN>
__device__ __noinline__ void tile_job(Op<T> A, int m, Op<T> B, int n, int K,
                                      bool vec, T* smem, T* dst,
                                      long long ldd, const T* src,
                                      long long lds, int sub, int lower,
                                      int lower_off) {
  constexpr int NB = Blk<T>::NB;
  constexpr int G4 = TN / 4;                    // groups of 4 columns
  T acc[4][TN], old[4][TN];
  // each thread's columns come in runs of 4: 16-byte loads and stores
  // (vec: the caller checked the alignment of dst, src and their strides)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tile_row(i);
#pragma unroll
    for (int g = 0; g < G4; ++g) {
      const int c = tile_col(4 * g);
      T v[4];
      fg_ld4(src + r * lds + c, vec, (sub && r < m) ? n - c : 0, v);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        old[i][4 * g + t] = v[t];
        acc[i][4 * g + t] = T(0);
      }
    }
  }
  tile_mma_short<T, 4, TN, NB>(acc, A, m, B, n, K, vec, smem);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tile_row(i);
    if (r >= m) continue;
#pragma unroll
    for (int g = 0; g < G4; ++g) {
      const int c = tile_col(4 * g);
      T v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[t] = sub ? old[i][4 * g + t] - acc[i][4 * g + t] : acc[i][4 * g + t];
      int valid = n - c;
      if (lower && c + 3 > r + lower_off) {
        // the diagonal cuts this run: element by element
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (t < valid && c + t <= r + lower_off) dst[r * ldd + c + t] = v[t];
      } else {
        fg_st4(dst + r * ldd + c, vec, valid, v);
      }
    }
  }
}

// tile_job of the float64 route: the same contract on the FP64 tensor
// cores (dm_issue / dm_mma of fast_gemm.cuh), a 64 x 16 TN tile whose
// operands are staged by cp.async, so the old values, requested between
// the two, share their round trip to L2, and no register holds an operand
// on the way (the FMA tile's staging spills beside 32-element double
// rows).  Each thread's outputs come in pairs of adjacent columns:
// 16-byte loads and stores when vec.
template <int TN>
__device__ __noinline__ void tile_job_dmma(Op<double> A, int m, Op<double> B,
                                           int n, int K, bool vec,
                                           double* smem, double* dst,
                                           long long ldd, const double* src,
                                           long long lds, int sub, int lower,
                                           int lower_off) {
  constexpr int NB = Blk<double>::NB;
  constexpr int NI = TN / 2;
  double acc[2][NI][4], old[2][NI][4];
  dm_issue<TN, NB>(A, m, B, n, K, vec, smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = dm_row(mi, h), c = dm_col<TN>(ni);
        dm_ld2(src + r * lds + c, vec, (sub && r < m) ? n - c : 0,
               &old[mi][ni][2 * h]);
        acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.0;
      }
  dm_mma<TN, NB>(acc, A.kmajor, B.kmajor, K, smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = dm_row(mi, h), c = dm_col<TN>(ni);
        if (r >= m) continue;
        double v[2];
#pragma unroll
        for (int t = 0; t < 2; ++t)
          v[t] = sub ? old[mi][ni][2 * h + t] - acc[mi][ni][2 * h + t]
                     : acc[mi][ni][2 * h + t];
        const int valid = n - c;
        if (lower && c + 1 > r + lower_off) {
          // the diagonal cuts this pair
          if (valid > 0 && c <= r + lower_off) dst[r * ldd + c] = v[0];
        } else {
          dm_st2(dst + r * ldd + c, vec, valid, v);
        }
      }
}

// The product tile of each route.
template <typename T, int TN>
__device__ __forceinline__ void tile(Op<T> A, int m, Op<T> B, int n, int K,
                                     bool vec, T* smem, T* dst, long long ldd,
                                     const T* src, long long lds, int sub,
                                     int lower, int lower_off) {
  if constexpr (Blk<T>::F64)
    tile_job_dmma<TN>(A, m, B, n, K, vec, smem, dst, ldd, src, lds, sub,
                      lower, lower_off);
  else
    tile_job<T, TN>(A, m, B, n, K, vec, smem, dst, ldd, src, lds, sub, lower,
                    lower_off);
}

// S (NB x NB, leading dimension LS) = the nr x nc block at src (leading
// dimension lds), or its lower triangle when lower, zero elsewhere: every
// thread's loads are issued before its stores, so they wait on one round
// trip, not one each.
template <typename T>
__device__ void load_block(T* S, const T* src, long long lds, int nr, int nc,
                           bool lower) {
  constexpr int NB = Blk<T>::NB, LS = Blk<T>::LS;
  constexpr int PER = (NB * LS + FG_THREADS - 1) / FG_THREADS;
  T v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = threadIdx.x + k * FG_THREADS, r = idx / LS, c = idx % LS;
    v[k] = (r < nr && c < nc && (!lower || c <= r)) ? __ldcg(src + r * lds + c)
                                                    : T(0);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = threadIdx.x + k * FG_THREADS;
    if (idx < NB * LS) S[idx] = v[k];
  }
}

// S, X (nb x nb) back to L[b0.., b0..] and Li[b0.., b0..] (full blocks).
template <typename T>
__device__ void write_diag(const Args<T>& a, const T* S, const T* X, int b0,
                           int nb) {
  constexpr int LS = Blk<T>::LS;
  for (int idx = threadIdx.x; idx < nb * nb; idx += FG_THREADS) {
    const int r = idx / nb, c = idx % nb;
    const size_t g = (size_t)(b0 + r) * a.w + b0 + c;
    a.L[g] = S[r * LS + c];
    a.Li[g] = X[r * LS + c];
  }
}

template <typename T>
__device__ void zero_x(T* X) {
  constexpr int NB = Blk<T>::NB, LS = Blk<T>::LS;
  for (int idx = threadIdx.x; idx < NB * LS; idx += FG_THREADS) X[idx] = T(0);
}

// Phase-P items of step s (nb-column blocks): panel strips of RT rows from
// b1, then inverse-row tiles of 128 columns.
__host__ __device__ inline void p_items(int w, int nb, int s, int* npan,
                                        int* nli) {
  const int b0 = s * nb, b1 = b0 + nb < w ? b0 + nb : w;
  *npan = (w - b1 + RT - 1) / RT;
  *nli = (b0 + FG_BN - 1) / FG_BN;
}

// Trailing tiles of row tile ri (RT rows from b2 = b1 + nbn) that reach
// the lower triangle: column tiles of 128 from b1, at most ct.
__host__ __device__ inline int trailing_in_row(int ri, int nbn, int ct) {
  const int n = (nbn + ri * RT + RT - 1) / FG_BN + 1;
  return n < ct ? n : ct;
}

// Phase Q's worker tiles: the R tiles of the next block's rows, then per
// row tile its trailing tiles and its R tiles (rct a row).
__host__ __device__ inline int q_count(int rt, int nbn, int ct, int rct) {
  int q = rct;
  for (int ri = 0; ri < rt; ++ri) q += trailing_in_row(ri, nbn, ct) + rct;
  return q;
}

template <typename T>
__global__ void __launch_bounds__(FG_THREADS, 1) potrf_kernel(Args<T> a) {
  constexpr int NB = Blk<T>::NB, LS = Blk<T>::LS;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* gsm = reinterpret_cast<T*>(dyn);
  T* S = gsm + gemm_elems<T>();
  T* X = S + NB * LS;
  const int w = a.w, G = gridDim.x, bid = blockIdx.x;
  const int nsteps = (w + NB - 1) / NB;
  const size_t ld = (size_t)w;
  const bool vec = fg_aligned(a.L, w) && fg_aligned(a.Li, w) &&
                   fg_aligned(a.Rb, w);
  const int nb0 = NB < w ? NB : w;

  // L = lower triangle of D, Li = 0; CTA 0 writes diagonal block 0
  for (long long idx = (long long)bid * FG_THREADS + threadIdx.x;
       idx < (long long)w * w; idx += (long long)G * FG_THREADS) {
    const int i = (int)(idx / w), j = (int)(idx % w);
    if (i < nb0 && j < nb0) continue;
    a.L[idx] = (j <= i) ? a.D[i * a.ldd + j] : T(0);
    a.Li[idx] = T(0);
  }
  // The grid barriers: float keeps grid_barrier (a generation word, so
  // CTA 0, which arrives at the P barrier without waiting, must see it
  // open before its next barrier); float64 counts arrivals on one word
  // that only grows (grid_count_arrive / grid_count_wait: an arrival is
  // one release and no round trip, a wait one acquire poll), so CTA 0
  // never waits at the P barrier, and each barrier opens in about a
  // round trip to L2 instead of several.
  constexpr bool COUNTED = Blk<T>::F64;
  unsigned target = 0;                       // float64: arrivals so far
  auto sync_all = [&]() {
    if constexpr (COUNTED) {
      grid_count_arrive(a.bar);
      target += G;
      grid_count_wait(a.bar, target);
    } else {
      grid_barrier(a.bar);
    }
  };
  if (bid == 0) {
    zero_x(X);
    load_block(S, a.D, a.ldd, nb0, nb0, true);
    __syncthreads();
    diag_factor(S, X, gsm, nb0, a.b);
    write_diag(a, S, X, 0, nb0);
  }
  sync_all();

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    const int b0 = s * NB, b1 = b0 + NB < w ? b0 + NB : w;
    const int nbs = b1 - b0;
    const T* Lkk = a.Li + b0 * ld + b0;
    const int b2 = b1 + NB < w ? b1 + NB : w, nbn = b2 - b1;
    // ---- phase P: panel L[b1:, b0:b1] = W Lkk^{-T}, inverse rows
    //      Li[b0:b1, :b0] = Lkk^{-1} R[b0:b1, :b0] (R from the row buffer)
    int npan, nli;
    p_items(w, NB, s, &npan, &nli);
#pragma unroll 1
    for (int t = bid; t < npan + nli; t += G) {
      if (t < npan) {
        // every CTA reads only its own strip of W: written in place
        const int row0 = b1 + t * RT;
        const int m = w - row0 < RT ? w - row0 : RT;
        T* strip = a.L + row0 * ld + b0;
        tile<T, 4>(Op<T>{strip, (long long)w, 0}, m,
                       Op<T>{Lkk, (long long)w, 0}, nbs, nbs, vec, gsm,
                       strip, w, nullptr, 0, 0, 0, 0);
        if (t == 0 && !COUNTED) {
          // block s + 1's rows of the panel, kept in X for the update of
          // that diagonal block in phase Q (CTA 0 takes strip 0; in
          // float64 after its arrival at the P barrier)
          __syncthreads();
          load_block(X, strip, w, nbn, nbs, false);
        }
      } else {
        const int col0 = (t - npan) * FG_BN;
        const int n = b0 - col0 < FG_BN ? b0 - col0 : FG_BN;
        tile<T, 8>(Op<T>{Lkk, (long long)w, 0}, nbs,
                       Op<T>{a.Rb + col0, (long long)w, 1}, n, nbs, vec, gsm,
                       a.Li + b0 * ld + col0, w, nullptr, 0, 0, 0, 0);
      }
    }
    if (s + 1 == nsteps) break;
    // CTA 0 needs only its own strip of the panel in phase Q: it arrives
    // at the barrier and goes on; the others wait for every strip
    unsigned gen = 0;
    if constexpr (COUNTED) {
      grid_count_arrive(a.bar);
      target += G;
      if (bid != 0)
        grid_count_wait(a.bar, target);
      else
        load_block(X, a.L + b1 * ld + b0, w, nbn, nbs, false);
    } else if (bid == 0) {
      gen = grid_arrive(a.bar);
    } else {
      grid_barrier(a.bar);
    }

    // ---- phase Q: step s's update; CTA 0 takes diagonal block s + 1
    const T* L21 = a.L + b0;                  // row r of the panel: L21 + r*ld
    if (bid == 0) {
      // S = lower(W[b1:b2, b1:b2]) - P P^T, P the strip's rows kept in X
      load_block(S, a.L + b1 * ld + b1, w, nbn, nbn, true);
      __syncthreads();
      smem_prod<true>(S, LS, X, LS, X, LS, nbn, nbn, nbs, 1, true);
      __syncthreads();
      zero_x(X);
      __syncthreads();
      diag_factor(S, X, gsm, nbn, a.b);
      write_diag(a, S, X, b1, nbn);
      if constexpr (!COUNTED) grid_wait_past(a.bar, gen);
    }
    if (bid != 0 || G == 1) {
      const int worker = G > 1 ? bid - 1 : 0, workers = G > 1 ? G - 1 : 1;
      // the tiles of step s: the R tiles of block s + 1's rows (to the row
      // buffer), then per row tile of RT rows from b2 its trailing lower
      // tiles and its R tiles; worker k takes tiles k, k + workers, ...
      const int rt = (w - b2 + RT - 1) / RT;
      const int ct = (w - b1 + FG_BN - 1) / FG_BN;
      const int rct = (b1 + FG_BN - 1) / FG_BN;
      const int total = q_count(rt, nbn, ct, rct);
      const Op<T> Bli{a.Li + b0 * ld, (long long)w, 1};   // Li[b0:b1, :]
#pragma unroll 1
      for (int t = worker; t < total; t += workers) {
        if (t < rct) {
          // R[b1:b2, col0..] -= L21[b1:b2] Li[b0:b1, col0..], to Rb
          const int col0 = t * FG_BN;
          const int n = b1 - col0 < FG_BN ? b1 - col0 : FG_BN;
          tile<T, 8>(Op<T>{L21 + b1 * ld, (long long)w, 0}, nbn,
                         Op<T>{Bli.p + col0, (long long)w, 1}, n, nbs, vec,
                         gsm, a.Rb + col0, w, a.Li + b1 * ld + col0, w, 1, 0,
                         0);
          continue;
        }
        int u = t - rct, ri = 0;
        for (;; ++ri) {
          const int cnt = trailing_in_row(ri, nbn, ct) + rct;
          if (u < cnt) break;
          u -= cnt;
        }
        const int row0 = b2 + ri * RT;
        const int m = w - row0 < RT ? w - row0 : RT;
        const Op<T> rows{L21 + row0 * ld, (long long)w, 0};
        const int nt = trailing_in_row(ri, nbn, ct);
        if (u < nt) {
          // W[row0.., col0..] -= L21 L21^T, lower triangle only
          const int col0 = b1 + u * FG_BN;
          const int n = w - col0 < FG_BN ? w - col0 : FG_BN;
          T* c = a.L + row0 * ld + col0;
          tile<T, 8>(rows, m, Op<T>{L21 + col0 * ld, (long long)w, 0}, n,
                         nbs, vec, gsm, c, w, c, w, 1, 1, row0 - col0);
        } else {
          // R[row0.., col0..] -= L21 Li[b0:b1, col0..], in place
          const int col0 = (u - nt) * FG_BN;
          const int n = b1 - col0 < FG_BN ? b1 - col0 : FG_BN;
          T* c = a.Li + row0 * ld + col0;
          tile<T, 8>(rows, m, Op<T>{Bli.p + col0, (long long)w, 1}, n,
                         nbs, vec, gsm, c, w, c, w, 1, 0, 0);
        }
      }
    }
    sync_all();
  }
}

template <typename T>
int potrf_inv(const T* D, long long ldd, int w, int bs, T* L, T* Li, T* Rb,
              unsigned* bar, cudaStream_t st) {
  constexpr int NB = Blk<T>::NB;
  if (w <= 0) return cudaSuccess;
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const size_t smem = smem_bytes<T>();
  if ((err = cudaFuncSetAttribute(potrf_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, potrf_kernel<T>, FG_THREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // as many CTAs as the widest phase has items, at most one per SM
  const int nsteps = (w + NB - 1) / NB;
  int want = 1;
  for (int s = 0; s < nsteps; ++s) {
    int npan, nli;
    p_items(w, NB, s, &npan, &nli);
    if (npan + nli > want) want = npan + nli;
    const int b1 = (s + 1) * NB < w ? (s + 1) * NB : w;
    if (b1 < w) {
      const int b2 = b1 + NB < w ? b1 + NB : w;
      const int q = q_count((w - b2 + RT - 1) / RT, b2 - b1,
                            (w - b1 + FG_BN - 1) / FG_BN,
                            (b1 + FG_BN - 1) / FG_BN);
      if (q + 1 > want) want = q + 1;            // + CTA 0
    }
  }
  const int G = want < sms ? want : sms;
  const int bmax = Blk<T>::F64 ? NB64_BASE : NB;
  Args<T> a{D, ldd, w, bs < 1 ? 1 : (bs < bmax ? bs : bmax), L, Li, Rb, bar};
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)potrf_kernel<T>, G,
                                     FG_THREADS, args, smem, st);
}

}  // namespace

// C entry points (loaded with ctypes).  Pointers are device pointers; ldd is
// D's leading dimension in elements; L and Li are w x w contiguous; Rb holds
// potrf_inv_rowbuf(w) elements of the block's type (the rows of either
// route's diagonal block); bar is two zero 32-bit words (the grid
// barrier's).
extern "C" long long potrf_inv_rowbuf(int w) {
  return (long long)NB_MAX * w;
}

extern "C" int potrf_inv_f32(const void* D, long long ldd, int w, int bs,
                             void* L, void* Li, void* Rb, void* bar,
                             void* stream) {
  return potrf_inv<float>(static_cast<const float*>(D), ldd, w, bs,
                          static_cast<float*>(L), static_cast<float*>(Li),
                          static_cast<float*>(Rb), static_cast<unsigned*>(bar),
                          static_cast<cudaStream_t>(stream));
}

extern "C" int potrf_inv_f64(const void* D, long long ldd, int w, int bs,
                             void* L, void* Li, void* Rb, void* bar,
                             void* stream) {
  return potrf_inv<double>(static_cast<const double*>(D), ldd, w, bs,
                           static_cast<double*>(L), static_cast<double*>(Li),
                           static_cast<double*>(Rb), static_cast<unsigned*>(bar),
                           static_cast<cudaStream_t>(stream));
}
