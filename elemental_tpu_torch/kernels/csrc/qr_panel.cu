// qr_panel: Householder QR of an (M, k) panel, M >= k, and the triangle T
// of its block reflector, for Hopper (sm_90a), float and double.
//
// Replaces the Pallas kernel elemental_tpu/kernels/qr_panel.py::qr_panel
// (body _qr_panel_kernel), which keeps the whole padded panel in a TPU
// core's VMEM and, for each of the k columns, runs a masked matrix-vector
// product and a rank-1 update over the whole panel, then the larft
// recurrence.  The main path's first panel is 65536 x 2048 float
// (512 MiB): that unblocked form would re-read and re-write the trailing
// panel once per column, ~1.1 TB.  So this kernel computes the same
// function blocked at two levels inside the panel: (packed V\R, tau, T) as
// the plain version _panel_qr + _larft(_panel_v(packed), tau) gives them,
// up to rounding, with the same larfg guards (anorm == 0 gives tau = 0 and
// beta = -0; beta = -sign(alpha) anorm with alpha = 0 taken as +; a zero
// denominator is replaced by 1; sigma is a plain sum of squares).
//
// Per outer block of ob <= OB = 128 columns [so, eo), on the caller's
// stream:
//
//   inner chunks of cw <= CW = 32 columns [s, e) of the outer block:
//   factor_chunk   ONE cooperative launch (at most one CTA of 512 threads
//                  per SM, all resident).  CTA b owns a slab of rows of
//                  [s, M), in shared memory when it fits, else worked on
//                  in place in device memory.  Column j needs two sums
//                  over the rows below j: sigma = sum x_i^2 and the row
//                  dots w_l = v^T P[:, l]; with v_i = x_i / denom, w_l =
//                  P_jl + (sum_{i>j} x_i P_il) / denom and sigma is the dot
//                  with l = j, so ONE set of per-CTA partials feeds both.
//                  Per column: every CTA sums the G CTAs' partials in the
//                  same fixed order (all loads in flight at once), so all
//                  derive the same beta, tau and denom; v_i = x_i / denom
//                  in one pass; then one pass over the slab, a warp per
//                  row and a lane per column, applies the reflector to the
//                  chunk's columns right of j and accumulates the next
//                  column's partials from the updated values (each lane
//                  recomputes the row's new entry in column j + 1 by the
//                  same expression as the lane that owns it); one grid
//                  barrier (float: grid.sync(); double: the counting
//                  barrier of grid_sync.cuh, on a word the host zeroes
//                  once a call).  At the end the chunk's rows [s, e) hold
//                  V's unit upper part, R's triangle is kept aside, and
//                  tau[s:e] is written.
//   Z_i = V_c^T P[s:M, so:eo]  split over rows, slices summed in order;
//                  Z_i[:, :s-so] = (V[:, so:s]^T V_c)^T and Z_i[:, s-so:
//                  e-so] = V_c^T V_c are the grams T needs.
//   tblock_kernel  T_cc, larft's recurrence on V_c^T V_c and tau[s:e] (the
//                  only serial part of T), into T[s:e, s:e].
//   Y_i = T_cc^T Z_i, T[so:s, s:e] = -T[so:s, so:s] Y_i[:, :s-so]^T, and
//                  P[s:M, e:eo] -= V_c Y_i[:, e-so:]: the inner block
//                  reflector on the rest of the outer block only (65536 x
//                  128 float is 32 MiB, resident in the 50 MB L2).
//   restore_r      R's triangle back into rows [s, e).
//
//   then the outer block, with V_o's unit upper part in place (R_oo kept
//   aside by save_unit_upper and put back by restore_r):
//   Z_o = V_o^T P[so:M, 0:k] but for its own columns [so, eo) (split over
//                  rows, slices summed in order)
//   Y_o = T_oo^T Z_o,  T[:so, so:eo] = -T[:so, :so] Y_o[:, :so]^T,
//   P[so:M, eo:k] -= V_o Y_o[:, eo:]   (K = 128: the panel streams once
//                  per 128 columns, not twice per 64)
//
// Every float product is fgemm_kernel: the register tiles of fast_gemm.cuh
// (128 x 128), full-precision FMA, 16-byte loads; every double product
// dm_fgemm_kernel: its FP64 tensor-core tiles (64 x 128, dm_tile_mma,
// mma.sync m16n8k8 f64 on 32-deep k-tiles staged by cp.async).
// Nothing is allocated here (the wrapper passes the outputs and the
// scratch), nothing synchronizes with the host, and no library is called.
// Each entry point returns the first cudaError_t that is not cudaSuccess.
//
// Bound.  The least work is 2 M k^2 - 2 k^3 / 3 flops for the reflectors,
// M k^2 - 2 k^3 / 3 for V^T V's upper half (V is unit lower trapezoidal,
// so column j's dots run over rows >= j only) and k^3 / 3 for T's
// triangular products: 3 M k^2 - k^3 in all, against M k elements read
// and M k + k^2 + k written.  At M = 65536, k = 2048 float: 8.2e11
// flop, ~12.2 ms at the data-sheet 67 TFLOP/s FP32, against 1.1 GB,
// ~0.33 ms at 3.35 TB/s: compute-bound.  The first design (64-column
// chunks, Z and the update on 8 x 8 tiles at ~20 TFLOP/s streaming the
// panel twice per chunk, a spine of 9.9 us a column whose largest part,
// a probe of a scratch copy found, was the slab's two serial
// shared-memory loops) is replaced by the two levels, the 128 x 128
// tiles with 16-byte loads and stores, and the fused slab pass.  What it still leaves on the table:
// the spine, ~6.2 us a column on the main path (the probe: 1.3 us for the
// partial sums and their barrier, 1.0 the scalars and v, 2.3 the fused
// pass, 1.4 the grid barrier); and the products' CUDA-core rate (~41
// TFLOP/s for Z_o, ~30 for the update; no TF32 is allowed, DMMA would
// serve double only).
//
// The double route (the qr_least_squares example's 32768 x 128 panel, nb
// 128: 0.024 ms at the data-sheet 67 TFLOP/s of the FP64 tensor cores) is
// spine-bound: ~6 us a column, in four chunks of 32, against ~0.3 ms of
// products.  It was float's instantiated for double (~1.26 ms on an H100
// SXM at 700 W); it now closes its columns at counting barriers, sizes its
// launches for the spine's latency (spine_ctas), and runs its products on
// DMMA: ~1.12 ms.  Folding v's divisions into the fused pass (a lane per
// row of four, by shuffle) was slower: it serialized the divisions.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "fast_gemm.cuh"
#include "grid_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CW = 32;               // inner chunk: one lane per column
constexpr int OB = 128;              // outer block
constexpr int SROW = CW + 1;         // row stride of a slab in shared memory
constexpr int THREADS = 512;         // per CTA of factor_chunk
constexpr int RQ = THREADS / CW;     // warps: rows of the slab passes
constexpr int MAXG = 160;            // most CTAs of factor_chunk
constexpr int MT = (MAXG + RQ - 1) / RQ;
constexpr int MAX_SPLIT_O = 64;      // slices of an outer block's Z_o
constexpr int MAX_SPLIT_I = 256;     // slices of an inner chunk's Z_i
constexpr int MIN_SLICE = 256;       // fewest rows worth a slice

template <typename T>
struct QCfg;
template <>
struct QCfg<float> {
  static constexpr int TM = 8;       // 128 x 128 register tiles
};
template <>
struct QCfg<double> {
  static constexpr int TM = 4;       // 64 x 128
};

// CTAs of factor_chunk for n rows (before the cap): float, one per 64
// rows; double, one per 256 rows but at least 64 (or one per 64 rows).
// The double spine is latency-bound: on an H100 64 CTAs beat 132 at 16384
// rows and 16 or 32 at 4096, 128 beat 66 at 32768 (fewer CTAs to sum and
// to wait for, against a longer pass).
template <typename T>
int spine_ctas(int n) {
  const int by64 = (n + 63) / 64;
  if constexpr (sizeof(T) == 8) {
    const int by256 = (n + 255) / 256;
    return by256 > (by64 < 64 ? by64 : 64) ? by256 : (by64 < 64 ? by64 : 64);
  }
  return by64;
}

template <typename T>
struct Scratch {
  T* part;                           // [2][gmax][CW]
  T* jbuf;                           // [2][CW]
  T* rsave;                          // [CW][CW]
  int gmax;
  unsigned* ctr;                     // double: grid_count_arrive's counter
};

// The barrier that closes a column: float, cooperative_groups'
// grid.sync(); double, the counting barrier of grid_sync.cuh (base: the
// counter's value when the launch starts; target grows by G a barrier).
template <typename T>
__device__ __forceinline__ void column_barrier(cg::grid_group& grid,
                                               const Scratch<T>& sc,
                                               unsigned& target) {
  if constexpr (sizeof(T) == 8) {
    grid_count_arrive(sc.ctr);
    target += gridDim.x;
    grid_count_wait(sc.ctr, target);
  } else {
    grid.sync();
  }
}

// red[q][c] = acc, then the fixed-order sum over q into this CTA's slot of
// the partials of parity par; the owner of row jn publishes its chunk.
template <typename T>
__device__ void publish(T acc, const T* A, long long rs, int cw, int r0,
                        int r1, int jn, int par, const Scratch<T>& sc,
                        T (*red)[CW]) {
  const int tid = threadIdx.x, c = tid % CW, q = tid / CW;
  red[q][c] = acc;
  __syncthreads();
  if (q == 0) {
    T sum = red[0][c];
#pragma unroll
    for (int t = 1; t < RQ; ++t) sum += red[t][c];
    sc.part[((size_t)par * sc.gmax + blockIdx.x) * CW + c] = sum;
    if (jn >= r0 && jn < r1 && c < cw)
      sc.jbuf[par * CW + c] = A[(size_t)(jn - r0) * rs + c];
  }
}

template <typename T, bool IN_SMEM>
__global__ void __launch_bounds__(THREADS)
factor_chunk(T* P, long long ld, int M, int s, int cw, T* tau,
             Scratch<T> sc, unsigned base) {
  cg::grid_group grid = cg::this_grid();
  unsigned target = base;
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int c = tid % CW, q = tid / CW;      // lane = column, warp = rows
  const int rows = M - s;
  const int R = (rows + G - 1) / G;
  const int r0 = s + b * R < M ? s + b * R : M;
  const int r1 = r0 + R < M ? r0 + R : M;        // slab [r0, r1)
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ T red[RQ][CW];
  T* A = IN_SMEM ? reinterpret_cast<T*>(dyn) : P + (size_t)r0 * ld + s;
  const long long rs = IN_SMEM ? SROW : ld;
  if (IN_SMEM)
    for (int idx = tid; idx < (r1 - r0) * cw; idx += THREADS) {
      const int i = idx / cw, cc = idx % cw;
      A[(size_t)i * SROW + cc] = P[(size_t)(r0 + i) * ld + s + cc];
    }
  __syncthreads();
  const bool live = c < cw;                       // lanes past the chunk idle

  // partials of column s: sum_{i > s} A[i][0] A[i][c]
  {
    T acc = T(0);
    const int i0 = r0 > s + 1 ? r0 : s + 1;
    for (int i = i0 + q; i < r1; i += RQ) {
      const T* a = A + (size_t)(i - r0) * rs;
      if (live) acc += a[0] * a[c];
    }
    publish(acc, A, rs, cw, r0, r1, s, 0, sc, red);
  }
  column_barrier(grid, sc, target);
  const int e = s + cw;
  for (int j = s; j < e; ++j) {
    const int par = (j - s) & 1, jc = j - s;
    // fixed-order sum of the G CTAs' partials, the same in every CTA: all
    // loads in flight at once, then a per-column sum over the warps
    {
      T v[MT];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int g = q + t * RQ;
        v[t] = (g < G && live)
                   ? __ldcg(&sc.part[((size_t)par * sc.gmax + g) * CW + c])
                   : T(0);
      }
      T acc = T(0);
#pragma unroll
      for (int t = 0; t < MT; ++t) acc += v[t];
      red[q][c] = acc;
    }
    const T rj = live ? __ldcg(&sc.jbuf[par * CW + c]) : T(0);  // row j
    const T alpha = __ldcg(&sc.jbuf[par * CW + jc]);
    __syncthreads();
    const bool next = j + 1 < e;
    const int jn = jc + 1 < cw ? jc + 1 : jc;       // the next column
    T dc = red[0][c], sigma = red[0][jc], dn = red[0][jn];
#pragma unroll
    for (int t = 1; t < RQ; ++t) {
      dc += red[t][c];
      sigma += red[t][jc];
      dn += red[t][jn];
    }
    const T rn = __ldcg(&sc.jbuf[par * CW + jn]);
    // the larfg scalars, derived redundantly by every thread
    const T anorm = sqrt(alpha * alpha + sigma);
    const T s1 = alpha == T(0) ? T(1) : alpha;
    const T sgn = s1 > T(0) ? T(1) : (s1 < T(0) ? T(-1) : s1);  // NaN stays
    const T beta = -sgn * anorm;
    const bool degenerate = anorm == T(0);
    const T safe_beta = degenerate ? T(1) : beta;
    const T tau_j = degenerate ? T(0) : (safe_beta - alpha) / safe_beta;
    const T denom = alpha - safe_beta;
    const T safe_denom = denom == T(0) ? T(1) : denom;
    const T vj = degenerate ? T(0) : T(1);
    const bool right = live && c > jc;              // columns the step updates
    const T wc = right ? vj * rj + dc / safe_denom : T(0);  // w_c
    if (b == 0 && tid == 0) tau[j] = tau_j;
    // row j: beta on the diagonal, the reflector on its right
    if (q == 0 && j >= r0 && j < r1) {
      T* a = A + (size_t)(j - r0) * rs;
      if (right) a[c] = rj - (tau_j * vj) * wc;
      if (c == jc) a[c] = beta;
    }
    // v_i = x_i / denom below the diagonal, by division as the plain
    // version (one division per row)
    const int i0 = r0 > j + 1 ? r0 : j + 1;
    for (int i = i0 + tid; i < r1; i += THREADS) {
      T* a = A + (size_t)(i - r0) * rs + jc;
      *a = *a / safe_denom;
    }
    __syncthreads();
    // one pass over rows i > j: the reflector on the columns right of j,
    // and the partials of column j + 1 over rows i > j + 1 from the new
    // values.  Every lane recomputes row i's new entry in column j + 1 by
    // the same expression as the lane that owns it (no shuffle, no
    // dependence between rows), with w_{j+1} derived as wc is.
    const T w1 = next ? vj * rn + dn / safe_denom : T(0);  // w_{j+1}
    T acc = T(0);
    for (int i = i0 + q; i < r1; i += 4 * RQ) {
      T x[4], y[4], y1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ii = i + u * RQ;                  // warp-uniform
        const T* a = A + (size_t)(ii - r0) * rs;
        x[u] = ii < r1 ? a[jc] : T(0);              // v_i
        y1[u] = ii < r1 ? a[jn] : T(0);
        y[u] = (ii < r1 && live) ? a[c] : T(0);
      }
      __syncwarp();                                 // loads before stores
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ii = i + u * RQ;
        const T tv = tau_j * x[u];
        y[u] -= tv * wc;
        y1[u] -= tv * w1;
        if (ii < r1 && right) {
          A[(size_t)(ii - r0) * rs + c] = y[u];
          if (next && ii > j + 1) acc += y1[u] * y[u];
        }
      }
    }
    if (next) {
      publish(acc, A, rs, cw, r0, r1, j + 1, par ^ 1, sc, red);
      column_barrier(grid, sc, target);
    }
  }
  __syncthreads();
  // write back; rows [s, e) keep V's unit upper part, R's triangle aside
  for (int idx = tid; idx < (r1 - r0) * cw; idx += THREADS) {
    const int i = r0 + idx / cw, cc = idx % cw, ii = i - s;
    T* a = A + (size_t)(i - r0) * rs + cc;
    T val = *a;
    const bool upper = ii < cw && cc >= ii;
    if (upper) {
      sc.rsave[ii * CW + cc] = val;
      val = cc == ii ? T(1) : T(0);
    }
    if (IN_SMEM)
      P[(size_t)i * ld + s + cc] = val;
    else if (upper)
      *a = val;
  }
}

// C (M x N, leading dimension ldc) = A B (MODE 0), -= A B (MODE 1) or
// = -A B (MODE 2), on the register tiles of fast_gemm.cuh.  blockIdx.z
// takes the k-range [z D, min((z + 1) D, K)) and writes its own C at
// C + z cstride (a slice of a split reduction, MODE 0).
template <typename T, int MODE, int TM>
__global__ void __launch_bounds__(FG_THREADS, 2)
fgemm_kernel(Op<T> A, Op<T> B, T* C, long long ldc, int M, int N, int K,
             int D, long long cstride, int vec, int cvec) {
  constexpr int BM = 16 * TM;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * FG_BN;
  const int k0 = blockIdx.z * D;
  const int kn = K - k0 < D ? K - k0 : D;
  Op<T> a = A, bb = B;
  a.p += A.kmajor ? (size_t)k0 * A.ld + row0 : (size_t)row0 * A.ld + k0;
  bb.p += B.kmajor ? (size_t)k0 * B.ld + col0 : (size_t)col0 * B.ld + k0;
  T acc[TM][8];
  tile_zero(acc);
  const int m = M - row0 < BM ? M - row0 : BM;
  const int n = N - col0 < FG_BN ? N - col0 : FG_BN;
  tile_mma<T, TM>(acc, a, m, bb, n, kn, vec != 0, reinterpret_cast<T*>(dyn));
  T* out = C + blockIdx.z * cstride + (size_t)row0 * ldc + col0;
  // a thread's columns come in runs of 4: 16-byte loads and stores of C
  // (cvec: C and its strides are aligned); every old value is loaded
  // before any store, so the loads stay in flight together
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tile_row(i);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int cc = tile_col(4 * g);
      if (MODE == 1) {
        T v[4];
        fg_ld4(out + (size_t)r * ldc + cc, cvec != 0, r < m ? n - cc : 0, v);
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[i][4 * g + t] = v[t] - acc[i][4 * g + t];
      } else if (MODE == 2) {
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[i][4 * g + t] = -acc[i][4 * g + t];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tile_row(i);
    if (r >= m) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int cc = tile_col(4 * g);
      T v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = acc[i][4 * g + t];
      fg_st4(out + (size_t)r * ldc + cc, cvec != 0, n - cc, v);
    }
  }
}

// fgemm_kernel of the float64 route: the same contract on the FP64 tensor
// cores (DMMA), 64 x 128 tiles of fast_gemm.cuh's dm_tile_mma (32-deep
// k-tiles staged by cp.async, two in flight).  Each thread's outputs come
// in pairs of adjacent columns: 16-byte loads and stores when cvec.
template <int MODE>
__global__ void __launch_bounds__(FG_THREADS)
dm_fgemm_kernel(Op<double> A, Op<double> B, double* C, long long ldc, int M,
                int N, int K, int D, long long cstride, int vec, int cvec) {
  constexpr int TN = 8, NI = TN / 2;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int row0 = blockIdx.y * DM_BM, col0 = blockIdx.x * FG_BN;
  const int k0 = blockIdx.z * D;
  const int kn = K - k0 < D ? K - k0 : D;
  Op<double> a = A, bb = B;
  a.p += A.kmajor ? (size_t)k0 * A.ld + row0 : (size_t)row0 * A.ld + k0;
  bb.p += B.kmajor ? (size_t)k0 * B.ld + col0 : (size_t)col0 * B.ld + k0;
  const int m = M - row0 < DM_BM ? M - row0 : DM_BM;
  const int n = N - col0 < FG_BN ? N - col0 : FG_BN;
  double acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][ni][v] = 0.0;
  dm_tile_mma<TN>(acc, a, m, bb, n, kn, vec != 0,
                  reinterpret_cast<double*>(dyn));
  double* out = C + blockIdx.z * cstride + (size_t)row0 * ldc + col0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = dm_row(mi, h), c = dm_col<TN>(ni);
        double v[2] = {acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]};
        if (MODE == 1) {
          double old[2];
          dm_ld2(out + (size_t)r * ldc + c, cvec != 0, r < m ? n - c : 0, old);
          v[0] = old[0] - v[0];
          v[1] = old[1] - v[1];
        } else if (MODE == 2) {
          v[0] = -v[0];
          v[1] = -v[1];
        }
        if (r < m) dm_st2(out + (size_t)r * ldc + c, cvec != 0, n - c, v);
      }
}

// Z[i][j] (leading dimension ldz) = sum over the slices z of
// Zpart[z][i][j] (m x n each), z in order.
template <typename T>
__global__ void sum_slices_kernel(const T* Zpart, int slices, long long zs,
                                  int m, int n, int ldz, T* Z) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)m * n) return;
  const int i = (int)(idx / n), j = (int)(idx % n);
  T sum = T(0);
  for (int z = 0; z < slices; ++z) sum += Zpart[z * zs + (size_t)i * n + j];
  Z[(size_t)i * ldz + j] = sum;
}

// T_cc from the chunk's gram G (cw x cw at Z, leading dimension ldz) and
// tau[s:s+cw] by larft's forward column recurrence: T_cc[:i, i] = -tau_i
// T_cc[:i, :i] G[:i, i], T_cc[i][i] = tau_i; into the upper triangle of
// T[s:e, s:e].  The gram and tau are staged in shared memory first (one
// round trip to L2, not one per step).
template <typename T>
__global__ void __launch_bounds__(CW)
tblock_kernel(const T* Z, int ldz, int s, int cw, const T* tau, T* Tm,
              int ldt) {
  __shared__ T Tc[CW][CW + 1];
  __shared__ T Gs[CW][CW + 1];
  __shared__ T ts[CW];
  const int r = threadIdx.x;
  T g[CW];
#pragma unroll
  for (int cc = 0; cc < CW; ++cc)
    g[cc] = (r < cw && cc < cw) ? Z[(size_t)cc * ldz + r] : T(0);
#pragma unroll
  for (int cc = 0; cc < CW; ++cc) {
    Gs[cc][r] = g[cc];
    Tc[r][cc] = T(0);
  }
  ts[r] = r < cw ? tau[s + r] : T(0);
  __syncthreads();
  for (int i = 0; i < cw; ++i) {
    const T ti = ts[i];
    if (r < i) {
      T acc = T(0);
      for (int cc = r; cc < i; ++cc) acc += Tc[r][cc] * Gs[cc][i];
      Tc[r][i] = -ti * acc;
    } else if (r == i) {
      Tc[i][i] = ti;
    }
    __syncthreads();
  }
  if (r < cw)
    for (int cc = r; cc < cw; ++cc) Tm[(size_t)(s + r) * ldt + s + cc] = Tc[r][cc];
}

// The n x n upper triangle of rows [s, s + n) (columns from s) into save,
// replaced by V's unit upper part (1 on the diagonal, 0 above).
template <typename T>
__global__ void save_unit_upper(T* P, long long ld, int s, int n, T* save) {
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n * n;
       idx += gridDim.x * blockDim.x) {
    const int ii = idx / n, cc = idx % n;
    if (cc < ii) continue;
    T* p = P + (size_t)(s + ii) * ld + s + cc;
    save[idx] = *p;
    *p = cc == ii ? T(1) : T(0);
  }
}

// The triangle kept in save (n x n, leading dimension lds) back into rows
// [s, s + n).
template <typename T>
__global__ void restore_r(T* P, long long ld, int s, int n, const T* save,
                          int lds) {
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n * n;
       idx += gridDim.x * blockDim.x) {
    const int ii = idx / n, cc = idx % n;
    if (cc >= ii) P[(size_t)(s + ii) * ld + s + cc] = save[ii * lds + cc];
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Slices of a tall reduction of K rows onto an m x n output: as many
// tiles as two CTAs per SM hold in one wave (a second, partial wave would
// double the time), each slice at least MIN_SLICE rows.
template <int TM>
int split_count(int K, int m, int n, int sms, int max_split) {
  const int tiles = ceil_div(m, 16 * TM) * ceil_div(n, FG_BN);
  int s = 2 * sms / tiles;
  const int by_rows = ceil_div(K, MIN_SLICE);
  if (s > by_rows) s = by_rows;
  if (s > max_split) s = max_split;
  return s < 1 ? 1 : s;
}

// Scratch layout (T): part[2][gmax][CW] | jbuf[2][CW] | rsave[CW][CW] |
// rsave_o[OB][OB] | zi[CW][OB] | yi[CW][OB] | zo[OB][k] | yo[OB][k] |
// zpart[max(MAX_SPLIT_O OB k, MAX_SPLIT_I CW OB)].
long long scratch_elems(int M, int k, int gmax) {
  (void)M;
  const long long zo = (long long)MAX_SPLIT_O * OB * k;
  const long long zi = (long long)MAX_SPLIT_I * CW * OB;
  const long long zp = zo > zi ? zo : zi;
  return 2LL * gmax * CW + 2LL * CW + (long long)CW * CW + (long long)OB * OB
         + 2LL * CW * OB + 2LL * OB * k + zp + 1;
}

template <typename T, int MODE, int TM = QCfg<T>::TM>
cudaError_t fgemm(cudaStream_t st, Op<T> A, Op<T> B, T* C, long long ldc,
                  int M, int N, int K, int split = 1, long long cstride = 0) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaSuccess;
  constexpr int BM = 16 * TM;
  int D = ceil_div(K, split);
  D = ceil_div(D, FgCfg<T>::BK) * FgCfg<T>::BK;
  const int slices = ceil_div(K, D);
  const int vec = fg_aligned(A.p, A.ld) && fg_aligned(B.p, B.ld);
  const int cvec = fg_aligned(C, ldc) && (cstride * (long long)sizeof(T)) % 16 == 0;
  if constexpr (sizeof(T) == 8) {
    constexpr size_t smem = dm_long_smem_bytes<8>();
    cudaError_t err = cudaFuncSetAttribute(
        dm_fgemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    dm_fgemm_kernel<MODE><<<dim3(ceil_div(N, FG_BN), ceil_div(M, DM_BM),
                                 slices),
                            FG_THREADS, smem, st>>>(A, B, C, ldc, M, N, K, D,
                                                    cstride, vec, cvec);
  } else {
    fgemm_kernel<T, MODE, TM><<<dim3(ceil_div(N, FG_BN), ceil_div(M, BM),
                                     slices),
                                FG_THREADS, fg_smem_bytes<T, TM>(), st>>>(
        A, B, C, ldc, M, N, K, D, cstride, vec, cvec);
  }
  return cudaGetLastError();
}

// Z (m x n, leading dimension ldz) = A^T B over K rows: A (K x m) and B
// (K x n) both row-major; split over the rows, slices summed in order.
template <typename T, int TM>
cudaError_t gemm_tn(cudaStream_t st, const T* A, long long lda, const T* B,
                    long long ldb, int K, int m, int n, T* zpart, T* Z,
                    int ldz, int sms, int max_split) {
  if (n <= 0) return cudaSuccess;
  const int split = split_count<TM>(K, m, n, sms, max_split);
  int D = ceil_div(K, split);
  D = ceil_div(D, FgCfg<T>::BK) * FgCfg<T>::BK;
  const int slices = ceil_div(K, D);
  const long long zs = (long long)m * n;
  cudaError_t err = fgemm<T, 0, TM>(st, Op<T>{A, lda, 1}, Op<T>{B, ldb, 1},
                                    zpart, n, m, n, K, slices, zs);
  if (err != cudaSuccess) return err;
  sum_slices_kernel<T><<<ceil_div(zs, 256), 256, 0, st>>>(zpart, slices, zs,
                                                          m, n, ldz, Z);
  return cudaGetLastError();
}

template <typename T>
int qr_panel(T* P, long long ld, int M, int k, T* tau, T* Tm, T* ws,
             int gmax, cudaStream_t st) {
  if (k <= 0 || M < k || gmax < 1) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, smem_max = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&smem_max,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess)
    return err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, factor_chunk<T, true>)) != cudaSuccess)
    return err;
  const int dyn_max = smem_max - (int)fa.sharedSizeBytes;
  if ((err = cudaFuncSetAttribute(factor_chunk<T, true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dyn_max)) != cudaSuccess)
    return err;
  // at most one CTA per SM: every CTA is resident, as grid.sync() needs
  int cap = gmax < sms ? gmax : sms;
  cap = cap < MAXG ? cap : MAXG;
  Scratch<T> sc{ws, ws + 2 * (size_t)gmax * CW,
                ws + 2 * (size_t)gmax * CW + 2 * CW, gmax,
                reinterpret_cast<unsigned*>(ws + scratch_elems(M, k, gmax) - 1)};
  unsigned base = 0;                   // double: the barrier counter so far
  if constexpr (sizeof(T) == 8)
    if ((err = cudaMemsetAsync(sc.ctr, 0, sizeof(unsigned), st)) != cudaSuccess)
      return err;
  T* rsave_o = sc.rsave + CW * CW;
  T* zi = rsave_o + OB * OB;
  T* yi = zi + CW * OB;
  T* zo = yi + CW * OB;
  T* yo = zo + (size_t)OB * k;
  T* zpart = yo + (size_t)OB * k;
  const long long ldt = k;
  for (int so = 0; so < k; so += OB) {
    const int ob = OB < k - so ? OB : k - so;
    const int eo = so + ob;
    for (int s = so; s < eo; s += CW) {
      const int cw = CW < eo - s ? CW : eo - s;
      const int e = s + cw;
      int G = spine_ctas<T>(M - s);
      G = G < cap ? G : cap;
      const size_t slab = (size_t)ceil_div(M - s, G) * SROW * sizeof(T);
      const bool in_smem = slab <= (size_t)dyn_max;
      const void* fn = in_smem ? (const void*)factor_chunk<T, true>
                               : (const void*)factor_chunk<T, false>;
      const size_t dyn = in_smem ? slab : 0;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, fn, THREADS, dyn)) != cudaSuccess)
        return err;
      if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
      void* args[] = {&P, &ld, &M, &s, (void*)&cw, &tau, &sc, &base};
      err = cudaLaunchCooperativeKernel(fn, G, THREADS, args, dyn, st);
      if (err != cudaSuccess) return err;
      base += (unsigned)G * (unsigned)cw;     // the launch's barriers
      // Z_i = V_c^T P[s:M, so:eo]
      T* Vc = P + (size_t)s * ld + s;
      err = gemm_tn<T, 4>(st, Vc, ld, P + (size_t)s * ld + so, ld, M - s, cw,
                          ob, zpart, zi, ob, sms, MAX_SPLIT_I);
      if (err != cudaSuccess) return err;
      tblock_kernel<T><<<1, CW, 0, st>>>(zi + (s - so), ob, s, cw, tau, Tm,
                                         k);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      // Y_i = T_cc^T Z_i (T_cc^T read k-major from T)
      const T* Tcc = Tm + (size_t)s * ldt + s;
      err = fgemm<T, 0, 4>(st, Op<T>{Tcc, ldt, 1}, Op<T>{zi, ob, 1}, yi, ob,
                           cw, ob, cw);
      if (err != cudaSuccess) return err;
      // T[so:s, s:e] = -T[so:s, so:s] Y_i[:, :s-so]^T
      err = fgemm<T, 2, 4>(st, Op<T>{Tm + (size_t)so * ldt + so, ldt, 0},
                           Op<T>{yi, ob, 0}, Tm + (size_t)so * ldt + s, ldt,
                           s - so, cw, s - so);
      if (err != cudaSuccess) return err;
      // P[s:M, e:eo] -= V_c Y_i[:, e-so:]
      err = fgemm<T, 1>(st, Op<T>{Vc, ld, 0}, Op<T>{yi + (e - so), ob, 1},
                        P + (size_t)s * ld + e, ld, M - s, eo - e, cw);
      if (err != cudaSuccess) return err;
      restore_r<T><<<4, 256, 0, st>>>(P, ld, s, cw, sc.rsave, CW);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (so == 0 && eo == k) break;              // one outer block: done
    save_unit_upper<T><<<16, 256, 0, st>>>(P, ld, so, ob, rsave_o);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // Z_o = V_o^T P[so:M, 0:k], but for columns [so, eo) (V_o^T V_o: T_oo
    // came from the inner grams); Y_o's columns there are not used
    T* Vo = P + (size_t)so * ld + so;
    err = gemm_tn<T, QCfg<T>::TM>(st, Vo, ld, P + (size_t)so * ld, ld,
                                  M - so, ob, so, zpart, zo, k, sms,
                                  MAX_SPLIT_O);
    if (err != cudaSuccess) return err;
    err = gemm_tn<T, QCfg<T>::TM>(st, Vo, ld, P + (size_t)so * ld + eo, ld,
                                  M - so, ob, k - eo, zpart, zo + eo, k, sms,
                                  MAX_SPLIT_O);
    if (err != cudaSuccess) return err;
    // Y_o = T_oo^T Z_o
    err = fgemm<T, 0>(st, Op<T>{Tm + (size_t)so * ldt + so, ldt, 1},
                      Op<T>{zo, k, 1}, yo, k, ob, k, ob);
    if (err != cudaSuccess) return err;
    // T[:so, so:eo] = -T[:so, :so] Y_o[:, :so]^T
    err = fgemm<T, 2, 4>(st, Op<T>{Tm, ldt, 0}, Op<T>{yo, k, 0}, Tm + so,
                         ldt, so, ob, so);
    if (err != cudaSuccess) return err;
    // P[so:M, eo:k] -= V_o Y_o[:, eo:]
    err = fgemm<T, 1>(st, Op<T>{Vo, ld, 0}, Op<T>{yo + eo, k, 1},
                      P + (size_t)so * ld + eo, ld, M - so, k - eo, ob);
    if (err != cudaSuccess) return err;
    restore_r<T><<<16, 256, 0, st>>>(P, ld, so, ob, rsave_o, ob);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// C entry points (loaded with ctypes).  P is the (M, k) panel, row-major
// with leading dimension ld (elements), factored in place into the packed
// V\R; tau (k) and T (k x k, zero on entry) receive tau and the upper
// triangle of T.  ws holds qr_panel_scratch(M, k, gmax) elements of the
// panel's type; gmax bounds the CTAs of a cooperative launch.
extern "C" long long qr_panel_scratch(int M, int k, int gmax) {
  return scratch_elems(M, k, gmax);
}

extern "C" int qr_panel_f32(void* P, long long ld, int M, int k, void* tau,
                            void* T, void* ws, int gmax, void* stream) {
  return qr_panel<float>(static_cast<float*>(P), ld, M, k,
                         static_cast<float*>(tau), static_cast<float*>(T),
                         static_cast<float*>(ws), gmax,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int qr_panel_f64(void* P, long long ld, int M, int k, void* tau,
                            void* T, void* ws, int gmax, void* stream) {
  return qr_panel<double>(static_cast<double*>(P), ld, M, k,
                          static_cast<double*>(tau), static_cast<double*>(T),
                          static_cast<double*>(ws), gmax,
                          static_cast<cudaStream_t>(stream));
}
