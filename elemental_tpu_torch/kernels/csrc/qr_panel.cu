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
// function blocked inside the panel: (packed V\R, tau, T) as the plain
// version _panel_qr + _larft(_panel_v(packed), tau) gives them, up to
// rounding, with the same larfg guards (anorm == 0 gives tau = 0 and
// beta = -0; beta = -sign(alpha) anorm with alpha = 0 taken as +; a zero
// denominator is replaced by 1; sigma is a plain sum of squares).
//
// Per chunk of cw <= CW = 64 columns [s, e), on the caller's stream:
//
//   factor_chunk   ONE cooperative launch (cudaLaunchCooperativeKernel, at
//                  most one CTA per SM, all resident).  CTA b owns a slab
//                  of rows of [s, M), in shared memory when it fits, else
//                  worked on in place in device memory.  For column j the
//                  step needs two sums over all rows below j: sigma =
//                  sum x_i^2 and the row dots w_l = v^T P[:, l].  With
//                  v_i = x_i / denom, w_l = P_jl + (sum_{i>j} x_i P_il) /
//                  denom, and sigma is the dot with l = j, so ONE set of
//                  per-CTA partials d_l = sum x_i P_il (l in [j, e)) feeds
//                  both.  Per column:
//                    - every CTA sums the G CTAs' partials in a fixed
//                      order, so every CTA derives the same beta, tau and
//                      denom; row j's chunk was published by its owner;
//                    - v = x / denom below the diagonal, then the
//                      reflector on the chunk's columns right of j:
//                      P_il -= (tau v_i) w_l; row j takes beta;
//                    - the partials of column j + 1 and row j + 1's chunk
//                      are published into the other parity of the
//                      double-buffered scratch; one grid.sync().
//                  At the end the chunk's rows [s, e) hold V's unit upper
//                  part (1 on the diagonal, 0 above), R's triangle is kept
//                  aside, and tau[s:e] is written.
//   gemm_tn_kernel Z = V_c^T P[s:M, 0:k], a reduction over the M - s rows
//                  split into slices (one partial tile per CTA), then
//                  sum_slices_kernel adds the slices in a fixed order.
//                  Z[:, :s] = (V[:, :s]^T V_c)^T, Z[:, s:e] = V_c^T V_c
//                  and Z[:, e:] = V_c^T P[:, e:].
//   tblock_kernel  T_cc, larft's recurrence on V_c^T V_c and tau[s:e], into
//                  T[s:e, s:e], and T_cc^T into scratch.
//   gemm_kernel    Y = T_cc^T Z, then T[:s, s:e] = -T[:s, :s] Y[:, :s]^T
//                  (= -T11 V1^T V_c T_cc, larft's off-diagonal block).
//   gemm128_kernel P[s:M, e:k] -= V_c Y[:, e:], the block reflector
//                  (I - V_c T_cc V_c^T)^T applied to the rest of the panel.
//   restore_r      R's triangle back into rows [s, e).
//
// The GEMMs are those of tiled_gemm.cuh and gemm_tn_kernel below, all with
// full-precision FMA.  Nothing is allocated here (the wrapper passes the
// outputs and the scratch), nothing synchronizes with the host, and no
// library is called.  Each entry point returns the first cudaError_t that
// is not cudaSuccess.
//
// Bound.  The least work is 2 M k^2 - 2 k^3 / 3 flops for the reflectors,
// M k^2 - 2 k^3 / 3 for V^T V's upper half (V is unit lower trapezoidal,
// so column j's dots run over rows >= j only) and k^3 / 3 for T's
// triangular products: 3 M k^2 - k^3 in all, against M k elements read
// and M k + k^2 + k written.  At M = 65536, k = 2048 float: 8.2e11
// flop, ~12.2 ms at the data-sheet 67 TFLOP/s FP32, against 1.1 GB,
// ~0.33 ms at 3.35 TB/s: compute-bound.  This first design is bound
// instead by its serial spine (k dependent column steps, each a grid
// barrier plus dependent reads of the partials from L2) and by the
// CUDA-core GEMMs (Z and the block-reflector update stream the panel
// once per chunk).  Tensor-core (DMMA / 3xTF32) products, a deeper chunk
// recursion and a cheaper exchange than grid.sync() are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "tiled_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CW = 64;               // widest chunk
constexpr int SROW = CW + 1;         // row stride of a slab in shared memory
constexpr int THREADS = 256;         // per CTA of factor_chunk
constexpr int RQ = THREADS / CW;     // row groups of the per-column passes
constexpr int ROWS_PER_CTA = 64;     // fewest rows worth a CTA

// gemm_tn_kernel: 64 x 128 output tiles, 8-deep k-tiles double buffered in
// shared memory, 8 x 8 register blocks per thread.
constexpr int TBM = 64, TBN = 128, TBK = 8, TTHREADS = 128;
constexpr int MAX_SPLIT = 64;        // slices of the Z reduction
constexpr int MIN_SLICE = 256;       // fewest rows worth a slice

// Scratch layout (T): part[2][gmax][CW] | jbuf[2][CW] | rsave[CW][CW] |
// tt[CW][CW] | z[CW][k] | y[CW][k] | zpart[split][CW][k].
template <typename T>
struct Scratch {
  T* part;
  T* jbuf;
  T* rsave;
  int gmax;
};

// This CTA's partials d_c = sum_{i in slab, i > jn} A[i][jn - s] A[i][c]
// for c in [jn - s, cw), into parity par; the owner of row jn also
// publishes row jn's chunk.  Entry (i, c) of the chunk, r0 <= i < r1, is
// A[(i - r0) rs + c].
template <typename T>
__device__ void publish_partials(const T* A, long long rs, int s, int cw,
                                 int r0, int r1, int jn, int par,
                                 const Scratch<T>& sc, T (*red)[CW]) {
  const int tid = threadIdx.x, c = tid % CW, q = tid / CW;
  const int jc = jn - s;
  T acc = T(0);
  if (c >= jc && c < cw) {
    const int i0 = r0 > jn + 1 ? r0 : jn + 1;
    for (int i = i0 + q; i < r1; i += RQ) {
      const T* a = A + (size_t)(i - r0) * rs;
      acc += a[jc] * a[c];
    }
  }
  red[q][c] = acc;
  __syncthreads();
  if (q == 0) {
    T sum = red[0][c];
#pragma unroll
    for (int t = 1; t < RQ; ++t) sum += red[t][c];
    sc.part[((size_t)par * sc.gmax + blockIdx.x) * CW + c] = sum;
  }
  if (jn >= r0 && jn < r1)
    for (int cc = tid; cc < cw; cc += THREADS)
      sc.jbuf[par * CW + cc] = A[(size_t)(jn - r0) * rs + cc];
  __syncthreads();          // red is reused by the caller
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
factor_chunk(T* P, long long ld, int M, int s, int cw, int in_smem, T* tau,
             Scratch<T> sc) {
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int c = tid % CW, q = tid / CW;
  const int rows = M - s;
  const int R = (rows + G - 1) / G;
  const int r0 = s + b * R < M ? s + b * R : M;
  const int r1 = r0 + R < M ? r0 + R : M;        // slab [r0, r1)
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ T red[RQ][CW];
  __shared__ T dsum[CW];                         // the column's full sums
  __shared__ T rsh[CW];                          // row j's chunk
  __shared__ T wsh[CW];                          // w_l
  T* A = in_smem ? reinterpret_cast<T*>(dyn) : P + (size_t)r0 * ld + s;
  const long long rs = in_smem ? SROW : ld;
  if (in_smem)
    for (int idx = tid; idx < (r1 - r0) * cw; idx += THREADS) {
      const int i = idx / cw, cc = idx % cw;
      A[(size_t)i * SROW + cc] = P[(size_t)(r0 + i) * ld + s + cc];
    }
  __syncthreads();

  publish_partials(A, rs, s, cw, r0, r1, s, 0, sc, red);
  grid.sync();
  const int e = s + cw;
  for (int j = s; j < e; ++j) {
    const int par = (j - s) & 1, jc = j - s;
    // fixed-order sum of the G CTAs' partials, the same in every CTA
    T acc = T(0);
    if (c >= jc && c < cw)
      for (int g = q; g < G; g += RQ)
        acc += __ldcg(&sc.part[((size_t)par * sc.gmax + g) * CW + c]);
    red[q][c] = acc;
    if (tid < cw) rsh[tid] = __ldcg(&sc.jbuf[par * CW + tid]);
    __syncthreads();
    if (q == 0) {
      T sum = red[0][c];
#pragma unroll
      for (int t = 1; t < RQ; ++t) sum += red[t][c];
      dsum[c] = sum;
    }
    __syncthreads();
    // the larfg scalars, derived redundantly by every thread
    const T alpha = rsh[jc], sigma = dsum[jc];
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
    if (q == 0 && c > jc && c < cw) wsh[c] = vj * rsh[c] + dsum[c] / safe_denom;
    if (b == 0 && tid == 0) tau[j] = tau_j;
    // v below the diagonal, by division as the plain version
    const int i0 = r0 > j + 1 ? r0 : j + 1;
    for (int i = i0 + tid; i < r1; i += THREADS) {
      T* a = A + (size_t)(i - r0) * rs + jc;
      *a = *a / safe_denom;
    }
    __syncthreads();
    // H_j^H on the chunk's columns right of j
    if (c > jc && c < cw) {
      const T wc = wsh[c];
      for (int i = i0 + q; i < r1; i += RQ) {
        T* a = A + (size_t)(i - r0) * rs;
        a[c] -= (tau_j * a[jc]) * wc;
      }
      if (q == 0 && j >= r0 && j < r1)
        A[(size_t)(j - r0) * rs + c] -= (tau_j * vj) * wc;
    }
    if (tid == 0 && j >= r0 && j < r1) A[(size_t)(j - r0) * rs + jc] = beta;
    __syncthreads();
    if (j + 1 < e) {
      publish_partials(A, rs, s, cw, r0, r1, j + 1, par ^ 1, sc, red);
      grid.sync();
    }
  }
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
    if (in_smem)
      P[(size_t)i * ld + s + cc] = val;
    else if (upper)
      *a = val;
  }
}

// Zpart[z] = A[rows of slice z]^T B[rows of slice z]: A is (K x m), m <= 64,
// B is (K x n), both row-major; slice z covers rows [z D, min((z+1) D, K)).
// Thread (ty, tx) of the 8 x 16 layout owns rows {ty*4 + i, 32 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j}, i, j < 4, of the 64 x 128 tile.
template <typename T>
__global__ void __launch_bounds__(TTHREADS)
gemm_tn_kernel(const T* A, long long lda, const T* B, long long ldb, int K,
               int m, int n, int D, T* Zpart, int ldz) {
  const int col0 = blockIdx.x * TBN, z = blockIdx.y;
  const int k0s = z * D, k1 = k0s + D < K ? k0s + D : K;
  __shared__ T As[2][TBK][TBM];
  __shared__ T Bs[2][TBK][TBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // loads: A as 8 rows x 16 runs of 4, B as 8 rows x 16 runs of 8
  const int lk = tid / 16, la = (tid % 16) * 4, lb = (tid % 16) * 8;
  T ra[4], rb[8];
  auto fetch = [&](int k0) {
    const int kk = k0 + lk;
    const bool in = kk < k1;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      ra[t] = (in && la + t < m) ? A[(size_t)kk * lda + la + t] : T(0);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      rb[t] = (in && col0 + lb + t < n) ? B[(size_t)kk * ldb + col0 + lb + t]
                                        : T(0);
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int t = 0; t < 4; ++t) As[buf][lk][la + t] = ra[t];
#pragma unroll
    for (int t = 0; t < 8; ++t) Bs[buf][lk][lb + t] = rb[t];
  };
  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
  fetch(k0s);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = k0s; k0 < k1; k0 += TBK) {
    const bool more = k0 + TBK < k1;
    if (more) fetch(k0 + TBK);
#pragma unroll
    for (int kk = 0; kk < TBK; ++kk) {
      T a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[buf][kk][ty * 4 + i];
        a[4 + i] = As[buf][kk][32 + ty * 4 + i];
        bv[i] = Bs[buf][kk][tx * 4 + i];
        bv[4 + i] = Bs[buf][kk][64 + tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * bv[j];
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  T* out = Zpart + (size_t)z * CW * ldz;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4;
    if (gi >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gj = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gj < n) out[(size_t)gi * ldz + gj] = acc[i][j];
    }
  }
}

// Z[i][j] = sum over the slices z of Zpart[z][i][j], z in order.
template <typename T>
__global__ void sum_slices_kernel(const T* Zpart, int slices, int m, int n,
                                  int ldz, T* Z) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m * n) return;
  const int i = idx / n, j = idx % n;
  T sum = T(0);
  for (int z = 0; z < slices; ++z)
    sum += Zpart[((size_t)z * CW + i) * ldz + j];
  Z[(size_t)i * ldz + j] = sum;
}

// T_cc from the chunk's Gram Z[:, s:s+cw] and tau[s:s+cw] by larft's
// forward column recurrence: T_cc[:i, i] = -tau_i T_cc[:i, :i] G[:i, i],
// T_cc[i][i] = tau_i.  Writes the upper triangle of T[s:e, s:e] and the
// whole T_cc^T into tt (leading dimension CW).
template <typename T>
__global__ void __launch_bounds__(CW)
tblock_kernel(const T* Z, int ldz, int s, int cw, const T* tau, T* Tm,
              int ldt, T* tt) {
  __shared__ T Tc[CW][CW + 1];
  const int r = threadIdx.x;
  for (int cc = 0; cc < CW; ++cc) Tc[r][cc] = T(0);
  __syncthreads();
  for (int i = 0; i < cw; ++i) {
    const T ti = tau[s + i];
    if (r < i) {
      T acc = T(0);
      for (int cc = r; cc < i; ++cc) acc += Tc[r][cc] * Z[(size_t)cc * ldz + s + i];
      Tc[r][i] = -ti * acc;
    } else if (r == i) {
      Tc[i][i] = ti;
    }
    __syncthreads();
  }
  if (r < cw)
    for (int cc = 0; cc < cw; ++cc) {
      if (cc >= r) Tm[(size_t)(s + r) * ldt + s + cc] = Tc[r][cc];
      tt[cc * CW + r] = Tc[r][cc];
    }
}

// R's triangle of the chunk back into rows [s, s + cw).
template <typename T>
__global__ void restore_r(T* P, long long ld, int s, int cw, const T* rsave) {
  for (int idx = threadIdx.x; idx < cw * cw; idx += blockDim.x) {
    const int ii = idx / cw, cc = idx % cw;
    if (cc >= ii) P[(size_t)(s + ii) * ld + s + cc] = rsave[ii * CW + cc];
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Slices of the Z reduction: enough tiles to fill the card twice, each
// slice at least MIN_SLICE rows.
int split_count(int M, int k, int gmax) {
  int s = ceil_div(2LL * gmax, ceil_div(k, TBN));
  const int by_rows = ceil_div(M, MIN_SLICE);
  if (s > by_rows) s = by_rows;
  if (s > MAX_SPLIT) s = MAX_SPLIT;
  return s < 1 ? 1 : s;
}

long long scratch_elems(int M, int k, int gmax) {
  return 2LL * gmax * CW + 2LL * CW + 2LL * CW * CW
         + (2LL + split_count(M, k, gmax)) * CW * k;
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
  if ((err = cudaFuncGetAttributes(&fa, factor_chunk<T>)) != cudaSuccess)
    return err;
  const int dyn_max = smem_max - (int)fa.sharedSizeBytes;
  if ((err = cudaFuncSetAttribute(factor_chunk<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dyn_max)) != cudaSuccess)
    return err;
  // at most one CTA per SM: every CTA is resident, as grid.sync() needs
  const int cap = gmax < sms ? gmax : sms;
  const int split = split_count(M, k, gmax);
  Scratch<T> sc{ws, ws + 2 * (size_t)gmax * CW,
                ws + 2 * (size_t)gmax * CW + 2 * CW, gmax};
  T* tt = sc.rsave + CW * CW;
  T* z = tt + CW * CW;
  T* y = z + (size_t)CW * k;
  T* zpart = y + (size_t)CW * k;
  for (int s = 0; s < k; s += CW) {
    const int cw = CW < k - s ? CW : k - s;
    const int e = s + cw;
    int G = ceil_div(M - s, ROWS_PER_CTA);
    G = G < cap ? G : cap;
    const size_t slab = (size_t)ceil_div(M - s, G) * SROW * sizeof(T);
    int in_smem = slab <= (size_t)dyn_max;
    const size_t dyn = in_smem ? slab : 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, factor_chunk<T>, THREADS, dyn)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&P, &ld, &M, &s, (void*)&cw, &in_smem, &tau, &sc};
    err = cudaLaunchCooperativeKernel((const void*)factor_chunk<T>, G,
                                      THREADS, args, dyn, st);
    if (err != cudaSuccess) return err;
    // Z = V_c^T P[s:M, 0:k], split over the rows, slices summed in order
    const int K = M - s;
    int D = ceil_div(K, split);
    D = ceil_div(D, TBK) * TBK;
    const int slices = ceil_div(K, D);
    gemm_tn_kernel<T><<<dim3(ceil_div(k, TBN), slices), TTHREADS, 0, st>>>(
        P + (size_t)s * ld + s, ld, P + (size_t)s * ld, ld, K, cw, k, D,
        zpart, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sum_slices_kernel<T><<<ceil_div((long long)cw * k, 256), 256, 0, st>>>(
        zpart, slices, cw, k, k, z);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    tblock_kernel<T><<<1, CW, 0, st>>>(z, k, s, cw, tau, Tm, k, tt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // Y = T_cc^T Z
    const Gemm<T> ymul{cw, k, cw, T(1), tt, CW, z, k, T(0), y, k, 0, 0};
    const Gemm<T> none{0, 0, 0, T(0), nullptr, 0, nullptr, 0, T(0), nullptr,
                       0, 0, 0};
    if ((err = gemm2<T>(st, ymul, none)) != cudaSuccess) return err;
    if (s > 0) {
      // T[:s, s:e] = -T[:s, :s] Y[:, :s]^T
      const Gemm<T> off{s, cw, s, T(-1), Tm, k, y, k, T(0), Tm + s, k, 1, 0};
      if ((err = gemm2<T>(st, off, none)) != cudaSuccess) return err;
    }
    if (e < k) {
      // P[s:M, e:k] -= V_c Y[:, e:]
      const Gemm<T> upd{M - s, k - e, cw, T(-1), P + (size_t)s * ld + s,
                        (int)ld, y + e, k, T(1), P + (size_t)s * ld + e,
                        (int)ld, 0, 0};
      if ((err = gemm128<T>(st, upd)) != cudaSuccess) return err;
    }
    restore_r<T><<<1, 256, 0, st>>>(P, ld, s, cw, sc.rsave);
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
