// lu_panel: partial-pivot LU of an (M, nbw) panel, M >= nbw, for Hopper
// (sm_90a), float and double.
//
// Replaces the Pallas kernel elemental_tpu/kernels/lu_panel.py::lu_panel
// (body _lu_panel_kernel), which keeps the whole padded panel in a TPU
// core's VMEM and runs the column recurrence in one launch.  The main
// path's first panel is 32768 x 2048 float (256 MiB) and a 64-column chunk
// of it 8 MiB: neither fits one CTA's 227 KB.  So the panel stays in
// device memory, and each CTA keeps only its slab of the current chunk in
// shared memory (249 rows x 64 columns at M = 32768, 64 KB in float); a
// slab too large for shared memory (beyond ~117k rows in float, ~58k in
// double) is worked on in place in device memory instead, where the chunk
// sits in the 50 MB L2.  So the kernel has no size limit.  It computes the
// same function as the plain version _panel_lu(P, nbw, None, (inner,)),
// inner <= CW = 64: the same pivot sequence, the packed L\U up to
// rounding, the composed permutation.
//
// Per chunk of cw = inner columns [s, e), on the caller's stream:
//
//   factor_chunk   ONE cooperative launch (cudaLaunchCooperativeKernel, at
//                  most one CTA per SM, all resident).  CTA b owns a slab
//                  of rows of [s, M).  Per column j:
//                    - every CTA reduces the G per-CTA pivot candidates of
//                      column j in a fixed order over the key (|v|, -row),
//                      NaN above every number: the first maximum, as
//                      torch.argmax and jnp.argmax take it;
//                    - the swap: the candidate CTA published the pivot
//                      row's chunk, and the owner of row j published row
//                      j's, so the owners of rows j and p write the swapped
//                      chunk rows with no second barrier;
//                    - the column scale by division (col / pivot, no
//                      reciprocal, no zero guard: a singular panel gives
//                      the plain version's inf/NaN) and the rank-1 update
//                      of the chunk's columns right of j;
//                    - in the same sweep, each CTA's candidate for column
//                      j + 1 (and its row, and row j + 1's chunk), into
//                      the other parity of the double-buffered scratch;
//                    - one grid.sync().
//                  After the chunk, the chunk's swaps are replayed in order
//                  on the panel's other columns, so every swap moves whole
//                  panel rows, as _panel_lu's block-row take does.
//   trsm_kernel    U12 = L11^{-1} A12 by unit-lower forward substitution,
//                  a thread per column, L11 in shared memory.
//   gemm128_kernel A22 -= L21 @ U12, the 128 x 128 tiled GEMM of
//                  tiled_gemm.cuh.
//
// Then perm_kernel composes the nbw swaps into the length-M permutation:
// output row i came from input row tau_0(tau_1(...tau_{nbw-1}(i))), with
// tau_j the swap (j, piv[j]); each row follows its chain on its own thread.
// Nothing is allocated here (the wrapper passes the scratch), nothing
// synchronizes with the host, and no library is called.  Each entry point
// returns the first cudaError_t that is not cudaSuccess.
//
// Bound.  The least work is M nbw^2 - nbw^3/3 flops against 2 M nbw
// elements moved (the panel read once, the factor written once).  At
// M = 32768, nbw = 2048 float: 1.35e11 flop, ~2.0 ms at the data-sheet
// 67 TFLOP/s FP32, against 537 MB, ~0.16 ms at 3.35 TB/s: compute-bound.
// This first design is bound instead by its serial spine: nbw dependent
// column steps, each a grid-wide barrier plus two dependent reads of the
// candidates from L2, and by the K = cw trailing products, which stream
// the panel's right part once per chunk.  A register-resident slab, a
// cheaper exchange than grid.sync() + two reads, and a two-level chunk
// (512 then 64) are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "tiled_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CW = 64;               // widest chunk
constexpr int SROW = CW + 1;         // row stride of a slab in shared memory
constexpr int THREADS = 256;         // per CTA of factor_chunk
constexpr int WARPS = THREADS / 32;
constexpr int RSTEP = THREADS / CW;  // rows one pass of the update covers
constexpr int ROWS_PER_CTA = 64;     // fewest rows worth a CTA
constexpr int TRSM_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool is_nan(float x) { return isnan(x); }
__device__ __forceinline__ bool is_nan(double x) { return isnan(x); }

// Is candidate (va, ia) preferred over (vb, ib)?  Row -1 is "no candidate";
// NaN beats every number; a larger |v| wins; equal keys go to the lower row.
template <typename T>
__device__ __forceinline__ bool better(T va, int ia, T vb, int ib) {
  if (ib < 0) return ia >= 0;
  if (ia < 0) return false;
  const bool na = is_nan(va), nb = is_nan(vb);
  if (na != nb) return na;
  if (!na && va != vb) return va > vb;
  return ia < ib;
}

// Warp-wide reduction of (v, i, g) under `better`; lane 0 ends with the
// winner.
template <typename T>
__device__ __forceinline__ void warp_best(T& v, int& i, int& g) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(FULL, v, off);
    const int oi = __shfl_down_sync(FULL, i, off);
    const int og = __shfl_down_sync(FULL, g, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
      g = og;
    }
  }
}

// Scratch layout (T): cval[2][gmax] | cbuf[2][gmax][CW] | jbuf[2][CW];
// (int): crow[2][gmax] | piv[nbw].
template <typename T>
struct Scratch {
  T* cval;
  T* cbuf;
  T* jbuf;
  int* crow;
  int* piv;
  int gmax;
};

// This CTA's pivot candidate for column jn over its rows i >= jn, published
// with the candidate row's chunk into parity `par`; the owner of row jn
// also publishes row jn's chunk.  Reads only this CTA's rows: entry (i, c)
// of the chunk, r0 <= i < r1, 0 <= c < cw, is A[(i - r0) rs + c].
template <typename T>
__device__ void publish_candidate(const T* A, long long rs, int s, int cw,
                                  int r0, int r1, int jn, int par,
                                  const Scratch<T>& sc, T* red_v,
                                  int* red_i) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T bv = T(0);
  int bi = -1, bg = 0;
  for (int i = (r0 > jn ? r0 : jn) + tid; i < r1; i += THREADS) {
    const T v = fabs(A[(size_t)(i - r0) * rs + jn - s]);
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  warp_best(bv, bi, bg);
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < WARPS ? red_v[lane] : T(0);
    bi = lane < WARPS ? red_i[lane] : -1;
    warp_best(bv, bi, bg);
    if (lane == 0) {
      red_v[0] = bv;
      red_i[0] = bi;
    }
  }
  __syncthreads();
  bv = red_v[0];
  bi = red_i[0];
  const int slot = par * sc.gmax + blockIdx.x;
  if (tid == 0) {
    sc.cval[slot] = bv;
    sc.crow[slot] = bi;
  }
  if (bi >= 0)
    for (int c = tid; c < cw; c += THREADS)
      sc.cbuf[(size_t)slot * CW + c] = A[(size_t)(bi - r0) * rs + c];
  if (jn >= r0 && jn < r1)
    for (int c = tid; c < cw; c += THREADS)
      sc.jbuf[par * CW + c] = A[(size_t)(jn - r0) * rs + c];
  __syncthreads();          // red_v / red_i are reused by the next call
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
factor_chunk(T* P, long long ld, int M, int nbw, int s, int cw, int in_smem,
             Scratch<T> sc) {
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31;
  const int rows = M - s;
  const int R = (rows + G - 1) / G;
  const int r0 = s + b * R < M ? s + b * R : M;
  const int r1 = r0 + R < M ? r0 + R : M;        // slab [r0, r1)
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ T ush[CW];                          // pivot row's chunk
  __shared__ T jsh[CW];                          // row j's chunk
  __shared__ T red_v[WARPS];
  __shared__ int red_i[WARPS];
  __shared__ int win[2];                         // winner CTA, pivot row
  // the slab's chunk rows: in shared memory (row stride SROW) when they
  // fit, else in place in device memory
  T* A = in_smem ? reinterpret_cast<T*>(dyn) : P + (size_t)r0 * ld + s;
  const long long rs = in_smem ? SROW : ld;
  if (in_smem)
    for (int idx = tid; idx < (r1 - r0) * cw; idx += THREADS) {
      const int i = idx / cw, c = idx % cw;
      A[(size_t)i * SROW + c] = P[(size_t)(r0 + i) * ld + s + c];
    }
  __syncthreads();

  publish_candidate(A, rs, s, cw, r0, r1, s, 0, sc, red_v, red_i);
  grid.sync();
  const int e = s + cw;
  for (int j = s; j < e; ++j) {
    const int par = (j - s) & 1;
    // fixed-order reduction of the G candidates, redundantly in every CTA
    if (tid < 32) {
      T bv = T(0);
      int bi = -1, bg = 0;
      for (int g = lane; g < G; g += 32) {
        const int slot = par * sc.gmax + g;
        const T v = __ldcg(&sc.cval[slot]);
        const int i = __ldcg(&sc.crow[slot]);
        if (better(v, i, bv, bi)) {
          bv = v;
          bi = i;
          bg = g;
        }
      }
      warp_best(bv, bi, bg);
      if (lane == 0) {
        win[0] = bg;
        win[1] = bi;
      }
    }
    __syncthreads();
    const int p = win[1];
    const size_t wslot = (size_t)(par * sc.gmax + win[0]) * CW;
    for (int c = tid; c < cw; c += THREADS) {
      ush[c] = __ldcg(&sc.cbuf[wslot + c]);
      jsh[c] = __ldcg(&sc.jbuf[par * CW + c]);
    }
    __syncthreads();
    const T pivval = ush[j - s];
    // the swap, by the owners of rows j and p
    if (j >= r0 && j < r1)
      for (int c = tid; c < cw; c += THREADS)
        A[(size_t)(j - r0) * rs + c] = ush[c];
    if (p != j && p >= r0 && p < r1)
      for (int c = tid; c < cw; c += THREADS)
        A[(size_t)(p - r0) * rs + c] = jsh[c];
    if (b == 0 && tid == 0) sc.piv[j] = p;
    __syncthreads();
    const int i0 = r0 > j + 1 ? r0 : j + 1;
    const int jc = j - s;
    for (int i = i0 + tid; i < r1; i += THREADS) {
      T* a = A + (size_t)(i - r0) * rs + jc;
      *a = *a / pivval;
    }
    __syncthreads();
    // rank-1 update of the chunk's columns right of j, four rows at a time
    // (all loads before the stores, so they overlap)
    const int c = tid % CW;
    if (c > jc && c < cw) {
      const T u = ush[c];
      int i = i0 + tid / CW;
      for (; i + 3 * RSTEP < r1; i += 4 * RSTEP) {
        T* a[4];
        T l[4], x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = A + (size_t)(i + q * RSTEP - r0) * rs;
          l[q] = a[q][jc];
          x[q] = a[q][c];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q][c] = x[q] - l[q] * u;
      }
      for (; i < r1; i += RSTEP) {
        T* a = A + (size_t)(i - r0) * rs;
        a[c] -= a[jc] * u;
      }
    }
    __syncthreads();
    if (j + 1 < e)
      publish_candidate(A, rs, s, cw, r0, r1, j + 1, par ^ 1, sc, red_v,
                        red_i);
    grid.sync();
  }
  if (in_smem)
    for (int idx = tid; idx < (r1 - r0) * cw; idx += THREADS) {
      const int i = idx / cw, c = idx % cw;
      P[(size_t)(r0 + i) * ld + s + c] = A[(size_t)i * SROW + c];
    }
  // replay the chunk's swaps on the panel's other columns, in order
  const int others = nbw - cw;
  for (int t = b * THREADS + tid; t < others; t += G * THREADS) {
    const int col = t < s ? t : t + cw;
    for (int j = s; j < e; ++j) {
      const int p = __ldcg(&sc.piv[j]);
      if (p != j) {
        T* a = P + (size_t)j * ld + col;
        T* q = P + (size_t)p * ld + col;
        const T tmp = *a;
        *a = *q;
        *q = tmp;
      }
    }
  }
}

// B[0:w, 0:n] := L^{-1} B for the unit-lower w x w L (w <= CW); a thread
// per column of B.  L and B have leading dimension ld.
template <typename T>
__global__ void __launch_bounds__(TRSM_THREADS)
trsm_kernel(const T* L, T* B, long long ld, int w, int n) {
  __shared__ T Ls[CW][CW + 1];
  for (int idx = threadIdx.x; idx < w * w; idx += blockDim.x) {
    const int i = idx / w, k = idx % w;
    Ls[i][k] = L[(size_t)i * ld + k];
  }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  T u[CW];
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    if (i < w) {
      T acc = B[(size_t)i * ld + c];
#pragma unroll
      for (int k = 0; k < i; ++k) acc -= Ls[i][k] * u[k];
      u[i] = acc;
      B[(size_t)i * ld + c] = acc;
    }
  }
}

// perm[i] = tau_0(tau_1(...tau_{nbw-1}(i))), tau_j = swap (j, piv[j]).
__global__ void perm_kernel(const int* piv, int nbw, int M,
                            long long* perm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  int x = i;
  for (int j = nbw - 1; j >= 0; --j) {
    const int p = __ldg(&piv[j]);
    x = x == j ? p : (x == p ? j : x);
  }
  perm[i] = x;
}

template <typename T>
int lu_panel(T* P, long long ld, int M, int nbw, int inner, long long* perm,
             T* ws, int* wi, int gmax, cudaStream_t st) {
  if (nbw <= 0 || M < nbw || inner < 1 || inner > CW || gmax < 1)
    return cudaErrorInvalidValue;
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
  Scratch<T> sc{ws, ws + 2 * (size_t)gmax, ws + 2 * (size_t)gmax * (CW + 1),
                wi, wi + 2 * gmax, gmax};
  for (int s = 0; s < nbw; s += inner) {
    const int cw = inner < nbw - s ? inner : nbw - s;
    const int e = s + cw;
    int G = (M - s + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
    G = G < cap ? G : cap;
    const size_t slab = (size_t)((M - s + G - 1) / G) * SROW * sizeof(T);
    int in_smem = slab <= (size_t)dyn_max;
    const size_t dyn = in_smem ? slab : 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, factor_chunk<T>, THREADS, dyn)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&P, &ld, &M, &nbw, (void*)&s, (void*)&cw, &in_smem, &sc};
    err = cudaLaunchCooperativeKernel((const void*)factor_chunk<T>, G,
                                      THREADS, args, dyn, st);
    if (err != cudaSuccess) return err;
    if (e < nbw) {
      const int n = nbw - e;
      trsm_kernel<T><<<(n + TRSM_THREADS - 1) / TRSM_THREADS, TRSM_THREADS,
                       0, st>>>(P + (size_t)s * ld + s, P + (size_t)s * ld + e,
                                ld, cw, n);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      // A22 -= L21 @ U12 over rows [e, M), columns [e, nbw)
      const Gemm<T> upd{M - e, n, cw, T(-1), P + (size_t)e * ld + s,
                        (int)ld, P + (size_t)s * ld + e, (int)ld, T(1),
                        P + (size_t)e * ld + e, (int)ld, 0, 0};
      if ((err = gemm128<T>(st, upd)) != cudaSuccess) return err;
    }
  }
  perm_kernel<<<(M + 255) / 256, 256, 0, st>>>(sc.piv, nbw, M, perm);
  return cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes).  P is the (M, nbw) panel, row-major
// with leading dimension ld (elements), factored in place; perm receives
// the composed permutation (int64, length M).  ws (T) and wi (int32) are
// scratch of 2 gmax (CW + 1) + 2 CW and 2 gmax + nbw entries; gmax bounds
// the CTAs of a cooperative launch.
extern "C" int lu_panel_f32(void* P, long long ld, int M, int nbw, int inner,
                            void* perm, void* ws, void* wi, int gmax,
                            void* stream) {
  return lu_panel<float>(static_cast<float*>(P), ld, M, nbw, inner,
                         static_cast<long long*>(perm),
                         static_cast<float*>(ws), static_cast<int*>(wi), gmax,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int lu_panel_f64(void* P, long long ld, int M, int nbw, int inner,
                            void* perm, void* ws, void* wi, int gmax,
                            void* stream) {
  return lu_panel<double>(static_cast<double*>(P), ld, M, nbw, inner,
                          static_cast<long long*>(perm),
                          static_cast<double*>(ws), static_cast<int*>(wi),
                          gmax, static_cast<cudaStream_t>(stream));
}
