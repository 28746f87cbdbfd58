// potrf_inv: lower Cholesky factor L of a (w, w) symmetric block AND its
// inverse L^{-1}, for Hopper (sm_90a), float and double.
//
// Replaces the Pallas kernel elemental_tpu/kernels/chol_panel.py::potrf_inv
// (body _potrf_inv_kernel, with _chol_unb and _trinv_unb), which keeps the
// whole block in a TPU core's VMEM and runs the blocked recurrence in one
// launch.  A 512 x 512 float sub-block is 1 MiB and cannot sit in one CTA's
// shared memory, so this kernel does not carry that block structure over.
// It computes the same function, (L, L^{-1}) from the lower triangle of D,
// as a right-looking blocked loop over b x b diagonal sub-blocks,
// b = min(bs, 32):
//
//   base_kernel   one warp: loads the lower triangle of the current
//                 Schur-complement block W[s:e, s:e] into registers (a row
//                 per lane) and runs the column Cholesky recurrence with
//                 shuffles, eliminating the identity alongside it
//                 (X = Lkk^{-1}); writes Lkk and Likk.
//   gemm_kernel   the tiled GEMM of tiled_gemm.cuh (shared-memory tiles,
//                 4x4 register blocks per thread, full-precision FMA), two
//                 independent problems per launch, two launches per step:
//                   Li[s:e, :s]   = Likk @ R[s:e, :s]          (inverse rows)
//                   L[e:, s:e]    = W[e:, s:e] @ Likk^T        (panel)
//                 then
//                   W[e:, e:]    -= L[e:, s:e] @ L[e:, s:e]^T  (lower triangle)
//                   R[e:, :e]    -= L[e:, s:e] @ Li[s:e, :e]
//
// The inverse is assembled right-looking, like the factor: R holds
// -sum_k L[i, k] L^{-1}[k, :] over the finished block columns k, so block
// row j of L^{-1} is Likk @ R[j] and every update is a wide GEMM with
// K = b (the Pallas kernel's left-looking Li[s:e, :s] = -Likk L[s:e, :s]
// Li[:s, :s] has only s/64 output tiles per step).
//
// The host loop over the diagonal blocks lives in the C entry point; every
// launch goes on the caller's stream, nothing is allocated here (the
// wrapper passes the outputs L, Li and the scratch W and R, all w x w),
// and nothing synchronizes.  Each entry point returns the first
// cudaGetLastError() that is not cudaSuccess.
//
// Bound.  The least work is 2w^3/3 flops (potrf w^3/3 + trtri w^3/3)
// against 2.5 w^2 elements moved (D's lower triangle read, L and Li
// written).  At w = 2048 float that is ~5.7 GFLOP, ~0.086 ms at the
// data-sheet 67 TFLOP/s FP32, against ~42 MB, ~0.013 ms at 3.35 TB/s: the
// kernel is compute-bound.
// This first design is far from that bound: the base block is a serial
// recurrence on one warp (32 columns per block, w/32 blocks), every GEMM has
// K = b (so it is bound by its tile loads, not its FMAs; the next tile is
// prefetched into registers, nothing deeper), and the inner product runs
// from shared memory without wide loads.  Making it fast -- a blocked base
// recurrence, register-tiled FP32 FMA (TF32 is not allowed), DMMA tensor
// cores for double, fewer launches, recursion -- is later work.

#include <cuda_runtime.h>

#include <cstddef>

#include "tiled_gemm.cuh"

namespace {

constexpr int BASE = 32;            // largest diagonal sub-block: one warp
constexpr int INIT_THREADS = 256;

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

// L = 0, Li = 0, R = 0, W = lower triangle of D (upper part zero).
template <typename T>
__global__ void init_kernel(int w, const T* __restrict__ D, long long ldd,
                            T* __restrict__ L, T* __restrict__ Li,
                            T* __restrict__ W, T* __restrict__ R) {
  const long long n = (long long)w * w;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long i = idx / w, j = idx % w;
    L[idx] = T(0);
    Li[idx] = T(0);
    R[idx] = T(0);
    W[idx] = (j <= i) ? D[i * ldd + j] : T(0);
  }
}

// One b x b diagonal block (b <= BASE = 32), one warp: Lkk = chol(lower(A))
// and Likk = Lkk^{-1}.  A, L, Li point at the block's (0, 0) entry, all with
// leading dimension ld.  Lane i holds row i of S (the running factor) and of
// X (the running inverse) in registers; a column step broadcasts the pivot,
// the scaled column j of L and the finished row j of X with shuffles, so the
// recurrence runs without a barrier.  The strict upper part of S collects
// garbage (the update is branch-free) and is masked at the store.
template <typename T>
__global__ void __launch_bounds__(BASE)
base_kernel(int b, const T* __restrict__ A, T* __restrict__ L,
            T* __restrict__ Li, int ld) {
  constexpr unsigned FULL = 0xffffffffu;
  const int i = threadIdx.x;
  T s[BASE], x[BASE];
#pragma unroll
  for (int k = 0; k < BASE; ++k) {
    s[k] = (i < b && k <= i) ? A[(size_t)i * ld + k] : T(0);
    x[k] = (i < b && k == i) ? T(1) : T(0);
  }
  // Right-looking column recurrence: the same elimination applied to the
  // identity leaves X = Lkk^{-1}; row j of X is final once scaled.
#pragma unroll
  for (int j = 0; j < BASE; ++j) {
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
    for (int k = j + 1; k < BASE; ++k) s[k] -= lj * __shfl_sync(FULL, lj, k);
#pragma unroll
    for (int c = 0; c <= j; ++c) x[c] -= lj * __shfl_sync(FULL, x[c], j);
  }
  if (i < b) {
#pragma unroll
    for (int k = 0; k < BASE; ++k) {
      if (k < b) {
        L[(size_t)i * ld + k] = (k <= i) ? s[k] : T(0);
        Li[(size_t)i * ld + k] = x[k];        // X stays zero above the diagonal
      }
    }
  }
}

template <typename T>
int potrf_inv(const T* D, long long ldd, int w, int bs, T* L, T* Li, T* W,
              T* R, cudaStream_t st) {
  if (w <= 0) return cudaSuccess;
  const int b = bs < 1 ? 1 : (bs < BASE ? bs : BASE);
  cudaError_t err;
  const long long n = (long long)w * w;
  const int blocks =
      (int)((n + INIT_THREADS - 1) / INIT_THREADS < 4096
                ? (n + INIT_THREADS - 1) / INIT_THREADS
                : 4096);
  init_kernel<T><<<blocks, INIT_THREADS, 0, st>>>(w, D, ldd, L, Li, W, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t ld = (size_t)w;
  for (int s = 0; s < w; s += b) {
    const int e = s + b < w ? s + b : w;
    const int wb = e - s, r = w - e;
    base_kernel<T><<<1, BASE, 0, st>>>(wb, W + s * ld + s, L + s * ld + s,
                                       Li + s * ld + s, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const T* Likk = Li + s * ld + s;
    const T* B21 = L + e * ld + s;
    // block row of the inverse left of the diagonal, Li[s:e, :s] =
    // Likk @ R[s:e, :s], and the panel, L[e:, s:e] = W[e:, s:e] @ Likk^T
    err = gemm2<T>(st,
                   {wb, s, wb, T(1), Likk, w, R + s * ld, w, T(0),
                    Li + s * ld, w, 0, 0},
                   {r, wb, wb, T(1), W + e * ld + s, w, Likk, w, T(0),
                    L + e * ld + s, w, 1, 0});
    if (err != cudaSuccess) return err;
    // trailing update of the lower triangle, W[e:, e:] -= B21 @ B21^T, and
    // the inverse right-hand sides, R[e:, :e] -= B21 @ Li[s:e, :e]
    err = gemm2<T>(st,
                   {r, r, wb, T(-1), B21, w, B21, w, T(1), W + e * ld + e, w,
                    1, 1},
                   {r, e, wb, T(-1), B21, w, Li + s * ld, w, T(1), R + e * ld,
                    w, 0, 0});
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// C entry points (loaded with ctypes).  Pointers are device pointers; ldd is
// D's leading dimension in elements; L, Li, W and R are w x w contiguous.
extern "C" int potrf_inv_f32(const void* D, long long ldd, int w, int bs,
                             void* L, void* Li, void* W, void* R,
                             void* stream) {
  return potrf_inv<float>(static_cast<const float*>(D), ldd, w, bs,
                          static_cast<float*>(L), static_cast<float*>(Li),
                          static_cast<float*>(W), static_cast<float*>(R),
                          static_cast<cudaStream_t>(stream));
}

extern "C" int potrf_inv_f64(const void* D, long long ldd, int w, int bs,
                             void* L, void* Li, void* W, void* R,
                             void* stream) {
  return potrf_inv<double>(static_cast<const double*>(D), ldd, w, bs,
                           static_cast<double*>(L), static_cast<double*>(Li),
                           static_cast<double*>(W), static_cast<double*>(R),
                           static_cast<cudaStream_t>(stream));
}
