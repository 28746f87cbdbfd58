// Tiled GEMM for Hopper CUDA cores used by lu_panel.cu, full-precision FMA
// (no TF32): gemm128_kernel / gemm128, 128 x 128 output tiles, 8-deep
// k-tiles double buffered in shared memory, 8 x 8 register blocks per
// thread; C = alpha A B + beta C with plain B and full C (the panel's tall
// trailing updates).  The register tiles of potrf_inv.cu and qr_panel.cu
// are in fast_gemm.cuh.  Everything is in an anonymous namespace: each
// source that includes this header is its own shared library.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// One GEMM problem: C[m x n] = alpha * A[m x k] @ B[k x n] + beta * C,
// row-major; gemm128 takes trans_b == 0 and lower_c == 0 only.  beta == 0
// never reads C.
template <typename T>
struct Gemm {
  int m, n, k;
  T alpha;
  const T* A;
  int lda;
  const T* B;
  int ldb;
  T beta;
  T* C;
  int ldc;
  int trans_b, lower_c;
};

int tiles(int extent, int tile) {
  return extent > 0 ? (extent + tile - 1) / tile : 0;
}

constexpr int LBM = 128, LBN = 128, LBK = 8, LTHREADS = 256;

// One problem of the Gemm struct with trans_b == 0 and lower_c == 0.
// Thread (ty, tx) of the 16 x 16 layout owns rows {ty*4 + i, 64 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j}, i, j < 4, of the 128 x 128 tile.
template <typename T>
__global__ void __launch_bounds__(LTHREADS)
gemm128_kernel(Gemm<T> p) {
  const int row0 = blockIdx.y * LBM, col0 = blockIdx.x * LBN;
  __shared__ T As[2][LBK][LBM];
  __shared__ T Bs[2][LBK][LBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // loads: A as 128 rows x 2 runs of 4 k, B as 8 k x 32 runs of 4 columns
  const int ar = row0 + tid / 2, ak = (tid % 2) * 4;
  const int bk = tid / 32, bc = col0 + (tid % 32) * 4;
  T ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int k = k0 + ak + t, c = bc + t;
      ra[t] = (ar < p.m && k < p.k) ? p.A[(size_t)ar * p.lda + k] : T(0);
      rb[t] = (k0 + bk < p.k && c < p.n)
                  ? p.B[(size_t)(k0 + bk) * p.ldb + c] : T(0);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      As[buf][ak + t][tid / 2] = ra[t];
      Bs[buf][bk][(tid % 32) * 4 + t] = rb[t];
    }
  };
  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < p.k; k0 += LBK) {
    const bool more = k0 + LBK < p.k;
    if (more) fetch(k0 + LBK);
#pragma unroll
    for (int kk = 0; kk < LBK; ++kk) {
      T a[8], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[buf][kk][ty * 4 + i];
        a[4 + i] = As[buf][kk][64 + ty * 4 + i];
        b[i] = Bs[buf][kk][tx * 4 + i];
        b[4 + i] = Bs[buf][kk][64 + tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    if (more) stash(buf ^ 1);     // buf ^ 1 was last read before the sync
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gi >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gj = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gj < p.n) {
        T* c = p.C + (size_t)gi * p.ldc + gj;
        *c = (p.beta == T(0)) ? p.alpha * acc[i][j]
                              : p.alpha * acc[i][j] + p.beta * *c;
      }
    }
  }
}

// Launch one problem (plain B, full C) on 128 x 128 tiles.
template <typename T>
cudaError_t gemm128(cudaStream_t st, const Gemm<T>& p) {
  if (p.m <= 0 || p.n <= 0) return cudaSuccess;
  gemm128_kernel<T><<<dim3(tiles(p.n, LBN), tiles(p.m, LBM)), LTHREADS, 0,
                      st>>>(p);
  return cudaGetLastError();
}

}  // namespace
