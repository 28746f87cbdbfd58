// Tiled GEMMs for Hopper CUDA cores, shared by the port's kernels, all
// with full-precision FMA (no TF32):
//   gemm_kernel / gemm2    64 x 64 output tiles, 16-deep k-tiles, 4 x 4
//                          register blocks per thread, the next k-tile
//                          prefetched into registers; two independent
//                          problems can share one launch, op(B) may be
//                          B^T and C may be written in its lower triangle
//                          only (potrf_inv.cu's small, K = 32 products);
//   gemm128_kernel / gemm128
//                          128 x 128 output tiles, 8-deep k-tiles double
//                          buffered in shared memory, 8 x 8 register
//                          blocks per thread; C = alpha A B + beta C with
//                          plain B and full C (lu_panel.cu's tall trailing
//                          updates, where the 64 x 64 tiles re-read and
//                          re-write C four times as often per flop).
// Everything is in an anonymous namespace: each source that includes this
// header is its own shared library.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);     // 256

// One GEMM problem: C[m x n] = alpha * A[m x k] @ op(B) + beta * C,
// row-major, with op(B) = B (k x n) or, when trans_b, B^T (B stored n x k);
// lower_c writes only C[i][j] with j <= i (tiles wholly above the diagonal
// do nothing).  beta == 0 never reads C.
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

// Two independent GEMM problems in one launch: the CTAs with
// blockIdx.x < tiles0 take the first, the rest the second.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(Gemm<T> p0, Gemm<T> p1, int tiles0) {
  constexpr int LA = BM * BK / GEMM_THREADS;  // tile entries each thread loads
  constexpr int LB = BK * BN / GEMM_THREADS;
  const bool first = blockIdx.x < tiles0;
  const Gemm<T> p = first ? p0 : p1;
  const int row0 = blockIdx.y * BM;
  const int col0 = (first ? blockIdx.x : blockIdx.x - tiles0) * BN;
  if (row0 >= p.m || col0 >= p.n) return;
  if (p.lower_c && col0 > row0 + BM - 1) return;
  __shared__ T As[BK][BM + 1];
  __shared__ T Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
  // the next k-tile is fetched into registers while the current one is
  // multiplied from shared memory
  T ra[LA], rb[LB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int t = 0; t < LA; ++t) {
      const int l = tid + t * GEMM_THREADS;
      const int gi = row0 + l / BK, gk = k0 + l % BK;
      ra[t] = (gi < p.m && gk < p.k) ? p.A[(size_t)gi * p.lda + gk] : T(0);
    }
#pragma unroll
    for (int t = 0; t < LB; ++t) {
      const int l = tid + t * GEMM_THREADS;
      const int kk = p.trans_b ? l % BK : l / BN;
      const int gk = k0 + kk, gj = col0 + (p.trans_b ? l / BK : l % BN);
      T v = T(0);
      if (gk < p.k && gj < p.n)
        v = p.trans_b ? p.B[(size_t)gj * p.ldb + gk]
                      : p.B[(size_t)gk * p.ldb + gj];
      rb[t] = v;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < p.k; k0 += BK) {
#pragma unroll
    for (int t = 0; t < LA; ++t) {
      const int l = tid + t * GEMM_THREADS;
      As[l % BK][l / BK] = ra[t];
    }
#pragma unroll
    for (int t = 0; t < LB; ++t) {
      const int l = tid + t * GEMM_THREADS;
      if (p.trans_b)
        Bs[l % BK][l / BK] = rb[t];
      else
        Bs[l / BN][l % BN] = rb[t];
    }
    __syncthreads();
    if (k0 + BK < p.k) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + ty + i * (BM / TM);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = col0 + tx + j * (BN / TN);
      if (gi < p.m && gj < p.n && (!p.lower_c || gj <= gi)) {
        T* c = p.C + (size_t)gi * p.ldc + gj;
        *c = (p.beta == T(0)) ? p.alpha * acc[i][j]
                              : p.alpha * acc[i][j] + p.beta * *c;
      }
    }
  }
}

int tiles(int extent, int tile) {
  return extent > 0 ? (extent + tile - 1) / tile : 0;
}

// Launch two independent problems (either may be empty) as one grid.
template <typename T>
cudaError_t gemm2(cudaStream_t st, const Gemm<T>& p0, const Gemm<T>& p1) {
  const int n0 = p0.m > 0 ? tiles(p0.n, BN) : 0;
  const int n1 = p1.m > 0 ? tiles(p1.n, BN) : 0;
  const int my = tiles(p0.m > p1.m ? p0.m : p1.m, BM);
  if (n0 + n1 == 0 || my == 0) return cudaSuccess;
  gemm_kernel<T><<<dim3(n0 + n1, my), GEMM_THREADS, 0, st>>>(p0, p1, n0);
  return cudaGetLastError();
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
