// Register-tiled FP32 / FP64 GEMM tiles for Hopper CUDA cores, shared by
// potrf_inv.cu, lu_panel.cu and qr_panel.cu: full-precision FMA only (no
// TF32, no tensor cores), no library.
//
// One CTA of FG_THREADS = 256 threads computes a BM x BN output tile,
// BM = 16 TM (TM = 8: 128 rows, TM = 4: 64), BN = 16 TN (TN = 8: 128
// columns, TN = 4: 64), as a 16 x 16 grid of threads each holding TM x TN
// accumulators: thread (ty, tx) owns rows {ty*4 + i, 64 + ty*4 + i} (the
// second set only when TM = 8) and columns {tx*4 + j, 64 + tx*4 + j} (the
// second set only when TN = 8), i, j < 4.  tile_mma (long K) runs BK-deep
// k-tiles (16 for float, 8 for double) double buffered in shared memory
// with a register-staged prefetch of the next k-tile; tile_mma_short
// (K <= KMAX) requests every k-tile at once and stages them all, so a
// short product waits on one round trip to L2, not one per k-tile.  Every
// global load and every shared-memory read of the inner product is 16
// bytes wide when the operands are aligned (vec), scalar at ragged edges;
// fg_ld4 / fg_st4 give callers' epilogues the same 16-byte accesses.
//
// Operands are described by Op: element (r, k) of a tile operand (r the
// output row for A, the output column for B) is p[k * ld + r] when kmajor
// (stored K x R) and p[r * ld + k] otherwise (stored R x K, transposed into
// shared memory on the way in).  Global loads go through L2 only (ld.cg),
// so a persistent kernel reads what other CTAs wrote before a grid barrier.
// The tiles only accumulate; each caller writes its own epilogue with
// tile_row / tile_col.  Everything is in an anonymous namespace: each
// source that includes this header is its own shared library.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int FG_THREADS = 256;
constexpr int FG_BN = 128;
constexpr int FG_PAD = 4;            // keeps 16-byte alignment of smem rows

template <typename T>
struct FgCfg;
template <>
struct FgCfg<float> {
  static constexpr int BK = 16;
};
template <>
struct FgCfg<double> {
  static constexpr int BK = 8;
};

template <typename T>
struct Op {
  const T* p;
  long long ld;
  int kmajor;
};

// Shared-memory bytes tile_mma<T, TM> needs.
template <typename T, int TM>
__host__ __device__ constexpr size_t fg_smem_bytes() {
  return (size_t)2 * FgCfg<T>::BK * ((16 * TM + FG_PAD) + (FG_BN + FG_PAD)) *
         sizeof(T);
}

// 4 consecutive elements p[0..valid) (zero beyond), through L2.
__device__ __forceinline__ void fg_ld4(const float* p, bool vec, int valid,
                                       float (&v)[4]) {
  if (vec && valid >= 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = t < valid ? __ldcg(p + t) : 0.0f;
  }
}

__device__ __forceinline__ void fg_ld4(const double* p, bool vec, int valid,
                                       double (&v)[4]) {
  if (vec && valid >= 4) {
    const double2 x = __ldcg(reinterpret_cast<const double2*>(p));
    const double2 y = __ldcg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = t < valid ? __ldcg(p + t) : 0.0;
  }
}

// Store v[0..valid) at p: one 16-byte store when vec and valid >= 4.
__device__ __forceinline__ void fg_st4(float* p, bool vec, int valid,
                                       const float (&v)[4]) {
  if (vec && valid >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (t < valid) p[t] = v[t];
  }
}

__device__ __forceinline__ void fg_st4(double* p, bool vec, int valid,
                                       const double (&v)[4]) {
  if (vec && valid >= 4) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (t < valid) p[t] = v[t];
  }
}

// 4 consecutive elements of shared memory (16-byte aligned).
__device__ __forceinline__ void fg_lds4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void fg_lds4(const double* p, double (&v)[4]) {
  const double2 x = reinterpret_cast<const double2*>(p)[0];
  const double2 y = reinterpret_cast<const double2*>(p)[1];
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}

// Whether 16-byte loads are safe for an operand: base and row stride
// aligned (tile origins are multiples of 4 elements).
template <typename T>
__host__ __device__ inline bool fg_aligned(const T* p, long long ld) {
  return (reinterpret_cast<size_t>(p) % 16 == 0) &&
         ((ld * (long long)sizeof(T)) % 16 == 0);
}

// The R x BK slice of one operand staged in registers, then in shared
// memory as s[BK][R + FG_PAD] (k-major).
template <typename T, int R>
struct FgLoader {
  static constexpr int BK = FgCfg<T>::BK;
  static constexpr int UNITS = R * BK / 4;
  static constexpr int NU = (UNITS + FG_THREADS - 1) / FG_THREADS;
  T reg[NU][4];

  __device__ __forceinline__ void fetch(const Op<T>& o, int rext, int k0,
                                        int kext, bool vec) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int idx = threadIdx.x + u * FG_THREADS;
      int valid = 0;
      const T* src = o.p;
      if (idx < UNITS) {
        if (o.kmajor) {
          const int kk = idx / (R / 4), r = (idx % (R / 4)) * 4;
          if (k0 + kk < kext) valid = rext - r;
          src = o.p + (size_t)(k0 + kk) * o.ld + r;
        } else {
          const int r = idx / (BK / 4), kk = (idx % (BK / 4)) * 4;
          if (r < rext) valid = kext - (k0 + kk);
          src = o.p + (size_t)r * o.ld + k0 + kk;
        }
      }
      if (valid > 4) valid = 4;
      if (valid < 0) valid = 0;
      fg_ld4(src, vec, valid, reg[u]);
    }
  }

  __device__ __forceinline__ void store(T* s, int kmajor) const {
    constexpr int LD = R + FG_PAD;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int idx = threadIdx.x + u * FG_THREADS;
      if (idx >= UNITS) continue;
      if (kmajor) {
        const int kk = idx / (R / 4), r = (idx % (R / 4)) * 4;
#pragma unroll
        for (int t = 0; t < 4; ++t) s[kk * LD + r + t] = reg[u][t];
      } else {
        const int r = idx / (BK / 4), kk = (idx % (BK / 4)) * 4;
#pragma unroll
        for (int t = 0; t < 4; ++t) s[(kk + t) * LD + r] = reg[u][t];
      }
    }
  }
};

__device__ __forceinline__ int tile_row(int i) {
  const int ty = threadIdx.x / 16;
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}

__device__ __forceinline__ int tile_col(int j) {
  const int tx = threadIdx.x % 16;
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// acc += A(m x K) B(K x n) over one BM x 128 tile; rows >= m, columns >= n
// and k >= K are read as zero.  smem holds fg_smem_bytes<T, TM>() bytes.
// All threads of the CTA must call it.
template <typename T, int TM>
__device__ void tile_mma(T (&acc)[TM][8], const Op<T>& A, int m,
                         const Op<T>& B, int n, int K, bool vec, T* smem) {
  constexpr int BM = 16 * TM, BK = FgCfg<T>::BK;
  constexpr int LA = BM + FG_PAD, LB = FG_BN + FG_PAD;
  T* As = smem;                      // [2][BK][LA]
  T* Bs = smem + 2 * BK * LA;        // [2][BK][LB]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  FgLoader<T, BM> la;
  FgLoader<T, FG_BN> lb;
  __syncthreads();                   // smem may still be read by a caller
  la.fetch(A, m, 0, K, vec);
  lb.fetch(B, n, 0, K, vec);
  la.store(As, A.kmajor);
  lb.store(Bs, B.kmajor);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) {
      la.fetch(A, m, k0 + BK, K, vec);
      lb.fetch(B, n, k0 + BK, K, vec);
    }
    const T* as = As + buf * BK * LA;
    const T* bs = Bs + buf * BK * LB;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], b[8];
      {
        T v[4];
        fg_lds4(as + kk * LA + ty * 4, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = v[i];
        if constexpr (TM == 8) {
          fg_lds4(as + kk * LA + 64 + ty * 4, v);
#pragma unroll
          for (int i = 0; i < 4; ++i) a[4 + i] = v[i];
        }
        fg_lds4(bs + kk * LB + tx * 4, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = v[j];
        fg_lds4(bs + kk * LB + 64 + tx * 4, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[4 + j] = v[j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    if (more) {
      la.store(As + (buf ^ 1) * BK * LA, A.kmajor);
      lb.store(Bs + (buf ^ 1) * BK * LB, B.kmajor);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// acc += A(m x K) B(K x n) for a short K <= KMAX (a multiple of BK): every
// k-tile of both operands is requested at once (one round trip to L2, not
// one per k-tile) and staged whole in shared memory, then multiplied.
// smem holds fg_short_smem_bytes<T, TM, KMAX>() bytes.  All threads of the
// CTA must call it.
// TN = 8 gives BM x 128 tiles, TN = 4 BM x 64 (columns tx*4 + j only).
template <typename T, int TM, int KMAX>
__host__ __device__ constexpr size_t fg_short_smem_bytes() {
  return (size_t)KMAX * ((16 * TM + FG_PAD) + (FG_BN + FG_PAD)) * sizeof(T);
}

template <typename T, int TM, int TN, int KMAX>
__device__ void tile_mma_short(T (&acc)[TM][TN], const Op<T>& A, int m,
                               const Op<T>& B, int n, int K, bool vec,
                               T* smem) {
  constexpr int BM = 16 * TM, BN = 16 * TN, BK = FgCfg<T>::BK;
  constexpr int NKT = KMAX / BK;
  static_assert(KMAX % BK == 0, "KMAX must be a multiple of BK");
  static_assert(TN == 4 || TN == 8, "TN is 4 or 8");
  constexpr int LA = BM + FG_PAD, LB = BN + FG_PAD;
  T* As = smem;                      // [KMAX][LA]
  T* Bs = smem + KMAX * LA;          // [KMAX][LB]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  FgLoader<T, BM> la[NKT];
  FgLoader<T, BN> lb[NKT];
  __syncthreads();                   // smem may still be read by a caller
#pragma unroll
  for (int t = 0; t < NKT; ++t) {
    if (t * BK < K) {
      la[t].fetch(A, m, t * BK, K, vec);
      lb[t].fetch(B, n, t * BK, K, vec);
    }
  }
#pragma unroll
  for (int t = 0; t < NKT; ++t) {
    if (t * BK < K) {
      la[t].store(As + t * BK * LA, A.kmajor);
      lb[t].store(Bs + t * BK * LB, B.kmajor);
    }
  }
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], b[TN];
      {
        T v[4];
        fg_lds4(As + (k0 + kk) * LA + ty * 4, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = v[i];
        if constexpr (TM == 8) {
          fg_lds4(As + (k0 + kk) * LA + 64 + ty * 4, v);
#pragma unroll
          for (int i = 0; i < 4; ++i) a[4 + i] = v[i];
        }
        fg_lds4(Bs + (k0 + kk) * LB + tx * 4, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = v[j];
        if constexpr (TN == 8) {
          fg_lds4(Bs + (k0 + kk) * LB + 64 + tx * 4, v);
#pragma unroll
          for (int j = 0; j < 4; ++j) b[4 + j] = v[j];
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
  }
}

template <typename T, int TM>
__device__ __forceinline__ void tile_zero(T (&acc)[TM][8]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
}

}  // namespace
