// Register-tiled FP32 / FP64 GEMM tiles for Hopper CUDA cores, shared by
// potrf_inv.cu, lu_panel.cu and qr_panel.cu: full-precision FMA only (no
// TF32, no tensor cores), no library; and, at the end, FP64 tiles on the
// tensor cores (DMMA), which compute full IEEE float64 products.
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

// ---------------------------------------------------------------------------
// FP64 on the tensor cores: mma.sync.aligned.m16n8k8.row.col.f64 (DMMA,
// sm_90; 67 TFLOP/s on an H100 SXM against 34 TFLOP/s of FP64 FMA).  Each
// product is an IEEE float64 fused multiply-add, so a float64 result keeps
// full precision.  Fragments of one m16n8k8 step, with g = lane / 4 and
// q = lane % 4 (CuTe's SM90_16x8x8_F64F64F64F64_TN layouts):
//   a[v]: A(g + 8 (v & 1), q + 4 (v >> 1))      (16 x 8, v < 4)
//   b[v]: B(q + 4 v, g)                          (8 x 8, v < 2)
//   c[v]: C(g + 8 (v >> 1), 2 q + (v & 1))       (16 x 8, v < 4)
// The tile below computes a 64 x BN block (BN = 16 TN) on the 8 warps of a
// CTA: warp v takes rows 32 (v % 2) .. + 32 and columns 4 TN (v / 2) ..
// + 4 TN, MI = 2 blocks of 16 rows times NI = TN / 2 blocks of 8 columns.
// Its operands are staged in shared memory in their own orientation with
// cp.async (no register holds them on the way; zero-filled past the
// edges), so the caller can request its epilogue's old values between
// dm_issue and dm_mma and wait on one round trip to L2 for all three.

constexpr int DM_BM = 64;

__device__ __forceinline__ void dmma_16x8x8(double (&d)[4],
                                            const double (&a)[4],
                                            const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Leading dimension of a staged R x KMAX operand in shared memory, and the
// elements its region takes in either orientation.
template <int R, int KMAX>
__host__ __device__ constexpr int dm_ld(int kmajor) {
  return kmajor ? R + FG_PAD : KMAX + FG_PAD;
}

template <int R, int KMAX>
__host__ __device__ constexpr size_t dm_region() {
  return (size_t)KMAX * (R + FG_PAD) > (size_t)R * (KMAX + FG_PAD)
             ? (size_t)KMAX * (R + FG_PAD)
             : (size_t)R * (KMAX + FG_PAD);
}

// Shared-memory bytes of a 64 x 16 TN tile with K <= KMAX.
template <int TN, int KMAX>
__host__ __device__ constexpr size_t dm_smem_bytes() {
  return (dm_region<DM_BM, KMAX>() + dm_region<16 * TN, KMAX>()) *
         sizeof(double);
}

__device__ __forceinline__ void dm_cp16(double* s, const double* g,
                                        int valid) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(g), "r"(valid * 8)
               : "memory");
}

// The R x K operand o (r >= rext and k >= kext read as zero) into s:
// element (r, k) at s[k * ld + r] when o.kmajor, s[r * ld + k] otherwise
// (ld = dm_ld).  vec: 16 bytes a thread by cp.async (through L2, as ld.cg);
// else element by element.
template <int R, int KMAX>
__device__ void dm_stage(double* s, const Op<double>& o, int rext, int kext,
                         bool vec) {
  constexpr int RU = R / 2, KU = KMAX / 2, UNITS = R * KMAX / 2;
  const int ld = dm_ld<R, KMAX>(o.kmajor);
#pragma unroll
  for (int u = 0; u < (UNITS + FG_THREADS - 1) / FG_THREADS; ++u) {
    const int idx = threadIdx.x + u * FG_THREADS;
    if (idx >= UNITS) break;
    int r, k, along;
    bool live;
    if (o.kmajor) {
      k = idx / RU, r = (idx % RU) * 2;
      live = k < kext, along = rext - r;
    } else {
      r = idx / KU, k = (idx % KU) * 2;
      live = r < rext, along = kext - k;
    }
    const int valid = !live || along < 0 ? 0 : (along < 2 ? along : 2);
    double* dst = o.kmajor ? s + k * ld + r : s + r * ld + k;
    const double* src = o.kmajor ? o.p + (size_t)k * o.ld + r
                                 : o.p + (size_t)r * o.ld + k;
    if (vec) {
      dm_cp16(dst, valid ? src : o.p, valid);
    } else {
      dst[0] = valid > 0 ? __ldcg(src) : 0.0;
      dst[1] = valid > 1 ? __ldcg(src + 1) : 0.0;
    }
  }
}

// Request both operands of a 64 x 16 TN tile (K <= KMAX) into smem
// (dm_smem_bytes<TN, KMAX>()).  All threads of the CTA must call it.
template <int TN, int KMAX>
__device__ void dm_issue(const Op<double>& A, int m, const Op<double>& B,
                         int n, int K, bool vec, double* smem) {
  __syncthreads();                   // smem may still be read by a caller
  dm_stage<DM_BM, KMAX>(smem, A, m, K, vec);
  dm_stage<16 * TN, KMAX>(smem + dm_region<DM_BM, KMAX>(), B, n, K, vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// acc += A B over a 64 x 16 TN tile whose operands (depth K <= KMAX) are
// staged in smem as dm_issue leaves them.
template <int TN, int KMAX>
__device__ __forceinline__ void dm_mma_smem(double (&acc)[2][TN / 2][4],
                                            int akmajor, int bkmajor, int K,
                                            const double* smem) {
  constexpr int NI = TN / 2;
  const double* As = smem;
  const double* Bs = smem + dm_region<DM_BM, KMAX>();
  const int lda = dm_ld<DM_BM, KMAX>(akmajor);
  const int ldb = dm_ld<16 * TN, KMAX>(bkmajor);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  const int r0 = (warp % 2) * 32 + g, c0 = (warp / 2) * (4 * TN) + g;
  for (int k0 = 0; k0 < K; k0 += 8) {
    double a[2][4], b[NI][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = r0 + mi * 16 + 8 * (v & 1), k = k0 + q + 4 * (v >> 1);
        a[mi][v] = akmajor ? As[k * lda + r] : As[r * lda + k];
      }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int c = c0 + ni * 8, k = k0 + q + 4 * v;
        b[ni][v] = bkmajor ? Bs[k * ldb + c] : Bs[c * ldb + k];
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) dmma_16x8x8(acc[mi][ni], a[mi], b[ni]);
  }
}

// Wait for dm_issue's operands, then acc += A B over the tile.  All
// threads of the CTA must call it.
template <int TN, int KMAX>
__device__ void dm_mma(double (&acc)[2][TN / 2][4], int akmajor, int bkmajor,
                       int K, const double* smem) {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  dm_mma_smem<TN, KMAX>(acc, akmajor, bkmajor, K, smem);
}

// acc += A(m x K) B(K x n) over a 64 x 16 TN tile for any K: k-tiles of
// DM_BK staged by cp.async, the next requested while the current one is
// multiplied (two buffers, dm_long_smem_bytes<TN>()).  The products of one
// k-tile run in the order dm_mma runs them, k-tile after k-tile.  All
// threads of the CTA must call it.
constexpr int DM_BK = 32;

template <int TN>
__host__ __device__ constexpr size_t dm_long_stage() {
  return dm_region<DM_BM, DM_BK>() + dm_region<16 * TN, DM_BK>();
}

template <int TN>
__host__ __device__ constexpr size_t dm_long_smem_bytes() {
  return 2 * dm_long_stage<TN>() * sizeof(double);
}

template <int TN>
__device__ __forceinline__ void dm_long_issue(const Op<double>& A, int m,
                                              const Op<double>& B, int n,
                                              int K, int k0, bool vec,
                                              double* s) {
  Op<double> a = A, b = B;
  a.p += A.kmajor ? (size_t)k0 * A.ld : (size_t)k0;
  b.p += B.kmajor ? (size_t)k0 * B.ld : (size_t)k0;
  dm_stage<DM_BM, DM_BK>(s, a, m, K - k0, vec);
  dm_stage<16 * TN, DM_BK>(s + dm_region<DM_BM, DM_BK>(), b, n, K - k0, vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int TN>
__device__ void dm_tile_mma(double (&acc)[2][TN / 2][4], const Op<double>& A,
                            int m, const Op<double>& B, int n, int K,
                            bool vec, double* smem) {
  constexpr size_t STAGE = dm_long_stage<TN>();
  __syncthreads();                   // smem may still be read by a caller
  dm_long_issue<TN>(A, m, B, n, K, 0, vec, smem);
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += DM_BK) {
    if (k0 + DM_BK < K) {
      dm_long_issue<TN>(A, m, B, n, K, k0 + DM_BK, vec,
                        smem + (buf ^ 1) * STAGE);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int kt = K - k0 < DM_BK ? K - k0 : DM_BK;
    dm_mma_smem<TN, DM_BK>(acc, A.kmajor, B.kmajor, kt, smem + buf * STAGE);
    __syncthreads();                 // the buffer is free for the k-tile after next
    buf ^= 1;
  }
}

// Row of accumulator c[v] (h = v >> 1) of row block mi, and the first of
// the two adjacent columns (v & 1) of column block ni, in a 64 x 16 TN
// tile.
__device__ __forceinline__ int dm_row(int mi, int h) {
  return (threadIdx.x / 32 % 2) * 32 + mi * 16 + threadIdx.x % 32 / 4 + 8 * h;
}

template <int TN>
__device__ __forceinline__ int dm_col(int ni) {
  return (threadIdx.x / 64) * (4 * TN) + ni * 8 + (threadIdx.x % 4) * 2;
}

// 2 consecutive elements p[0..valid) (zero beyond), through L2; and their
// store: 16 bytes when vec and valid >= 2.
__device__ __forceinline__ void dm_ld2(const double* p, bool vec, int valid,
                                       double* v) {
  if (vec && valid >= 2) {
    const double2 x = __ldcg(reinterpret_cast<const double2*>(p));
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = valid > 0 ? __ldcg(p) : 0.0;
    v[1] = valid > 1 ? __ldcg(p + 1) : 0.0;
  }
}

__device__ __forceinline__ void dm_st2(double* p, bool vec, int valid,
                                       const double* v) {
  if (vec && valid >= 2) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
    if (valid > 0) p[0] = v[0];
    if (valid > 1) p[1] = v[1];
  }
}

// C (m x n) = A B (mode 0), -= A B (mode 1, only c <= r when lower) or
// = -A B (mode 2), all in shared memory with any leading dimensions and
// m, n, K <= 32: A (m x K) row-major, B (K x n) row-major, or B^T stored
// (n x K) row-major when BT.  Warp v takes the 16 x 8 output blocks v,
// v + 8, ...; fragments past m, n or K read as zero.  C must not overlap
// A or B.  All threads call it.
template <bool BT>
__device__ void dm_smem_mm(double* C, int ldc, const double* A, int lda,
                           const double* B, int ldb, int m, int n, int K,
                           int mode, bool lower) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  const int mb = (m + 15) / 16, nb = (n + 7) / 8;
  for (int it = warp; it < mb * nb; it += FG_THREADS / 32) {
    const int r0 = (it % mb) * 16, c0 = (it / mb) * 8;
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    for (int k0 = 0; k0 < K; k0 += 8) {
      double a[4], b[2];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = r0 + g + 8 * (v & 1), k = k0 + q + 4 * (v >> 1);
        a[v] = r < m && k < K ? A[r * lda + k] : 0.0;
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int c = c0 + g, k = k0 + q + 4 * v;
        b[v] = c < n && k < K ? (BT ? B[c * ldb + k] : B[k * ldb + c]) : 0.0;
      }
      dmma_16x8x8(acc, a, b);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = r0 + g + 8 * (v >> 1), c = c0 + 2 * q + (v & 1);
      if (r >= m || c >= n || (lower && c > r)) continue;
      C[r * ldc + c] = mode == 0 ? acc[v]
                       : (mode == 1 ? C[r * ldc + c] - acc[v] : -acc[v]);
    }
  }
}

}  // namespace
