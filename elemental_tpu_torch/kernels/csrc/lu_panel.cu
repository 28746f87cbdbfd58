// lu_panel: partial-pivot LU of an (M, nbw) panel, M >= nbw, for Hopper
// (sm_90a), float and double.
//
// Replaces the Pallas kernel elemental_tpu/kernels/lu_panel.py::lu_panel
// (body _lu_panel_kernel), which keeps the whole padded panel in a TPU
// core's VMEM and runs the column recurrence in one launch.  The main
// path's first panel is 32768 x 2048 float (256 MiB): it does not fit one
// CTA's 227 KB, so the panel stays in device memory and the kernel computes
// the same function blocked at two levels, as the plain version
// _panel_lu(P, nbw, None, (OB, inner)) does (OB = 128, inner <= CW = 64):
// the same pivot sequence in exact arithmetic (the first maximum of |v|
// over rows >= j, NaN above every number, as torch.argmax takes it), whole
// panel rows swapped, the column scaled by division (no reciprocal, no
// zero guard: a singular panel gives the plain version's inf/NaN), the
// packed L\U up to rounding, and the composed permutation.
//
// Per outer block of ob <= OB columns [so, eo), on the caller's stream:
//
//   per inner chunk of cw = inner columns [s, e):
//   factor_chunk   ONE cooperative launch (at most one CTA per SM, all
//                  resident).  CTA b owns a slab of rows of [s, M), its
//                  cw columns in shared memory when they fit, else worked
//                  on in place in device memory (no size limit).  Column
//                  j, after the barrier that closes column j - 1:
//                    - every thread reads column j's pivot key, one load
//                      (float: one 64-bit word that every CTA raised with
//                      atomicMax, (bits(|v|) << 32) | (0xffffffff - row),
//                      NaN made one bit pattern above +inf, so the word's
//                      order is the search's; double, whose |v| and row do
//                      not fit one word: the same pair as a 128-bit key
//                      raised by a compare-and-swap loop on
//                      atom.cas.b128), then the pivot row's chunk, which
//                      the owner of p (known from the slab arithmetic)
//                      published, and row
//                      j's; the owners of rows j and p store the swap;
//                    - one fused pass over the slab: column j scaled,
//                      column j + 1 updated and searched, so the CTA knows
//                      its candidate for column j + 1 at once; it publishes
//                      the candidate row and (the owner) row j + 1, with
//                      column j's update applied as they are published,
//                      raises the key and arrives at a split grid barrier
//                      (grid_sync.cuh: a counter that only grows);
//                    - between arrive and wait, the rest of column j's
//                      rank-1 update (columns j + 2 .. e - 1): look-ahead
//                      inside the spine, overlapping the others' arrivals.
//                  Then the chunk's swaps reach the outer block's other
//                  columns: the composed permutation of the <= 2 cw rows
//                  the chunk displaced, gathered and scattered as whole
//                  row runs (one more barrier), not 64 dependent swaps.
//   trsm_kernel    U12 = L11^{-1} A12 on the rest of the outer block, by
//                  8-row blocks, L11 in shared memory;
//   update_kernel  A22 -= L21 U12 on the rest of the outer block (K = cw;
//                  65536 x 128 float is 32 MiB, resident in the 50 MB L2).
//
//   then, when the panel has columns outside the outer block:
//   outer_gather / outer_scatter  the outer block's composed swaps on
//                  columns [0, so) and [eo, nbw), <= 2 ob rows;
//   U12 = L11^{-1} A12 over rows [so, eo), columns [eo, nbw): the chunks'
//                  unit-lower solves and, between them, K = cw products;
//   update_kernel  A22 -= L21 U12 over rows [eo, M), columns [eo, nbw),
//                  K = 128: the panel's right part streams once per 128
//                  columns, not once per 64.
//
// perm_kernel composes the nbw swaps into the length-M permutation: output
// row i came from input row tau_0(tau_1(...tau_{nbw-1}(i))), tau_j the swap
// (j, piv[j]).  Every float product runs on the register tiles of
// fast_gemm.cuh (tile_mma for K = 128; tile_mma_short, every k-tile
// requested at once, for K <= 64), full-precision FMA, 16-byte loads and
// epilogues; every double product on its FP64 tensor-core tiles
// (dm_update_kernel: dm_tile_mma, mma.sync m16n8k8 f64, 32-deep k-tiles
// staged by cp.async, two in flight), each product an IEEE fused
// multiply-add.  The unit-lower solves stay on the CUDA cores.  Nothing
// is allocated here (the wrapper passes the scratch), nothing
// synchronizes with the host, and no library is called.  Each entry point
// returns the first cudaError_t that is not cudaSuccess.
//
// Bound.  The least work is M nbw^2 - nbw^3/3 flops against 2 M nbw
// elements moved (the panel read once, the factor written once).  At
// M = 32768, nbw = 2048 float: 1.35e11 flop, ~2.0 ms at the data-sheet
// 67 TFLOP/s FP32, against 537 MB, ~0.16 ms at 3.35 TB/s: compute-bound.
// What keeps the kernel from it is the spine, nbw dependent column steps
// each ending at a grid-wide barrier, and the outer products' CUDA-core
// rate.  The first design spent ~6 us a column (a reduction of G
// candidates and a second dependent read behind each grid.sync(), seven
// block barriers, the whole rank-1 update before the next search), ~60 us
// a chunk replaying 64 swaps one after another on the other columns, and
// streamed the panel's right part once per 64 columns at K = 64 (23.4 ms
// in all on an H100 SXM at 700 W).  This design takes ~10.6 ms there: the
// spine ~2.6 us a column (~5.6 ms with each chunk's load, first search and
// replay), the outer products ~3.9 ms (~33 TFLOP/s: K = 128 is eight
// k-tiles, so each tile's prologue and epilogue weigh), the solves, the
// inner products and the gathers ~0.8 ms.
//
// The double route (the lu example's 16384 x 1024 panel: 0.25 ms at the
// data-sheet 67 TFLOP/s of the FP64 tensor cores) was float's instantiated
// for double: ~7.7 ms, ~4.9 us a column, 2.6 of them each warp's reduction
// of the 132 CTAs' candidates behind every barrier, and its products on
// the FMA pipe (1.8 ms for the K = 128 updates).  It now reads one key as
// float does (raising it costs ~1.2 us a column more than float's
// atomicMax in publish and wait), keeps its candidates as (bits, row)
// pairs (integer compares, no NaN tests), and runs its products on DMMA
// (0.72 ms): ~5.1 ms.

#include <cuda_runtime.h>

#include <cstddef>

#include "fast_gemm.cuh"
#include "grid_sync.cuh"

namespace {

constexpr int CW = 64;               // widest inner chunk
constexpr int OB = 128;              // outer block
constexpr int SROW = CW + 1;         // row stride of a slab in shared memory
constexpr int THREADS = 256;         // per CTA of factor_chunk
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_CTA = 64;     // fewest rows worth a CTA
constexpr int TRSM_THREADS = 256;    // 8 warps: CW rows of 32 columns
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct LCfg;
template <>
struct LCfg<float> {
  static constexpr int TM = 8;       // 128-row tiles
};
template <>
struct LCfg<double> {
  static constexpr int TM = 4;       // 64-row tiles
};

// x - l u.  Every copy of an updated entry (the slab's, a published row's)
// comes from this expression, so the copies agree.  float: rounded once
// (a fused multiply-add).  double: the product rounded, then the
// difference, as the plain version's x - l u: rounded once, an update can
// break an exact tie of the plain version's (two rows at 1.5) the other
// way, and the pivot sequence must be the plain version's tie for tie.
__device__ __forceinline__ float upd(float x, float l, float u) {
  return __fmaf_rn(-l, u, x);
}
__device__ __forceinline__ double upd(double x, double l, double u) {
  return __dsub_rn(x, __dmul_rn(l, u));
}

// A pivot candidate: offer() takes a value and its row, merge() keeps the
// better of two, warp_best() the warp's best, row() is the winner's row
// (-1 for none).  Both order (|v|, row) as unsigned words: the bits of |v|
// (NaN made one pattern above +inf: a non-negative float's bits order as
// its value), then 0xffffffff - row, so a larger |v| wins, NaN above every
// number, and equal values go to the lower row.  float packs the two into
// one 64-bit key; double keeps them as a pair (h, l).
struct CandF {
  unsigned long long k;              // 0: no candidate
  __device__ void reset() { k = 0ull; }
  __device__ void offer(float x, int row) {
    const float a = fabsf(x);
    const unsigned bits = isnan(a) ? 0x7fc00000u : __float_as_uint(a);
    const unsigned long long key =
        ((unsigned long long)bits << 32) | (0xffffffffu - (unsigned)row);
    if (key > k) k = key;
  }
  __device__ void merge(const CandF& o) {
    if (o.k > k) k = o.k;
  }
  // the warp's best, in every lane: the larger high word, then the
  // larger low word among the lanes that hold it
  __device__ void warp_best() {
    const unsigned hi = __reduce_max_sync(FULL, (unsigned)(k >> 32));
    const unsigned lo = __reduce_max_sync(
        FULL, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
    k = ((unsigned long long)hi << 32) | lo;
  }
  __device__ int row() const {
    return k ? (int)(0xffffffffu - (unsigned)(k & 0xffffffffull)) : -1;
  }
};

struct CandD {
  unsigned long long h;              // bits(|v|)
  unsigned l;                        // 0xffffffff - row; 0: no candidate
  __device__ void reset() {
    h = 0ull;
    l = 0u;
  }
  __device__ void take(unsigned long long oh, unsigned ol) {
    if (oh > h || (oh == h && ol > l)) {
      h = oh;
      l = ol;
    }
  }
  __device__ void offer(double x, int row) {
    const double a = fabs(x);
    take(isnan(a) ? 0x7ff8000000000000ull
                  : (unsigned long long)__double_as_longlong(a),
         0xffffffffu - (unsigned)row);
  }
  __device__ void merge(const CandD& o) { take(o.h, o.l); }
  // the warp's best, in every lane: the largest h, then the largest l
  // among the lanes that hold it
  __device__ void warp_best() {
    unsigned long long m = h;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, m, off);
      m = o > m ? o : m;
    }
    l = __reduce_max_sync(FULL, h == m ? l : 0u);
    h = m;
  }
  __device__ int row() const { return l ? (int)(0xffffffffu - l) : -1; }
};

template <typename T>
struct CandOf;
template <>
struct CandOf<float> {
  using type = CandF;
};
template <>
struct CandOf<double> {
  using type = CandD;
};

// Scratch: T: cbuf[2][gmax][CW] | jbuf[2][CW] | rb[2 CW][OB] |
// rbo[2 OB][nbw]; 64-bit words, zero on entry: key[4 nbw] | the barrier
// counter | piv[nbw] as int.
template <typename T>
struct Scratch {
  T* cbuf;                           // each CTA's candidate row, by parity
  T* jbuf;                           // row j's chunk, by parity
  T* rb;                             // a chunk's displaced rows
  T* rbo;                            // an outer block's displaced rows
  unsigned long long* key;           // column j's pivot key: key[j] (float),
                                     // key[4 j .. 4 j + 2] (double)
  unsigned* ctr;                     // grid_count_arrive's counter
  int* piv;                          // the pivot row of every column
  int gmax;
};

// Raise this CTA's candidate into column jn's key.  float: one 64-bit
// word, (bits(|v|) << 32) | (0xffffffff - row), by atomicMax.
__device__ __forceinline__ void publish_key(const CandF& c, int jn,
                                            const Scratch<float>& sc) {
  if (c.k) atomicMax(&sc.key[jn], c.k);
}

// double: a 128-bit key, high word bits(|v|) (NaN made one pattern above
// +inf: a non-negative double's bits order as its value), low word
// 0xffffffff - row (CandD's pair), raised by a compare-and-swap loop on
// atom.cas.b128.  First every CTA raises the high word alone in a word of
// its own (atomicMax, which returns the maximum before it): a CTA that
// finds a larger |v| there cannot hold the pivot and stops, so only the
// few CTAs that held the maximum when they came (the last of them, and
// every tie of it, among them) enter the loop, not all G at once.  In the
// loop the high word only grows, so a stale read of it that already beats
// the candidate ends the loop; any other stale read just fails one CAS,
// which returns the key as it stands.  (Spreading the CTAs over 4 or 8
// keys a column, each read back and reduced by a warp, was slower on an
// H100: the extra reads cost more than the contention.)
__device__ __forceinline__ void cas_b128(unsigned long long* p,
                                         unsigned long long& hi,
                                         unsigned long long& lo,
                                         unsigned long long nhi,
                                         unsigned long long nlo) {
  asm volatile(
      "{\n\t.reg .b128 c, s, o;\n\t"
      "mov.b128 c, {%0, %1};\n\t"
      "mov.b128 s, {%3, %4};\n\t"
      "atom.relaxed.gpu.global.cas.b128 o, [%2], c, s;\n\t"
      "mov.b128 {%0, %1}, o;\n\t}"
      : "+l"(lo), "+l"(hi)
      : "l"(p), "l"(nlo), "l"(nhi)
      : "memory");
}

__device__ __forceinline__ void publish_key(const CandD& c, int jn,
                                            const Scratch<double>& sc) {
  if (!c.l) return;
  unsigned long long* p = sc.key + 4 * (size_t)jn;
  const unsigned long long mh = c.h, ml = c.l;
  unsigned long long hi = atomicMax(p + 2, mh), lo = 0;
  if (hi > mh) return;                 // a larger |v| came first
  hi = __ldcg(p + 1), lo = __ldcg(p);
  while (mh > hi || (mh == hi && ml > lo)) {
    const unsigned long long eh = hi, el = lo;
    cas_b128(p, hi, lo, mh, ml);
    if (hi == eh && lo == el) break;   // ours is in
  }
}

// Column j's pivot row, the same in every thread of every CTA: the key's
// low word, one load.
__device__ __forceinline__ int resolve(int j, const Scratch<float>& sc) {
  CandF c;
  c.k = __ldcg(&sc.key[j]);
  return c.row();
}

__device__ __forceinline__ int resolve(int j, const Scratch<double>& sc) {
  const unsigned long long lo = __ldcg(&sc.key[4 * (size_t)j]);
  return lo ? (int)(0xffffffffull - lo) : -1;
}

// The CTA's best candidate, in every thread (one block barrier).
template <typename C>
__device__ __forceinline__ C block_best(C c, C* red) {
  c.warp_best();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = c;
  __syncthreads();
  C best = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) best.merge(red[w]);
  return best;
}

// Publish, for column jn, this CTA's candidate row r (warp 0) and, by its
// owner, row jn (warp 1), as they stand after step jc = jn - s - 1:
// columns up to jc + 1 are final in the slab, the others get column jc's
// update here (the slab's copy gets the same one later).  jc = -1: as
// they are.  Entry (i, c) of the slab is A[(i - r0) rs + c].
template <typename T>
__device__ __forceinline__ void publish_rows(const T* A, long long rs,
                                             int r0, int r1, int cw, int jc,
                                             const T* ush, int r, int jn,
                                             int par, const Scratch<T>& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int row = -1;
  T* dst = nullptr;
  if (warp == 0 && r >= 0) {
    row = r;
    dst = sc.cbuf + ((size_t)par * sc.gmax + blockIdx.x) * CW;
  } else if (warp == 1 && jn >= r0 && jn < r1) {
    row = jn;
    dst = sc.jbuf + par * CW;
  }
  if (row < 0) return;
  const T* a = A + (size_t)(row - r0) * rs;
  const T l = jc >= 0 ? a[jc] : T(0);
  for (int c = lane; c < cw; c += 32) {
    T v = a[c];
    if (jc >= 0 && c > jc + 1) v = upd(v, l, ush[c]);
    dst[c] = v;
  }
}

// Rows [i0, r1) of the slab, columns jc + 2 .. cw - 1: x -= l u, a warp
// per row, a lane per column (two while more than 32 remain); four rows'
// loads before their stores.
template <typename T>
__device__ __forceinline__ void rest_update(T* A, long long rs, int r0,
                                            int i0, int r1, int jc, int cw,
                                            const T* ush) {
  if (jc + 2 >= cw) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = jc + 2 + lane, c1 = c0 + 32;
  const bool h0 = c0 < cw, h1 = c1 < cw;
  const T u0 = h0 ? ush[c0] : T(0), u1 = h1 ? ush[c1] : T(0);
  int i = i0 + warp;
  for (; i + 3 * WARPS < r1; i += 4 * WARPS) {
    T* a[4];
    T l[4], x0[4], x1[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = A + (size_t)(i + q * WARPS - r0) * rs;
      l[q] = a[q][jc];
      x0[q] = h0 ? a[q][c0] : T(0);
      x1[q] = h1 ? a[q][c1] : T(0);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (h0) a[q][c0] = upd(x0[q], l[q], u0);
      if (h1) a[q][c1] = upd(x1[q], l[q], u1);
    }
  }
  for (; i < r1; i += WARPS) {
    T* a = A + (size_t)(i - r0) * rs;
    const T l = a[jc];
    if (h0) a[c0] = upd(a[c0], l, u0);
    if (h1) a[c1] = upd(a[c1], l, u1);
  }
}

// One inner chunk [s, s + cw) of the outer block [so, eo); base is the
// barrier counter's value when the launch starts.
struct Chunk {
  int s, cw, so, eo;
  unsigned base;
};

template <typename T, bool IN_SMEM>
__global__ void __launch_bounds__(THREADS)
factor_chunk(T* P, long long ld, int M, Chunk ch, Scratch<T> sc) {
  using C = typename CandOf<T>::type;
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int s = ch.s, cw = ch.cw, e = s + cw;
  const int R = (M - s + G - 1) / G;
  const int r0 = s + b * R < M ? s + b * R : M;
  const int r1 = r0 + R < M ? r0 + R : M;        // slab [r0, r1)
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ T ush[CW];                          // the pivot row's chunk
  __shared__ C red[WARPS];
  __shared__ int piv_sh[CW];
  __shared__ int dst_sh[2 * CW], src_sh[2 * CW];
  T* A = IN_SMEM ? reinterpret_cast<T*>(dyn) : P + (size_t)r0 * ld + s;
  const long long rs = IN_SMEM ? SROW : ld;
  unsigned target = ch.base;
  if (IN_SMEM)
    for (int idx = tid; idx < (r1 - r0) * cw; idx += THREADS) {
      const int i = idx / cw, c = idx % cw;
      A[(size_t)i * SROW + c] = P[(size_t)(r0 + i) * ld + s + c];
    }
  __syncthreads();

  // column s's candidates: a scan of the slab
  {
    C c;
    c.reset();
    for (int i = r0 + tid; i < r1; i += THREADS)
      c.offer(A[(size_t)(i - r0) * rs], i);
    c = block_best(c, red);
    publish_rows(A, rs, r0, r1, cw, -1, ush, c.row(), s, 0, sc);
    if (tid == 0) publish_key(c, s, sc);
    grid_count_arrive(sc.ctr);
    target += G;
    grid_count_wait(sc.ctr, target);
  }
  for (int j = s; j < e; ++j) {
    const int jc = j - s, par = jc & 1;
    const int p = resolve(j, sc);
    const int bp = (p - s) / R;                  // the CTA that owns row p
    if (tid < cw) {
      const T u = __ldcg(&sc.cbuf[((size_t)par * sc.gmax + bp) * CW + tid]);
      const T jv = __ldcg(&sc.jbuf[par * CW + tid]);
      ush[tid] = u;
      if (j >= r0 && j < r1) A[(size_t)(j - r0) * rs + tid] = u;
      if (p != j && p >= r0 && p < r1) A[(size_t)(p - r0) * rs + tid] = jv;
    }
    if (tid == 0) {
      piv_sh[jc] = p;
      if (b == 0) sc.piv[j] = p;
    }
    __syncthreads();
    const T pv = ush[jc];
    const int i0 = r0 > j + 1 ? r0 : j + 1;
    if (j + 1 < e) {
      // fused pass: column j scaled, column j + 1 updated and searched
      const T u1 = ush[jc + 1];
      C c;
      c.reset();
      for (int i = i0 + tid; i < r1; i += THREADS) {
        T* a = A + (size_t)(i - r0) * rs;
        const T l = a[jc] / pv;
        const T x = upd(a[jc + 1], l, u1);
        a[jc] = l;
        a[jc + 1] = x;
        c.offer(x, i);
      }
      c = block_best(c, red);
      publish_rows(A, rs, r0, r1, cw, jc, ush, c.row(), j + 1, par ^ 1, sc);
      if (tid == 0) publish_key(c, j + 1, sc);
      grid_count_arrive(sc.ctr);
      target += G;
      rest_update(A, rs, r0, i0, r1, jc, cw, ush);
      grid_count_wait(sc.ctr, target);
    } else {
      for (int i = i0 + tid; i < r1; i += THREADS) {
        T* a = A + (size_t)(i - r0) * rs + jc;
        *a = *a / pv;
      }
    }
  }
  __syncthreads();
  if (IN_SMEM)
    for (int idx = tid; idx < (r1 - r0) * cw; idx += THREADS) {
      const int i = idx / cw, c = idx % cw;
      P[(size_t)(r0 + i) * ld + s + c] = A[(size_t)i * SROW + c];
    }
  // The chunk's swaps on the outer block's other columns [so, s) and
  // [e, eo): row dst_t takes row src_t for the <= 2 cw rows t the chunk
  // displaced (rows s .. e - 1, then the pivot rows; a row listed twice
  // takes the same values twice).
  const int nother = (ch.eo - ch.so) - cw;
  if (nother > 0) {
    if (tid < 2 * cw) {
      const int row = tid < cw ? s + tid : piv_sh[tid - cw];
      int x = row;
      for (int q = cw - 1; q >= 0; --q) {
        const int pq = piv_sh[q], jq = s + q;
        x = x == jq ? pq : (x == pq ? jq : x);
      }
      dst_sh[tid] = row;
      src_sh[tid] = x;
    }
    __syncthreads();
    const int left = s - ch.so, total = 2 * cw * nother;
    for (int idx = b * THREADS + tid; idx < total; idx += G * THREADS) {
      const int t = idx / nother, k = idx % nother;
      const int col = k < left ? ch.so + k : e + (k - left);
      sc.rb[(size_t)t * OB + k] = __ldcg(&P[(size_t)src_sh[t] * ld + col]);
    }
    grid_count_arrive(sc.ctr);
    target += G;
    grid_count_wait(sc.ctr, target);
    for (int idx = b * THREADS + tid; idx < total; idx += G * THREADS) {
      const int t = idx / nother, k = idx % nother;
      const int col = k < left ? ch.so + k : e + (k - left);
      P[(size_t)dst_sh[t] * ld + col] = __ldcg(&sc.rb[(size_t)t * OB + k]);
    }
  }
}

// The outer block [so, so + ob)'s composed swaps on the panel's columns
// outside it, [0, so) and [so + ob, nbw): row dst_t takes row src_t for the
// <= 2 ob rows t the block displaced.  outer_gather copies them to rbo,
// outer_scatter (the next launch) writes them back, so no row is read
// after it is written.  blockIdx.y = t, a thread per column.
__device__ __forceinline__ int outer_row(const int* piv, int so, int ob,
                                         int t) {
  return t < ob ? so + t : piv[so + t - ob];
}

template <typename T>
__global__ void outer_gather(const T* P, long long ld, int nbw, int so,
                             int ob, const int* piv, T* rbo) {
  __shared__ int src;
  const int t = blockIdx.y;
  if (threadIdx.x == 0) {
    int x = outer_row(piv, so, ob, t);
#pragma unroll 8
    for (int q = ob - 1; q >= 0; --q) {
      const int pq = piv[so + q], jq = so + q;
      x = x == jq ? pq : (x == pq ? jq : x);
    }
    src = x;
  }
  __syncthreads();
  const int nout = nbw - ob;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nout) return;
  const int col = k < so ? k : k + ob;
  rbo[(size_t)t * nout + k] = P[(size_t)src * ld + col];
}

template <typename T>
__global__ void outer_scatter(T* P, long long ld, int nbw, int so, int ob,
                              const int* piv, const T* rbo) {
  const int t = blockIdx.y;
  const int nout = nbw - ob;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nout) return;
  const int col = k < so ? k : k + ob;
  P[(size_t)outer_row(piv, so, ob, t) * ld + col] = rbo[(size_t)t * nout + k];
}

// B[0:w, 0:n] := L^{-1} B for the unit-lower w x w L (w <= CW), L and B
// with leading dimension ld.  A CTA takes 32 columns of B; warp g holds
// rows [8 g, 8 g + 8) of them in registers, a lane per column.  Per block
// of 8 rows, its warp solves the 8 x 8 diagonal block and the warps below
// subtract its product (the block's rows pass through X, double buffered),
// after one block barrier: 8 short steps, not one thread's chain of
// w (w - 1) / 2 dependent updates.
template <typename T>
__global__ void __launch_bounds__(TRSM_THREADS)
trsm_kernel(const T* L, T* B, long long ld, int w, int n) {
  __shared__ T Ls[CW][CW];           // read as broadcasts: no padding
  __shared__ T X[2][8][32];
  for (int idx = threadIdx.x; idx < CW * CW; idx += TRSM_THREADS) {
    const int i = idx / CW, k = idx % CW;
    Ls[i][k] = (i < w && k < i) ? L[(size_t)i * ld + k] : T(0);
  }
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const bool live = c < n;
  T x[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = 8 * g + q;
    x[q] = (live && i < w) ? B[(size_t)i * ld + c] : T(0);
  }
  __syncthreads();
  const int blocks = (w + 7) / 8;
  for (int rb = 0; rb < blocks; ++rb) {
    if (g == rb) {
#pragma unroll
      for (int q = 1; q < 8; ++q)
#pragma unroll
        for (int k = 0; k < q; ++k) x[q] -= Ls[8 * rb + q][8 * rb + k] * x[k];
#pragma unroll
      for (int q = 0; q < 8; ++q) X[rb & 1][q][lane] = x[q];
    }
    __syncthreads();
    if (g > rb) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const T xk = X[rb & 1][k][lane];
#pragma unroll
        for (int q = 0; q < 8; ++q) x[q] -= Ls[8 * g + q][8 * rb + k] * xk;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = 8 * g + q;
    if (live && i < w) B[(size_t)i * ld + c] = x[q];
  }
}

// C (m x n, leading dimension ldc) -= A B with A (m x K) and B (K x n) both
// row-major, on the register tiles of fast_gemm.cuh: tile_mma (any K, BM x
// 128 tiles) or, SHORT, tile_mma_short (K <= CW, BM x 16 TN tiles, every
// k-tile requested at once).  Every old value of C is loaded before any
// store, 16 bytes at a time where aligned (cvec).
template <typename T, int TM, int TN, bool SHORT>
__global__ void __launch_bounds__(FG_THREADS)
update_kernel(const T* A, long long lda, const T* B, long long ldb, T* C,
              long long ldc, int m, int n, int K, int vec, int cvec) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const Op<T> a{A + (size_t)row0 * lda, lda, 0};
  const Op<T> bb{B + col0, ldb, 1};
  const int mm = m - row0 < BM ? m - row0 : BM;
  const int nn = n - col0 < BN ? n - col0 : BN;
  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
  if constexpr (SHORT)
    tile_mma_short<T, TM, TN, CW>(acc, a, mm, bb, nn, K, vec != 0,
                                  reinterpret_cast<T*>(dyn));
  else
    tile_mma<T, TM>(acc, a, mm, bb, nn, K, vec != 0,
                    reinterpret_cast<T*>(dyn));
  T* out = C + (size_t)row0 * ldc + col0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tile_row(i);
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int cc = tile_col(4 * g);
      T v[4];
      fg_ld4(out + (size_t)r * ldc + cc, cvec != 0, r < mm ? nn - cc : 0, v);
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][4 * g + t] = v[t] - acc[i][4 * g + t];
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tile_row(i);
    if (r >= mm) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int cc = tile_col(4 * g);
      T v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = acc[i][4 * g + t];
      fg_st4(out + (size_t)r * ldc + cc, cvec != 0, nn - cc, v);
    }
  }
}

// The float64 route's update_kernel: C -= A B on the FP64 tensor cores
// (DMMA), 64 x 16 TN tiles of fast_gemm.cuh's dm_tile_mma (32-deep k-tiles
// staged by cp.async, two in flight), any K.  Each thread's outputs come
// in pairs of adjacent columns: 16-byte loads and stores where aligned.
template <int TN>
__global__ void __launch_bounds__(FG_THREADS)
dm_update_kernel(const double* A, long long lda, const double* B,
                 long long ldb, double* C, long long ldc, int m, int n, int K,
                 int vec, int cvec) {
  constexpr int NI = TN / 2;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int row0 = blockIdx.y * DM_BM, col0 = blockIdx.x * 16 * TN;
  const Op<double> a{A + (size_t)row0 * lda, lda, 0};
  const Op<double> bb{B + col0, ldb, 1};
  const int mm = m - row0 < DM_BM ? m - row0 : DM_BM;
  const int nn = n - col0 < 16 * TN ? n - col0 : 16 * TN;
  double acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][ni][v] = 0.0;
  dm_tile_mma<TN>(acc, a, mm, bb, nn, K, vec != 0,
                  reinterpret_cast<double*>(dyn));
  double* out = C + (size_t)row0 * ldc + col0;
  double old[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = dm_row(mi, h), c = dm_col<TN>(ni);
        dm_ld2(out + (size_t)r * ldc + c, cvec != 0, r < mm ? nn - c : 0,
               &old[mi][ni][2 * h]);
      }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = dm_row(mi, h), c = dm_col<TN>(ni);
        if (r >= mm) continue;
        const double v[2] = {old[mi][ni][2 * h] - acc[mi][ni][2 * h],
                             old[mi][ni][2 * h + 1] - acc[mi][ni][2 * h + 1]};
        dm_st2(out + (size_t)r * ldc + c, cvec != 0, nn - c, v);
      }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// C (m x n) -= A (m x K) B (K x n): float on update_kernel<TM, TN, SHORT>,
// double on dm_update_kernel<TN> (TM and SHORT are float's).
template <typename T, int TM, int TN, bool SHORT>
cudaError_t update(cudaStream_t st, const T* A, long long lda, const T* B,
                   long long ldb, T* C, long long ldc, int m, int n, int K) {
  if (m <= 0 || n <= 0 || K <= 0) return cudaSuccess;
  if constexpr (sizeof(T) == 8) {
    constexpr size_t smem = dm_long_smem_bytes<TN>();
    cudaError_t err = cudaFuncSetAttribute(
        dm_update_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const int vec = fg_aligned(A, lda) && fg_aligned(B, ldb);
    const int cvec = fg_aligned(C, ldc);
    dm_update_kernel<TN><<<dim3(ceil_div(n, 16 * TN), ceil_div(m, DM_BM)),
                           FG_THREADS, smem, st>>>(A, lda, B, ldb, C, ldc, m,
                                                   n, K, vec, cvec);
    return cudaGetLastError();
  } else {
    constexpr int BM = 16 * TM, BN = 16 * TN;
    const size_t smem = SHORT ? fg_short_smem_bytes<T, TM, CW>()
                              : fg_smem_bytes<T, TM>();
    cudaError_t err = cudaFuncSetAttribute(
        update_kernel<T, TM, TN, SHORT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int vec = fg_aligned(A, lda) && fg_aligned(B, ldb);
    const int cvec = fg_aligned(C, ldc);
    update_kernel<T, TM, TN, SHORT>
        <<<dim3(ceil_div(n, BN), ceil_div(m, BM)), FG_THREADS, smem, st>>>(
            A, lda, B, ldb, C, ldc, m, n, K, vec, cvec);
    return cudaGetLastError();
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

long long scratch_elems(int nbw, int gmax) {
  return 2LL * gmax * CW + 2LL * CW + 2LL * CW * OB + 2LL * OB * nbw;
}

long long scratch_words(int nbw, int) {
  return 4LL * nbw + 1 + (nbw + 1) / 2;
}

template <typename T>
int lu_panel(T* P, long long ld, int M, int nbw, int inner, long long* perm,
             T* ws, unsigned long long* wz, int gmax, cudaStream_t st) {
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
  if ((err = cudaFuncGetAttributes(&fa, factor_chunk<T, true>)) != cudaSuccess)
    return err;
  const int dyn_max = smem_max - (int)fa.sharedSizeBytes;
  if ((err = cudaFuncSetAttribute(factor_chunk<T, true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dyn_max)) != cudaSuccess)
    return err;
  // at most one CTA per SM: every CTA is resident, as the barrier needs
  const int cap = gmax < sms ? gmax : sms;
  Scratch<T> sc;
  sc.cbuf = ws;
  sc.jbuf = sc.cbuf + 2 * (size_t)gmax * CW;
  sc.rb = sc.jbuf + 2 * CW;
  sc.rbo = sc.rb + 2 * (size_t)CW * OB;
  sc.key = wz;
  sc.ctr = reinterpret_cast<unsigned*>(wz + 4 * (size_t)nbw);
  sc.piv = reinterpret_cast<int*>(wz + 4 * (size_t)nbw + 1);
  sc.gmax = gmax;
  constexpr int TM = LCfg<T>::TM;
  unsigned base = 0;                   // the barrier counter so far
  for (int so = 0; so < nbw; so += OB) {
    const int ob = OB < nbw - so ? OB : nbw - so;
    const int eo = so + ob;
    for (int s = so; s < eo; s += inner) {
      const int cw = inner < eo - s ? inner : eo - s;
      const int e = s + cw;
      int G = ceil_div(M - s, ROWS_PER_CTA);
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
      Chunk ch{s, cw, so, eo, base};
      void* args[] = {&P, &ld, &M, &ch, &sc};
      err = cudaLaunchCooperativeKernel(fn, G, THREADS, args, dyn, st);
      if (err != cudaSuccess) return err;
      // the launch's barriers: column s's, one per later column, the replay's
      base += (unsigned)G * (unsigned)(cw + (ob > cw ? 1 : 0));
      if (e < eo) {
        // the rest of the outer block: U12 = L11^{-1} A12, A22 -= L21 U12
        trsm_kernel<T><<<ceil_div(eo - e, 32), TRSM_THREADS, 0,
                         st>>>(P + (size_t)s * ld + s, P + (size_t)s * ld + e,
                               ld, cw, eo - e);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        err = update<T, TM, 4, true>(st, P + (size_t)e * ld + s, ld,
                                     P + (size_t)s * ld + e, ld,
                                     P + (size_t)e * ld + e, ld, M - e,
                                     eo - e, cw);
        if (err != cudaSuccess) return err;
      }
    }
    if (nbw > ob) {
      const dim3 grid(ceil_div(nbw - ob, 256), 2 * ob);
      outer_gather<T><<<grid, 256, 0, st>>>(P, ld, nbw, so, ob, sc.piv,
                                            sc.rbo);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      outer_scatter<T><<<grid, 256, 0, st>>>(P, ld, nbw, so, ob, sc.piv,
                                             sc.rbo);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (eo < nbw) {
      // U12 = L11^{-1} A12 over rows [so, eo), columns [eo, nbw): the
      // chunks' solves, each followed by its product on the rows below it
      const int n = nbw - eo;
      for (int s = so; s < eo; s += inner) {
        const int cw = inner < eo - s ? inner : eo - s;
        const int e = s + cw;
        trsm_kernel<T><<<ceil_div(n, 32), TRSM_THREADS, 0, st>>>(
            P + (size_t)s * ld + s, P + (size_t)s * ld + eo, ld, cw, n);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        err = update<T, 4, 8, true>(st, P + (size_t)e * ld + s, ld,
                                    P + (size_t)s * ld + eo, ld,
                                    P + (size_t)e * ld + eo, ld, eo - e, n,
                                    cw);
        if (err != cudaSuccess) return err;
      }
      // A22 -= L21 U12 over rows [eo, M), K = ob
      err = update<T, TM, 8, false>(st, P + (size_t)eo * ld + so, ld,
                                    P + (size_t)so * ld + eo, ld,
                                    P + (size_t)eo * ld + eo, ld, M - eo, n,
                                    ob);
      if (err != cudaSuccess) return err;
    }
  }
  perm_kernel<<<ceil_div(M, 256), 256, 0, st>>>(sc.piv, nbw, M, perm);
  return cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes).  P is the (M, nbw) panel, row-major
// with leading dimension ld (elements), factored in place; perm receives
// the composed permutation (int64, length M).  ws holds
// lu_panel_scratch(nbw, gmax) elements of the panel's type and wz
// lu_panel_words(nbw, gmax) 64-bit words, zero on entry; gmax bounds the
// CTAs of a cooperative launch.
extern "C" long long lu_panel_scratch(int nbw, int gmax) {
  return scratch_elems(nbw, gmax);
}

extern "C" long long lu_panel_words(int nbw, int gmax) {
  return scratch_words(nbw, gmax);
}

// The three numbers behind the shared-memory slab test of the host loop
// above: out[0] the SM count (the cap on a launch's CTAs), out[1]
// cudaDevAttrMaxSharedMemoryPerBlockOptin, out[2] the static shared memory
// of factor_chunk<T, true> (T = double when dbl != 0).  A slab of
// ceil((M - s) / G) * SROW * sizeof(T) bytes stays in shared memory while it
// fits in out[1] - out[2].
extern "C" int lu_panel_smem(int dbl, int* out) {
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&out[1],
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess)
    return err;
  cudaFuncAttributes fa;
  err = dbl ? cudaFuncGetAttributes(&fa, factor_chunk<double, true>)
            : cudaFuncGetAttributes(&fa, factor_chunk<float, true>);
  if (err != cudaSuccess) return err;
  out[2] = (int)fa.sharedSizeBytes;
  return cudaSuccess;
}

extern "C" int lu_panel_f32(void* P, long long ld, int M, int nbw, int inner,
                            void* perm, void* ws, void* wz, int gmax,
                            void* stream) {
  return lu_panel<float>(static_cast<float*>(P), ld, M, nbw, inner,
                         static_cast<long long*>(perm),
                         static_cast<float*>(ws),
                         static_cast<unsigned long long*>(wz), gmax,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int lu_panel_f64(void* P, long long ld, int M, int nbw, int inner,
                            void* perm, void* ws, void* wz, int gmax,
                            void* stream) {
  return lu_panel<double>(static_cast<double*>(P), ld, M, nbw, inner,
                          static_cast<long long*>(perm),
                          static_cast<double*>(ws),
                          static_cast<unsigned long long*>(wz), gmax,
                          static_cast<cudaStream_t>(stream));
}
