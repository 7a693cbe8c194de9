// Shared device code of the per-entity Gram kernels (csrc/fused_gram_cross.cu,
// csrc/gram_sections.cu): the Gram passes over a tile's z rows in shared
// memory (IEEE FMA; bf16 tensor-core products in the "split" and "bf16"
// modes, by mma.sync, or by wgmma for squares of D >= kWgmmaMinD), the
// carry walk, and the launchers of kernels 1, 2 and 3.  What they compute,
// what bounds them and how they are designed is set out at the top of
// fused_gram_cross.cu.  Everything here has internal linkage, so each
// source that includes it compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// The Gram pass's arithmetic (the TPU kernel's fast_matmul modes): IEEE
// FMA; "split", three bf16 products hi.hi + hi.lo + lo.hi of each operand's
// hi = bf16(x) and lo = bf16(x - hi) into one f32 sum; "bf16", hi.hi alone.
constexpr int kModeIEEE = 0;
constexpr int kModeSplit = 1;
constexpr int kModeBf16 = 2;
// 16 x 8 output fragments a warp holds in registers in one round of the
// tensor-core pass (16 a round: rank 32's square, 11 fragments, takes
// one, its VI rectangle, 39, three, the rank-128 square, 89, six; a round
// costs a walk of the run list), and the blocks per SM its kernels are
// compiled for (<= 64 registers).
constexpr int kMmaFrags = 2;
constexpr int kMmaBlocks = 4;

constexpr int kMaxCross = 8;
constexpr int kMaxSlots = 64;  // the per-thread "slot written" mask is 64 bits
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Kernel 1's rectangle pass: loads each thread keeps in flight while
// staging a tile, and blocks per SM its fp32 kernel is compiled for
// (<= 80 registers; it takes ~110 without the cap, which leaves 2
// blocks).  Its square kernels ask for no minimum (0): a cap made them
// slower.  Kernel 3's fp32 kernel is held to kRowsBlocks blocks per SM
// (<= 48 registers; 59 without), its fp64 kernel is not (PERF.md).
constexpr int kStageBatch = 4;
constexpr int kRectBlocks = 3;
constexpr int kRowsBlocks = 5;
// The square's register block (2 x 2 beat 3 x 3 and 4 x 4 at D = 34).
constexpr int kSquareBlock = 2;
// The wgmma pass: the smallest square it takes (one 64-row band) and its
// blocks per SM (<= 128 registers; shared memory allows 2 at rank 128, T =
// 128); ring_rows below gives the z rows of its fp32 stage chunk and bf16
// ring.
constexpr int kWgmmaMinD = 64;
constexpr int kWgmmaBlocks = 2;
// The carry walk: entries per block (one per thread), the fewest and the
// most tiles in a segment, and the blocks (segments x slices of entries)
// that carry_seg below keeps segments short enough to give.
constexpr int kCarryThreads = 64;
constexpr int kCarrySegMin = 16;
constexpr int kCarrySegMax = 128;
constexpr int kCarryFill = 264;  // 2 per SM of an H100 SXM (132 SMs)
// The Gram passes, as myfm_gram_pass names them.
constexpr int kPassFma = 0;
constexpr int kPassMma = 1;
constexpr int kPassWgmma = 2;

// Rows of the wgmma pass's fp32 stage chunk and bf16 ring in a mode:
// "split" holds two rings (hi, lo), so its chunk is halved to keep two
// blocks per SM at rank 128.
__host__ __device__ constexpr int ring_rows(int mode) {
  return mode == kModeSplit ? 64 : 128;
}

// Tiles per segment of the carry walk over K tiles of E entries per
// slot: the longest of 128, 64, 32, 16 that still gives kCarryFill blocks,
// so a call of few tiles spreads over the SMs instead of walking long
// segments in a handful of blocks; at most 64 where E >= 4096 (rank 128:
// 128 measured slower, a block holds 2 x segment x kCarryThreads values
// in shared memory).  At rank 32's 4,096-tile calls it is 128 (256
// measured slower).
__host__ __device__ constexpr int carry_seg(int K, int E) {
  const int nslice = (E + kCarryThreads - 1) / kCarryThreads;
  int G = E >= 4096 ? 64 : kCarrySegMax;
  while (G > kCarrySegMin && ((K + G - 1) / G) * nslice < kCarryFill) G /= 2;
  return G;
}

template <typename F>
struct CrossPtrs {
  const F* p[kMaxCross];
};

// The run list of one chunk of rows: the maximal runs of equal valid slot
// (in [0, S)) among rows [base, base + kThreads), in row order.  A run
// that the chunk's edge cuts continues in the next chunk's first run.
struct RunList {
  int lo[kThreads];
  int hi[kThreads];
  int slot[kThreads];
  int n_lo[kWarps];
  int n_hi[kWarps];
};

// s + q * q with the product and the sum each rounded (never contracted
// to an fma): the sums of squares in a z row's e, taken in the order and
// rounding of the plain version (ops/gram.py _sum_sq), so both build the
// same e bit for bit and a reduced Gram mode's bf16 rounding of it agrees.
__device__ __forceinline__ float add_sq(float s, float q) {
  return __fadd_rn(s, __fmul_rn(q, q));
}
__device__ __forceinline__ double add_sq(double s, double q) {
  return __dadd_rn(s, __dmul_rn(q, q));
}

// Every thread of the block (blockDim.x == kThreads) calls this; returns
// the number of runs.  Each thread tests one row for the start and the
// end of a run, and a ballot per warp plus a prefix over the warps
// places the runs in row order.
__device__ int build_runs(const int* slot, int T, int S, int base,
                          RunList& rl) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = base + tid;
  const int end = min(T, base + kThreads);
  int s = -1;
  if (t < end) s = slot[t];
  const bool valid = t < end && s >= 0 && s < S;
  const bool first = valid && (t == base || slot[t - 1] != s);
  const bool last = valid && (t == end - 1 || slot[t + 1] != s);
  const unsigned m_lo = __ballot_sync(0xffffffffu, first);
  const unsigned m_hi = __ballot_sync(0xffffffffu, last);
  if (lane == 0) {
    rl.n_lo[warp] = __popc(m_lo);
    rl.n_hi[warp] = __popc(m_hi);
  }
  __syncthreads();
  int off_lo = 0, off_hi = 0, n = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      off_lo += rl.n_lo[w];
      off_hi += rl.n_hi[w];
    }
    n += rl.n_lo[w];
  }
  const unsigned below = (1u << lane) - 1u;
  if (first) {
    const int r = off_lo + __popc(m_lo & below);
    rl.lo[r] = t;
    rl.slot[r] = s;
  }
  if (last) rl.hi[off_hi + __popc(m_hi & below)] = t + 1;
  __syncthreads();
  return n;
}

// A thread's TB x TB register block into one slot's Gram o: set, or added
// where an earlier run of the slot already wrote it (slots out of order).
// In the square an off-diagonal block also writes its transpose.
template <typename F, int TB, bool kSquare>
__device__ __forceinline__ void store_block(F* o, const F (&acc)[TB][TB],
                                            int bi, int bj, int NI, int NJ,
                                            int out_rows, int D,
                                            bool again) {
#pragma unroll
  for (int m = 0; m < TB; ++m) {
    const int i = bi + m * NI;
#pragma unroll
    for (int n = 0; n < TB; ++n) {
      const int j = bj + n * NJ;
      if (i < out_rows && j < D) {
        F* e = o + (size_t)i * D + j;
        *e = again ? *e + acc[m][n] : acc[m][n];
        if (kSquare && bi != bj) {
          F* t = o + (size_t)j * D + i;
          *t = again ? *t + acc[m][n] : acc[m][n];
        }
      }
    }
  }
}

// Every slot's partial Gram [out_rows, D] over the tile's z rows (row
// pitch P in shared memory) in TB x TB register blocks; a row whose slot
// is outside [0, S) counts nowhere.  The block grid is NI x NJ (NI =
// ceil(out_rows / TB), NJ = ceil(D / TB)); block (bi, bj) owns rows
// bi + m NI and columns bj + n NJ, so the threads of a warp read
// consecutive z columns (no bank conflicts) and write consecutive output
// columns.  Edge entries read a clamped column and are not written.
//   kSquare (out_rows == D, so NI == NJ): the transpose of block (bi, bj)
//     is block (bj, bi), so only the triangle bi >= bj is computed (p =
//     bi (bi + 1) / 2 + bj) and each value is written at (i, j) and
//     (j, i); a diagonal block is its own transpose.
//   else: the whole rectangle, p = bi NJ + bj.
template <typename F, int TB, bool kSquare>
__device__ void grams_tiled(const F* z, int P, const int* slot, int T, int S,
                            int D, int out_rows, F* out_tile, RunList& rl) {
  const int NI = (out_rows + TB - 1) / TB;
  const int NJ = (D + TB - 1) / TB;
  const int n_blocks = kSquare ? NI * (NI + 1) / 2 : NI * NJ;
  const size_t per_slot = (size_t)out_rows * D;
  for (int p0 = 0; p0 < n_blocks; p0 += kThreads) {
    const int p = p0 + threadIdx.x;
    const bool owns = p < n_blocks;
    int bi = 0, bj = 0;
    if (owns) {
      if constexpr (kSquare) {
        while ((bi + 1) * (bi + 2) / 2 <= p) ++bi;
        bj = p - bi * (bi + 1) / 2;
      } else {
        bi = p / NJ;
        bj = p % NJ;
      }
    }
    int ci[TB], cj[TB];
#pragma unroll
    for (int m = 0; m < TB; ++m) ci[m] = min(bi + m * NI, out_rows - 1);
#pragma unroll
    for (int n = 0; n < TB; ++n) cj[n] = min(bj + n * NJ, D - 1);
    F acc[TB][TB];
    uint64_t written = 0;
    int cur = -1, prev_hi = -1;

    for (int base = 0; base < T; base += kThreads) {
      const int n_runs = build_runs(slot, T, S, base, rl);
      if (owns) {
        for (int r = 0; r < n_runs; ++r) {
          const int lo = rl.lo[r], hi = rl.hi[r], s = rl.slot[r];
          if (s != cur || lo != prev_hi) {
            if (cur >= 0) {
              store_block<F, TB, kSquare>(out_tile + cur * per_slot, acc, bi,
                                          bj, NI, NJ, out_rows, D,
                                          (written >> cur) & 1ull);
              written |= 1ull << cur;
            }
            cur = s;
#pragma unroll
            for (int m = 0; m < TB; ++m) {
#pragma unroll
              for (int n = 0; n < TB; ++n) acc[m][n] = F(0);
            }
          }
          // one pointer per operand column, stepped by the row pitch (the
          // compiler then issues one add per shared load, not index math)
          const F* pa[TB];
          const F* pb[TB];
#pragma unroll
          for (int m = 0; m < TB; ++m) pa[m] = z + (size_t)lo * P + ci[m];
#pragma unroll
          for (int n = 0; n < TB; ++n) pb[n] = z + (size_t)lo * P + cj[n];
#pragma unroll 4
          for (int t = lo; t < hi; ++t) {
            F a[TB], b[TB];
#pragma unroll
            for (int m = 0; m < TB; ++m) {
              a[m] = *pa[m];
              pa[m] += P;
            }
#pragma unroll
            for (int n = 0; n < TB; ++n) {
              b[n] = *pb[n];
              pb[n] += P;
            }
#pragma unroll
            for (int m = 0; m < TB; ++m) {
#pragma unroll
              for (int n = 0; n < TB; ++n) {
                acc[m][n] = fma(a[m], b[n], acc[m][n]);
              }
            }
          }
          prev_hi = hi;
        }
      }
      __syncthreads();  // the next chunk rebuilds the run list
    }
    if (!owns) continue;
    if (cur >= 0) {
      store_block<F, TB, kSquare>(out_tile + cur * per_slot, acc, bi, bj, NI,
                                  NJ, out_rows, D, (written >> cur) & 1ull);
      written |= 1ull << cur;
    }
#pragma unroll
    for (int m = 0; m < TB; ++m) {
#pragma unroll
      for (int n = 0; n < TB; ++n) acc[m][n] = F(0);
    }
    for (int s = 0; s < S; ++s) {
      if (!((written >> s) & 1ull)) {
        store_block<F, TB, kSquare>(out_tile + s * per_slot, acc, bi, bj, NI,
                                    NJ, out_rows, D, false);
      }
    }
  }
}

// Two bf16 values in one 32-bit register, the lower index in the low half
// (the operand layout of mma.sync).
__device__ __forceinline__ uint32_t bf16x2(__nv_bfloat16 lo_half,
                                           __nv_bfloat16 hi_half) {
  return (uint32_t)__bfloat16_as_ushort(lo_half) |
         ((uint32_t)__bfloat16_as_ushort(hi_half) << 16);
}

// One warp's operand fragment of an 8-column block of z over a 16-row
// k-chunk: lane (g = lane / 4, q = lane % 4) holds rows t0 + 2q, +1 (reg
// 0) and t0 + 2q + 8, +9 (reg 1) of column c (clamped to D - 1; rows at or
// beyond hi are zero, so a chunk never reaches outside its run).  It is
// the B fragment of mma.m16n8k16 for output columns [8 cb, 8 cb + 8), and
// two of them (blocks 2 mb, 2 mb + 1) are the A fragment of output rows
// [16 mb, 16 mb + 16): A = z^T and B = z read the same rows.  kMode split
// also gives lo = bf16(x - hi).
template <int kMode>
__device__ __forceinline__ void col_frag(const float* z, int P, int t0,
                                         int hi, int c, uint32_t (&fh)[2],
                                         uint32_t (&fl)[2]) {
  const int lane = threadIdx.x & 31;
  const int r = t0 + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r0 = r + 8 * h;
    const float x0 = r0 < hi ? z[(size_t)r0 * P + c] : 0.f;
    const float x1 = r0 + 1 < hi ? z[(size_t)(r0 + 1) * P + c] : 0.f;
    const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
    const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
    fh[h] = bf16x2(h0, h1);
    if constexpr (kMode == kModeSplit) {
      fl[h] = bf16x2(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                     __float2bfloat16_rn(x1 - __bfloat162float(h1)));
    }
  }
}

// c += A B for one m16n8k16 bf16 product with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A lane's four accumulator entries of fragment (mb, nb) into one slot's
// Gram o: set, or added where the slot recurs.  Entries outside [out_rows,
// D] are not written; in the square only i >= j is, with its mirror, so
// every entry has one writer and the Gram is exactly symmetric.
template <bool kSquare>
__device__ __forceinline__ void store_frag(float* o, const float (&c)[4],
                                           int mb, int nb, int out_rows,
                                           int D, bool again) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 16 * mb + (lane >> 2) + 8 * (e >> 1);
    const int j = 8 * nb + 2 * (lane & 3) + (e & 1);
    if (i < out_rows && j < D && (!kSquare || i >= j)) {
      float* p = o + (size_t)i * D + j;
      *p = again ? *p + c[e] : c[e];
      if (kSquare && i != j) {
        float* m = o + (size_t)j * D + i;
        *m = again ? *m + c[e] : c[e];
      }
    }
  }
}

// Fragments in row block mb of the tensor-core pass's list: NB, or in
// the square those holding an entry i >= j (nb <= 2 mb + 1).
template <bool kSquare>
__device__ __forceinline__ int frags_in_row(int mb, int NB) {
  return kSquare ? min(2 * mb + 2, NB) : NB;
}

// Stores a warp's n fragments, from (mb, nb) on in list order, into one
// slot's Gram o (store_frag each).
template <bool kSquare>
__device__ __forceinline__ void store_frags(float* o,
                                            const float (&acc)[kMmaFrags][4],
                                            int mb, int nb, int n, int NB,
                                            int out_rows, int D, bool again) {
#pragma unroll
  for (int q = 0; q < kMmaFrags; ++q) {
    if (q < n) {
      store_frag<kSquare>(o, acc[q], mb, nb, out_rows, D, again);
      if (++nb == frags_in_row<kSquare>(mb, NB)) {
        ++mb;
        nb = 0;
      }
    }
  }
}

// The tensor-core Gram pass ("split" or "bf16"; fp32 z): every slot's
// partial Gram [out_rows, D] as 16 x 8 fragments of mma.m16n8k16 (bf16
// operands, f32 accumulation).  The fragments are listed row-major over
// (mb, nb); the square keeps only those holding an entry i >= j.  Each
// round hands each warp a contiguous share of up to kMmaFrags fragments,
// whose accumulators stay in registers across a slot's k-chunks; the warp
// walks the same run list as the IEEE pass and, per run, 16-row k-chunks
// of that run's rows only (the rows beyond the run's end read as zero),
// so the work is the slot's rows, not the tile's times S.  An A fragment
// is rebuilt only where the row block changes.  Accumulators are flushed
// at a slot's run end as in the IEEE pass.
template <int kMode, bool kSquare>
__device__ void grams_mma(const float* z, int P, const int* slot, int T,
                          int S, int D, int out_rows, float* out_tile,
                          RunList& rl) {
  const int MB = (out_rows + 15) / 16;
  const int NB = (D + 7) / 8;
  int n_frag = 0;
  for (int mb = 0; mb < MB; ++mb) n_frag += frags_in_row<kSquare>(mb, NB);
  const int warp = threadIdx.x >> 5;
  const int col = (threadIdx.x & 31) >> 2;  // the lane's column in a block
  const size_t per_slot = (size_t)out_rows * D;
  for (int f0 = 0; f0 < n_frag; f0 += kWarps * kMmaFrags) {
    const int n_round = min(n_frag - f0, kWarps * kMmaFrags);
    const int fpw = (n_round + kWarps - 1) / kWarps;
    // this warp's share: n_mine fragments from (mb0, nb0) on
    const int first = warp * fpw;
    const int n_mine = max(0, min(fpw, n_round - first));
    int mb0 = 0, nb0 = f0 + first;
    while (nb0 >= frags_in_row<kSquare>(mb0, NB)) {
      nb0 -= frags_in_row<kSquare>(mb0, NB);
      ++mb0;
    }
    float acc[kMmaFrags][4];
    uint64_t written = 0;
    int cur = -1, prev_hi = -1;

    for (int base = 0; base < T; base += kThreads) {
      const int n_runs = build_runs(slot, T, S, base, rl);
      for (int r = 0; r < n_runs && n_mine > 0; ++r) {
        const int lo = rl.lo[r], hi = rl.hi[r], s = rl.slot[r];
        if (s != cur || lo != prev_hi) {
          if (cur >= 0) {
            store_frags<kSquare>(out_tile + cur * per_slot, acc, mb0, nb0,
                                 n_mine, NB, out_rows, D,
                                 (written >> cur) & 1ull);
            written |= 1ull << cur;
          }
          cur = s;
#pragma unroll
          for (int q = 0; q < kMmaFrags; ++q) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
          }
        }
        for (int t0 = lo; t0 < hi; t0 += 16) {
          uint32_t ah[4], al[4];
          int a_mb = -1, mb = mb0, nb = nb0;
#pragma unroll
          for (int q = 0; q < kMmaFrags; ++q) {
            if (q < n_mine) {  // the same for the whole warp
              if (mb != a_mb) {
                a_mb = mb;
                uint32_t h0[2], l0[2], h1[2], l1[2];
                col_frag<kMode>(z, P, t0, hi, min(16 * mb + col, D - 1), h0,
                                l0);
                col_frag<kMode>(z, P, t0, hi, min(16 * mb + 8 + col, D - 1),
                                h1, l1);
                ah[0] = h0[0];
                ah[1] = h1[0];
                ah[2] = h0[1];
                ah[3] = h1[1];
                if constexpr (kMode == kModeSplit) {
                  al[0] = l0[0];
                  al[1] = l1[0];
                  al[2] = l0[1];
                  al[3] = l1[1];
                }
              }
              uint32_t bh[2], bl[2];
              col_frag<kMode>(z, P, t0, hi, min(8 * nb + col, D - 1), bh,
                              bl);
              mma_bf16(acc[q], ah, bh);
              if constexpr (kMode == kModeSplit) {
                mma_bf16(acc[q], ah, bl);
                mma_bf16(acc[q], al, bh);
              }
              if (++nb == frags_in_row<kSquare>(mb, NB)) {
                ++mb;
                nb = 0;
              }
            }
          }
        }
        prev_hi = hi;
      }
      __syncthreads();  // the next chunk rebuilds the run list
    }
    if (n_mine == 0) continue;
    if (cur >= 0) {
      store_frags<kSquare>(out_tile + cur * per_slot, acc, mb0, nb0, n_mine,
                           NB, out_rows, D, (written >> cur) & 1ull);
      written |= 1ull << cur;
    }
#pragma unroll
    for (int q = 0; q < kMmaFrags; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    }
    for (int s = 0; s < S; ++s) {
      if (!((written >> s) & 1ull)) {
        store_frags<kSquare>(out_tile + s * per_slot, acc, mb0, nb0, n_mine,
                             NB, out_rows, D, false);
      }
    }
  }
}

// The Gram pass of every pass-1 kernel: each slot's partial Gram [out_rows,
// D] of the tile's z rows.  kMode split or bf16: the tensor-core pass
// (grams_mma; fp32 only), the square's triangle or the whole rectangle.
// IEEE: every entry sums its rows in tile order with fma from 0 at each
// run of its slot, flushed (set, or added where the slot recurs) at the
// run's end, and fma(a, b, c) == fma(b, a, c): an entry and its mirror
// have the same bits whichever of them a block computes.  Every thread of
// the block calls it.  kRect (out_rows < D): 4 x 4 blocks where they keep
// at least half the threads busy (the ML-10M VI shape, [34, 98]: 225
// blocks), else 2 x 2 (ML-100k, [12, 32]: 96 blocks).  Else the square
// (out_rows == D) in kSquareBlock x kSquareBlock blocks.  A kernel
// compiles one of the two: with both, the rectangle's registers would
// bound the square's occupancy.
template <typename F, bool kRect, int kMode>
__device__ void gram_pass(const F* z, int P, const int* slot, int T, int S,
                          int D, int out_rows, F* out_tile) {
  __shared__ RunList rl;
  if constexpr (kMode != kModeIEEE) {
    grams_mma<kMode, !kRect>(z, P, slot, T, S, D, out_rows, out_tile, rl);
  } else if constexpr (!kRect) {
    grams_tiled<F, kSquareBlock, true>(z, P, slot, T, S, D, D, out_tile, rl);
  } else {
    const int n44 = ((out_rows + 3) / 4) * ((D + 3) / 4);
    if (n44 >= kThreads / 2) {
      grams_tiled<F, 4, false>(z, P, slot, T, S, D, out_rows, out_tile, rl);
    } else {
      grams_tiled<F, 2, false>(z, P, slot, T, S, D, out_rows, out_tile, rl);
    }
  }
}

// The e of kernel 1's z row over its summed gathered row [lin | .. |
// zcols | qs] (zcols from column q_lo, n_z of them; R own-factor columns
// first), for slot s; own: the tile's [S][R + 2] own [w | V | qs] rows.
template <typename F>
__device__ __forceinline__ F cross_e(const F* row, int s, F tau,
                                     const F* own, int S, int R, int q_lo,
                                     int n_z) {
  if (s < 0 || s >= S) return F(0);
  const F* o = own + (size_t)s * (R + 2);
  F sq = F(0);
  for (int r = 0; r < R; ++r) {
    const F q = row[q_lo + r] + o[1 + r];
    sq = add_sq(sq, q);
  }
  return row[0] - tau + o[0] + F(0.5) * (sq - row[q_lo + n_z] - o[R + 1]);
}

// Kernel 1's z row [valid | e | zcols], built in place by the row's thread
// (cross_e, then the zcols moved to column 2).  Every pass builds z from
// cross_e, so each builds the same bits.
template <typename F>
__device__ __forceinline__ void cross_z_row(F* row, int s, F tau,
                                            const F* own, int S, int R,
                                            int q_lo, int n_z) {
  const F e = cross_e(row, s, tau, own, S, R, q_lo, n_z);
  if (q_lo < 2) {
    for (int c = n_z - 1; c >= 0; --c) row[2 + c] = row[q_lo + c];
  } else if (q_lo > 2) {
    for (int c = 0; c < n_z; ++c) row[2 + c] = row[q_lo + c];
  }
  row[0] = s >= 0 && s < S ? F(1) : F(0);
  row[1] = e;
}

// Kernel 2's z row [ones | e | q], built in place over a row whose q
// columns are staged from column 2; m = the row's [ones | lin | qs_other],
// s its slot (S where the row counts nowhere), own the [S][R + 1] rows.
template <typename F>
__device__ __forceinline__ void meta_z_row(F* row, const F* m, int s,
                                           const F* own, int S, int R) {
  const F ones = m[0];
  F e = F(0);
  if (s < S) {
    const F* o = own + (size_t)s * (R + 1);
    F sq = F(0), so = F(0);
    for (int r = 0; r < R; ++r) {
      const F q = row[2 + r] + o[1 + r];
      sq = add_sq(sq, q);
      so = add_sq(so, o[1 + r]);
    }
    e = (m[1] + o[0] + F(0.5) * (sq - m[2] - so)) * ones;
  }
  row[0] = ones;
  row[1] = e;
}

// Kernel 2's slots of a tile's T rows: slot_in where the row counts (ones
// != 0, slot in [0, S)), else S.
template <typename F>
__device__ __forceinline__ void load_meta_slots(const F* meta,
                                                const int* slot_in, int T,
                                                int S, int* slot) {
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int s = slot_in[t];
    const bool valid = meta[(size_t)t * 3] != F(0) && s >= 0 && s < S;
    slot[t] = valid ? s : S;
  }
}

// Asynchronous copies of global memory into shared memory: one value, or
// 16 bytes.
template <typename F>
__device__ __forceinline__ void cp_async_one(F* dst, const F* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(F))
               : "memory");
}
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// The values of F in 16 bytes, and kPer of them read once (a streaming
// 16-byte load: evict first) and added to acc in index order.
template <typename F>
constexpr int kPer16 = 16 / (int)sizeof(F);
template <typename F>
__device__ __forceinline__ void add_16(F (&acc)[kPer16<F>], const F* p) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  F x[kPer16<F>];
  memcpy(x, &u, 16);
#pragma unroll
  for (int j = 0; j < kPer16<F>; ++j) acc[j] += x[j];
}

// Whether every table's rows of a call can be read in 16-byte packs: the
// tables 16-byte aligned and a chunk's elements (``elems``, each chunk
// starts at a multiple of it) a multiple of a pack.
template <typename F>
bool packs_ok(const void* const* gths, int n_cross, size_t elems) {
  bool ok = elems % kPer16<F> == 0;
  for (int c = 0; c < n_cross; ++c) {
    ok = ok && reinterpret_cast<uintptr_t>(gths[c]) % 16 == 0;
  }
  return ok;
}

// The cross sums of kernel 1's stage: elements [0, n) of the tables c_lo
// .. c_hi - 1 from offset off summed into z, z[i] = ((z0 + g[c_lo][i]) +
// ...) + g[c_hi - 1][i] with z0 = z[i] where ``add``, else 0: every pass
// sums its rows in this order, so each builds the same z as the plain
// version.  kBatch elements (or 16-byte packs, where ``packs``) per thread
// are in flight at once; the gathered rows are read once, with streaming
// loads (evict first), so the L2 keeps the Grams the pass writes (pass 1
// at rank 128 measured ~10% faster, PERF.md).  The tables are indexed
// statically (an unrolled loop), so the pointer array stays in kernel-
// parameter space instead of a local-memory copy.  Every thread of the
// block (blockDim.x == kThreads) calls it.
template <typename F, int kBatch>
__device__ __forceinline__ void stage_cross(F* z, const CrossPtrs<F>& g,
                                            int c_lo, int c_hi, size_t off,
                                            int n, bool packs, bool add) {
  constexpr int kPer = kPer16<F>;
  int done = 0;
  if (packs) {
    const int np = n / kPer;
    for (int i0 = threadIdx.x; i0 < np; i0 += kBatch * kThreads) {
      F acc[kBatch][kPer];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          acc[u][j] = add && i < np ? z[(size_t)i * kPer + j] : F(0);
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxCross; ++c) {
        if (c >= c_lo && c < c_hi) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * kThreads;
            if (i < np) add_16<F>(acc[u], g.p[c] + off + (size_t)i * kPer);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < np) {
          uint4 v;
          memcpy(&v, acc[u], 16);
          *reinterpret_cast<uint4*>(z + (size_t)i * kPer) = v;
        }
      }
    }
    done = np * kPer;
  }
  for (int i0 = done + threadIdx.x; i0 < n; i0 += kBatch * kThreads) {
    F acc[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      acc[u] = add && i < n ? z[i] : F(0);
    }
#pragma unroll
    for (int c = 0; c < kMaxCross; ++c) {
      if (c >= c_lo && c < c_hi) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < n) acc[u] += __ldcs(g.p[c] + off + i);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) z[i] = acc[u];
    }
  }
}

// Pass 1 of the cross entry point: one block per tile -> its S partial
// Grams (no carry).  kRect: out_rows < D (the rectangle, whose fp32 IEEE
// code is held to kRectBlocks blocks per SM), else the full square; kMode
// the Gram pass's arithmetic (its tensor-core code held to kMmaBlocks);
// packs: the tables can be read in 16-byte packs (packs_ok).
template <typename F, bool kRect, int kMode>
__global__ void __launch_bounds__(
    kThreads, kMode != kModeIEEE ? kMmaBlocks
              : kRect && sizeof(F) == 4 ? kRectBlocks : 0)
gram_tile_kernel(const F* __restrict__ aux2, CrossPtrs<F> gths, int n_cross,
                 const F* __restrict__ wvsl, F* __restrict__ out, int T,
                 int S, int R, int q_lo, int n_extra, int out_rows,
                 bool packs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_z = R + n_extra;
  const int D = n_z + 2;
  const int W = q_lo + n_z + 1;  // gathered row width (>= D: q_lo >= 1)
  const int Wo = R + 2;          // own [w | V | qs] row width
  F* z = reinterpret_cast<F*>(smem_raw);  // [T][W]
  F* own = z + (size_t)T * W;             // [S][Wo]
  int* slot = reinterpret_cast<int*>(own + (size_t)S * Wo);  // [T]

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t tile_off = (size_t)k * T * W;

  // the cross sums, kStageBatch elements per thread in flight (the IEEE
  // square's stage lost to the batch in fp32, and kernel 2's at the VI
  // shapes, so it loads one at a time; the tensor-core kernels, at fewer
  // blocks per SM, batch)
  constexpr int kBatch = kRect || kMode != kModeIEEE ? kStageBatch : 1;
  stage_cross<F, kBatch>(z, gths, 0, n_cross, tile_off, T * W, packs,
                         false);
  for (int i = tid; i < S * Wo; i += blockDim.x) {
    own[i] = wvsl[(size_t)k * S * Wo + i];
  }
  const F* slot_row = aux2 + (size_t)k * 2 * T;
  const F* tau_row = slot_row + T;
  for (int t = tid; t < T; t += blockDim.x) slot[t] = (int)slot_row[t];
  __syncthreads();

  for (int t = tid; t < T; t += blockDim.x) {
    cross_z_row(z + (size_t)t * W, slot[t], tau_row[t], own, S, R, q_lo,
                n_z);
  }
  __syncthreads();

  gram_pass<F, kRect, kMode>(z, W, slot, T, S, D, out_rows,
                             out + (size_t)k * S * out_rows * D);
}

// Pass 1 of the meta entry point: one block per tile -> its S partial
// Grams (no carry); kRect and kMode as in gram_tile_kernel (no register
// cap on the IEEE code here: kernel 2 loses to it, kernel 1 gains).
template <typename F, bool kRect, int kMode>
__global__ void __launch_bounds__(kThreads,
                                  kMode != kModeIEEE ? kMmaBlocks : 0)
gram_meta_tile_kernel(const F* __restrict__ meta, const F* __restrict__ qo,
                      const int* __restrict__ slot_in,
                      const F* __restrict__ wvsl, F* __restrict__ out, int T,
                      int S, int R, int Rq, int out_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = Rq + 2;
  const int Wo = R + 1;  // own [w | V] row width
  F* z = reinterpret_cast<F*>(smem_raw);  // [T][D]
  F* own = z + (size_t)T * D;             // [S][Wo]
  int* slot = reinterpret_cast<int*>(own + (size_t)S * Wo);  // [T]

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)k * T;

  // a compile-time stride (the block is kThreads wide): kernel 2's
  // rectangle kernel measured faster with it than with blockDim.x
  for (int i = tid; i < T * Rq; i += kThreads) {
    const int t = i / Rq;
    z[(size_t)t * D + 2 + (i - t * Rq)] = qo[row0 * Rq + i];
  }
  for (int i = tid; i < S * Wo; i += blockDim.x) {
    own[i] = wvsl[(size_t)k * S * Wo + i];
  }
  load_meta_slots(meta + row0 * 3, slot_in + row0, T, S, slot);
  __syncthreads();

  for (int t = tid; t < T; t += blockDim.x) {
    meta_z_row(z + (size_t)t * D, meta + (row0 + t) * 3, slot[t], own, S, R);
  }
  __syncthreads();

  gram_pass<F, kRect, kMode>(z, D, slot, T, S, D, out_rows,
                             out + (size_t)k * S * out_rows * D);
}

// Pass 1 of the rows entry point (kernel 3): one block per tile copies its
// [T, D] rows (pad rows are zero rows) and their slots into shared memory
// -> its S partial Gram squares (no carry).
template <typename F>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(F) == 4 ? kRowsBlocks : 0)
gram_rows_tile_kernel(const F* __restrict__ rows,
                      const int* __restrict__ slot_in, F* __restrict__ out,
                      int T, int S, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F* z = reinterpret_cast<F*>(smem_raw);                 // [T][D]
  int* slot = reinterpret_cast<int*>(z + (size_t)T * D);  // [T]
  const int k = blockIdx.x;
  const size_t row0 = (size_t)k * T;
  for (int i = threadIdx.x; i < T * D; i += blockDim.x) {
    z[i] = rows[row0 * D + i];
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    slot[t] = slot_in[row0 + t];
  }
  __syncthreads();
  gram_pass<F, false, kModeIEEE>(z, D, slot, T, S, D, D,
                                 out + (size_t)k * S * D * D);
}

// ---- the wgmma pass: squares of D >= kWgmmaMinD in "split" and "bf16" ----
//
// The rows of one run of a slot (at most ring_rows(mode), cut at the fp32
// stage chunk's edges) are written once as bf16 into a ring in shared
// memory in wgmma's K-major no-swizzle layout: 8 x 8 core matrices of 128 contiguous
// bytes (8 z columns d, each 8 consecutive rows t), the core matrices of
// one 8-column group for all the ring's rows contiguous (LBO = 128 B
// along t, SBO = rows / 8 * 128 B along d).  Rows past the run up to the
// next 16 and columns past D up to Dp = D rounded up to 8 are zero, so no
// other slot's row enters and a 16-row k-step never reaches outside the
// run.  A = z^T and B = z are the same ring: G[m0 + m, n0 + n] = sum_t
// z[t, m0 + m] z[t, n0 + n] is one m64n64k16 wgmma per k-step from two
// descriptors into the same bytes ("split" adds hi.lo and lo.hi from the
// lo ring).  The square's lower triangle is cut into 64 x 64 blocks (bi,
// bj), bj <= bi < nb = ceil(D / 64); block (bi, bj) computes rows m0 =
// min(64 bi, Dp - 64) and columns n0 = min(64 bj, Dp - 64) on, so the last
// band overlaps the one before it instead of reading zero rows past Dp,
// and stores only its own entries (i in [64 bi, 64 bi + 64), j in [64 bj,
// 64 bj + 64), i >= j, below D) with their mirrors.  The two warpgroups
// take alternate blocks; a block's 32 accumulators per thread live for one
// run, and are stored (set, or added where the slot recurs) at its end.

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma that owns them.
__device__ __forceinline__ void wgmma_hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Makes this thread's shared-memory writes visible to wgmma (the async
// proxy); a block barrier after it orders them for every thread.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The shared-memory descriptor of a K-major no-swizzle operand starting at
// p (16-byte aligned): start address, LBO and SBO in 16-byte units, layout
// type 0 (no swizzle), base offset 0.
template <int kRows>
__device__ __forceinline__ uint64_t ring_desc(const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  constexpr uint64_t kLbo = 128 >> 4;
  constexpr uint64_t kSbo = (kRows / 8 * 128) >> 4;
  return (uint64_t)((a >> 4) & 0x3FFF) | (kLbo << 16) | (kSbo << 32);
}

// The operand of columns c0 .. c0 + 63 over k-step ks (rows 16 ks ..) of
// a ring of kRows rows.
template <int kRows>
__device__ __forceinline__ uint64_t ring_at(const __nv_bfloat16* ring,
                                            int c0, int ks) {
  return ring_desc<kRows>(ring +
                          ((size_t)(c0 >> 3) * (kRows / 8) + 2 * ks) * 64);
}

// d += A B for one m64n64k16 bf16 product with f32 accumulation, A and B
// from shared memory, both K-major.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Rows [lo, hi) of the fp32 stage chunk into ring rows [0, hi - lo) as
// bf16 hi (and, for split, lo = bf16(x - hi)), zero up to 16 nk rows and
// from column D up to Dp.  Chunk row t's z value in column d is head[2 t +
// d] for d < 2 where head is given (kernel 1: [valid, e] kept apart, so
// the zcols are read where they were loaded, zc[t P + q_lo + d - 2]), else
// zc[t P + d] (kernel 2's z rows, built in place; q_lo = 2).  One 16-byte
// store per (column, 8-row group): a quarter warp fills one core matrix.
// Every thread of the block calls it.
template <int kMode>
__device__ void stage_ring(const float* zc, int P, const float* head,
                           int q_lo, int lo, int hi, int D, int Dp, int nk,
                           __nv_bfloat16* ring_hi, __nv_bfloat16* ring_lo) {
  const int items = Dp * 2 * nk;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int d = i % Dp;
    const int g = i / Dp;
    const bool col = d < D;
    const float* src = head != nullptr && d < 2 ? head + d
                                                : zc + (q_lo - 2) + d;
    const int pitch = head != nullptr && d < 2 ? 2 : P;
    uint32_t h[4], l[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = lo + 8 * g + 2 * c;
      const float x0 = col && t < hi ? src[(size_t)t * pitch] : 0.f;
      const float x1 = col && t + 1 < hi ? src[(size_t)(t + 1) * pitch] : 0.f;
      const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
      const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
      h[c] = bf16x2(h0, h1);
      if constexpr (kMode == kModeSplit) {
        l[c] = bf16x2(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                      __float2bfloat16_rn(x1 - __bfloat162float(h1)));
      }
    }
    const size_t off =
        ((size_t)(d >> 3) * (ring_rows(kMode) / 8) + g) * 64 + (d & 7) * 8;
    *reinterpret_cast<uint4*>(ring_hi + off) =
        make_uint4(h[0], h[1], h[2], h[3]);
    if constexpr (kMode == kModeSplit) {
      *reinterpret_cast<uint4*>(ring_lo + off) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// A warpgroup's accumulators of block (bi, bj) (computed at rows m0 and
// columns n0 on) into one slot's Gram o [D, D]: the block's own entries
// with i >= j, each with its mirror; set, or added where the slot recurs
// (its earlier value read first for all 32 entries, then stored: an entry
// and its mirror hold the same bits).
__device__ __forceinline__ void store_wg_block(float* o, const float (&d)[32],
                                               int bi, int bj, int m0,
                                               int n0, int D, bool again) {
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int i_lo = 64 * bi, i_hi = min(64 * bi + 64, D);
  const int j_lo = 64 * bj, j_hi = min(64 * bj + 64, D);
  float prev[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    const int i = m0 + 16 * (t >> 5) + (lane >> 2) + 8 * ((v >> 1) & 1);
    const int j = n0 + 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
    const bool own = i >= i_lo && i < i_hi && j >= j_lo && j < j_hi && i >= j;
    prev[v] = again && own ? o[(size_t)i * D + j] : 0.f;
  }
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    const int i = m0 + 16 * (t >> 5) + (lane >> 2) + 8 * ((v >> 1) & 1);
    const int j = n0 + 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
    if (i >= i_lo && i < i_hi && j >= j_lo && j < j_hi && i >= j) {
      const float x = again ? prev[v] + d[v] : d[v];
      o[(size_t)i * D + j] = x;
      if (i != j) o[(size_t)j * D + i] = x;
    }
  }
}

// The wgmma Gram pass over the runs of one stage chunk: the z rows [c0,
// c0 + n) of the tile, staged in zc (row pitch P; chunk row t - c0) and
// head as stage_ring reads them.  Each run (build_runs: maximal rows of
// one valid slot, cut at the chunk's edges) is staged in the ring, then
// each warpgroup runs its blocks over it and stores them into slot s (set,
// or added where ``written`` says the slot was stored before).  Every
// thread of the block calls it.
template <int kMode>
__device__ void wgmma_chunk(const float* zc, int P, const float* head,
                            int q_lo, const int* slot, int c0, int n, int S,
                            int D, __nv_bfloat16* ring_hi,
                            __nv_bfloat16* ring_lo, float* out_tile,
                            uint64_t& written, RunList& rl) {
  const int Dp = (D + 7) & ~7;
  const int nb = (D + 63) / 64;
  const int n_blocks = nb * (nb + 1) / 2;
  const int wg = threadIdx.x >> 7;
  const size_t per_slot = (size_t)D * D;
  const int n_runs = build_runs(slot, c0 + n, S, c0, rl);
  for (int r = 0; r < n_runs; ++r) {
    const int lo = rl.lo[r] - c0, hi = rl.hi[r] - c0, s = rl.slot[r];
    const int nk = (hi - lo + 15) / 16;
    stage_ring<kMode>(zc, P, head, q_lo, lo, hi, D, Dp, nk, ring_hi,
                      ring_lo);
    fence_to_async();
    __syncthreads();
    const bool again = (written >> s) & 1ull;
    for (int p = wg; p < n_blocks; p += kThreads / 128) {
      int bi = 0;
      while ((bi + 1) * (bi + 2) / 2 <= p) ++bi;
      const int bj = p - bi * (bi + 1) / 2;
      const int m0 = min(64 * bi, Dp - 64);
      const int n0 = min(64 * bj, Dp - 64);
      float acc[32];
#pragma unroll
      for (int v = 0; v < 32; ++v) acc[v] = 0.f;
      wgmma_hold(acc);
      wgmma_fence();
      constexpr int kRows = ring_rows(kMode);
      for (int ks = 0; ks < nk; ++ks) {
        wgmma_64x64(acc, ring_at<kRows>(ring_hi, m0, ks),
                    ring_at<kRows>(ring_hi, n0, ks));
        if constexpr (kMode == kModeSplit) {
          wgmma_64x64(acc, ring_at<kRows>(ring_hi, m0, ks),
                      ring_at<kRows>(ring_lo, n0, ks));
          wgmma_64x64(acc, ring_at<kRows>(ring_lo, m0, ks),
                      ring_at<kRows>(ring_hi, n0, ks));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      wgmma_hold(acc);
      store_wg_block(out_tile + s * per_slot, acc, bi, bj, m0, n0, D, again);
    }
    written |= 1ull << s;
    __syncthreads();  // the next run rewrites the ring
  }
}

// Zeros into every slot Gram [D, D] that no run stored.
__device__ __forceinline__ void zero_unwritten(float* out_tile, int S, int D,
                                               uint64_t written) {
  const size_t per_slot = (size_t)D * D;
  for (int s = 0; s < S; ++s) {
    if (!((written >> s) & 1ull)) {
      float* o = out_tile + s * per_slot;
      for (size_t i = threadIdx.x; i < per_slot; i += blockDim.x) o[i] = 0.f;
    }
  }
}

// Bytes of the wgmma kernels' ring(s), which open their dynamic shared
// memory (the fp32 stage chunk [min(T, ring_rows(mode))][P] follows).
__host__ __device__ __forceinline__ size_t ring_bytes(int D, int mode) {
  const size_t one = (size_t)((D + 7) & ~7) * ring_rows(mode) * 2;
  return mode == kModeSplit ? 2 * one : one;
}

// Pass 1 of the cross entry point on the wgmma pass (fp32, the square,
// D >= kWgmmaMinD): one block per tile, the stage of gram_tile_kernel cut
// into ring_rows-row chunks (stage_cross: the same cross sums in the same
// order, the same z rows).  packs: every table's rows can be read in
// 16-byte packs (packs_ok).  The loads of a chunk finish before its z
// build starts: copying the next chunk's tables ahead with cp.async while
// the products and stores run (blocks persistent over their tiles) took
// 5-8% longer at rank 128, and two tables ahead at one block per SM no
// less (PERF.md); the other resident block's loads already overlap this
// one's products and stores.
template <typename F, int kMode>
__global__ void __launch_bounds__(kThreads, kWgmmaBlocks)
gram_wgmma_tile_kernel(const F* __restrict__ aux2, CrossPtrs<F> gths,
                       int n_cross, const F* __restrict__ wvsl,
                       F* __restrict__ out, int T, int S, int R, int q_lo,
                       int n_extra, bool packs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_z = R + n_extra;
  const int D = n_z + 2;
  const int W = q_lo + n_z + 1;
  const int Wo = R + 2;
  constexpr int kRows = ring_rows(kMode);
  const int C = min(T, kRows);
  const size_t rb = ring_bytes(D, kMode);
  __nv_bfloat16* ring_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring_lo = ring_hi + rb / 4;  // the second half (split)
  F* zc = reinterpret_cast<F*>(smem_raw + rb);    // [C][W]
  F* head = zc + (size_t)C * W;                   // [C][2]: valid, e
  F* own = head + (size_t)C * 2;                  // [S][Wo]
  int* slot = reinterpret_cast<int*>(own + (size_t)S * Wo);  // [T]

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < S * Wo; i += blockDim.x) {
    own[i] = wvsl[(size_t)k * S * Wo + i];
  }
  const F* slot_row = aux2 + (size_t)k * 2 * T;
  const F* tau_row = slot_row + T;
  for (int t = tid; t < T; t += blockDim.x) slot[t] = (int)slot_row[t];
  F* out_tile = out + (size_t)k * S * D * D;

  __shared__ RunList rl;
  uint64_t written = 0;
  for (int c0 = 0; c0 < T; c0 += kRows) {
    const int n = min(kRows, T - c0);
    stage_cross<F, kStageBatch>(zc, gths, 0, n_cross,
                                ((size_t)k * T + c0) * W, n * W, packs,
                                false);
    __syncthreads();
    for (int t = tid; t < n; t += blockDim.x) {
      const int s = slot[c0 + t];
      head[2 * t] = s >= 0 && s < S ? F(1) : F(0);
      head[2 * t + 1] = cross_e(zc + (size_t)t * W, s, tau_row[c0 + t], own,
                                S, R, q_lo, n_z);
    }
    __syncthreads();
    wgmma_chunk<kMode>(zc, W, head, q_lo, slot, c0, n, S, D, ring_hi,
                       ring_lo, out_tile, written, rl);
  }
  zero_unwritten(out_tile, S, D, written);
}

// Pass 1 of the meta entry point on the wgmma pass (fp32, the square,
// D >= kWgmmaMinD), its stage cut into ring_rows-row chunks likewise.
template <typename F, int kMode>
__global__ void __launch_bounds__(kThreads, kWgmmaBlocks)
gram_meta_wgmma_tile_kernel(const F* __restrict__ meta,
                            const F* __restrict__ qo,
                            const int* __restrict__ slot_in,
                            const F* __restrict__ wvsl, F* __restrict__ out,
                            int T, int S, int R, int Rq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = Rq + 2;
  const int Wo = R + 1;
  constexpr int kRows = ring_rows(kMode);
  const int C = min(T, kRows);
  const size_t rb = ring_bytes(D, kMode);
  __nv_bfloat16* ring_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring_lo = ring_hi + rb / 4;
  F* zc = reinterpret_cast<F*>(smem_raw + rb);    // [C][D]
  F* own = zc + (size_t)C * D;                    // [S][Wo]
  int* slot = reinterpret_cast<int*>(own + (size_t)S * Wo);  // [T]

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)k * T;
  for (int i = tid; i < S * Wo; i += blockDim.x) {
    own[i] = wvsl[(size_t)k * S * Wo + i];
  }
  load_meta_slots(meta + row0 * 3, slot_in + row0, T, S, slot);
  __syncthreads();
  F* out_tile = out + (size_t)k * S * D * D;

  __shared__ RunList rl;
  uint64_t written = 0;
  for (int c0 = 0; c0 < T; c0 += kRows) {
    const int n = min(kRows, T - c0);
    for (int i = tid; i < n * Rq; i += kThreads) {
      const int t = i / Rq;
      zc[(size_t)t * D + 2 + (i - t * Rq)] = qo[(row0 + c0) * Rq + i];
    }
    __syncthreads();
    for (int t = tid; t < n; t += blockDim.x) {
      meta_z_row(zc + (size_t)t * D, meta + (row0 + c0 + t) * 3,
                 slot[c0 + t], own, S, R);
    }
    __syncthreads();
    wgmma_chunk<kMode>(zc, D, nullptr, 2, slot, c0, n, S, D, ring_hi,
                       ring_lo, out_tile, written, rl);
  }
  zero_unwritten(out_tile, S, D, written);
}

// Which Gram pass a pass-1 launch of this shape and mode runs: the wgmma
// pass for fp32 squares of D >= kWgmmaMinD in split or bf16, mma.sync for
// the other reduced-mode launches, FMA in IEEE.
__host__ __device__ __forceinline__ int gram_pass_id(int mode, int D,
                                                     int out_rows) {
  if (mode == kModeIEEE) return kPassFma;
  return out_rows == D && D >= kWgmmaMinD ? kPassWgmma : kPassMma;
}

// ---- the carry: one in-order walk over the tiles after pass 1 ----
//
// The TPU kernel's grid runs in tile order and threads each entity's
// running Gram through a scratch buffer; the plain version states it as
//   for k in tile order:
//     if cont_in[k]:  out[k, 0] = out[k, 0] + c
//     if cont_out[k]: c = out[k, last_slot[k]]
// (c starts at carry_in; carry_out is c after the last tile).  The walk
// does exactly that, entry by entry, so every sum is taken in the same
// order and with the same rounding as the plain version: kCarryThreads
// entries per block (one per thread), carry_seg tiles per segment, one
// block per (segment, slice of entries), taken in ticket order (an atomic
// on a counter, which touches no value), so a block only ever waits for a
// block that has already started.  Tile k "resets" the carry where the
// carry leaving it does not depend on the one entering it: cont_out[k]
// and not (cont_in[k] and last_slot[k] == 0).  A block first copies its
// operands into shared memory (cp.async: out[k, 0] where cont_in[k],
// out[k, last_slot[k]] where k resets), then walks the tiles from its
// first reset on, which needs nothing from earlier segments, and
// publishes the carry leaving the segment (seg_carry, then a flag with
// release semantics); then, if a tile before that reset takes the carry
// (or the segment has no reset), it waits for the previous segment's flag
// and walks those tiles.  Only chains of tiles that cross a segment edge
// wait, one hop per segment.  No atomics on values, so every run gives the
// same bits.

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// The carry leaving segment seg: carry_out after the last segment, else
// into seg_carry and then the segment's flag (release: the values first).
// Every thread of the block calls it.
template <typename F>
__device__ void publish_carry(F c, int seg, int nseg, int slice, int nslice,
                              int e, int E, bool live, F* carry_out,
                              F* seg_carry, int* flags) {
  if (seg == nseg - 1) {
    if (live) carry_out[e] = c;
    return;
  }
  if (live) seg_carry[(size_t)seg * E + e] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // the block's values (ordered by the barrier) first
    st_release(flags + seg * nslice + slice, 1);
  }
}

// A tile's flags in the walk (one byte per tile in shared memory):
// cont_in; "keep" (the carry leaving the tile is its slot-0 sum:
// cont_in, cont_out and last slot 0); "reset" (cont_out otherwise: the
// carry leaving it does not depend on the one entering it).
constexpr int kTileIn = 1;
constexpr int kTileKeep = 2;
constexpr int kTileReset = 4;

// Walks tiles [j0, j1) of a segment from carry c, in tile order: where
// cont_in, out[k, 0] = pre0 + c; then c = that sum where "keep", or pre1
// where the tile resets.  Returns the carry leaving tile j1 - 1.
template <typename F>
__device__ __forceinline__ F walk_tiles(F c, int j0, int j1,
                                        const unsigned char* tf,
                                        const F* pre0, const F* pre1, F* o,
                                        size_t stride, bool live) {
  const int tid = threadIdx.x;
#pragma unroll 8
  for (int j = j0; j < j1; ++j) {
    const int f = tf[j];
    const F v = pre0[j * kCarryThreads + tid] + c;
    if ((f & kTileIn) && live) o[j * stride] = v;
    c = (f & kTileKeep) ? v
        : (f & kTileReset) ? pre1[j * kCarryThreads + tid]
                           : c;
  }
  return c;
}

template <typename F>
__global__ void __launch_bounds__(kCarryThreads)
carry_walk_kernel(F* __restrict__ out, const int* __restrict__ cont_in,
                  const int* __restrict__ cont_out,
                  const int* __restrict__ last_slot,
                  const F* __restrict__ carry_in, F* __restrict__ carry_out,
                  F* __restrict__ seg_carry, int* __restrict__ sync, int K,
                  int S, int E, int nslice) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = carry_seg(K, E);
  F* pre0 = reinterpret_cast<F*>(smem_raw);  // [G][threads]
  F* pre1 = pre0 + G * kCarryThreads;        // [G][threads]
  __shared__ int s_ticket;
  __shared__ unsigned char s_tf[kCarrySegMax];
  __shared__ int s_ls[kCarrySegMax];
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int seg = s_ticket / nslice;
  const int slice = s_ticket - seg * nslice;
  const int nseg = (K + G - 1) / G;
  const int k0 = seg * G;
  const int n = min(G, K - k0);
  const int e0 = slice * kCarryThreads;
  const int e = e0 + tid;
  const bool live = e < E;
  int* flags = sync + 1;

  for (int j = tid; j < n; j += kCarryThreads) {
    const bool ci = cont_in[k0 + j] != 0;
    const bool co = cont_out[k0 + j] != 0;
    const int ls = last_slot[k0 + j];
    s_tf[j] = (ci ? kTileIn : 0) | (ci && co && ls == 0 ? kTileKeep : 0) |
              (co && !(ci && ls == 0) ? kTileReset : 0);
    s_ls[j] = ls;
  }
  __syncthreads();
  // the segment's operands into shared memory: out[k, 0] where cont_in,
  // out[k, last_slot] where the tile resets.  A tile's entries of this
  // block are contiguous, so where E * sizeof(F) is a multiple of 16 they
  // go as 16-byte copies (the last block's entries end at E), else one
  // value per thread.
  const size_t stride = (size_t)S * E;
  const F* base = out + (size_t)k0 * stride;
  if ((E * sizeof(F)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(F);
    constexpr int kParts = kCarryThreads / kPer;
    for (int i = tid; i < n * kParts; i += kCarryThreads) {
      const int j = i / kParts;
      const int q = (i - j * kParts) * kPer;
      if (e0 + q < E) {
        const int f = s_tf[j];
        const F* row = base + j * stride + e0 + q;
        if (f & kTileIn) cp_async_16(pre0 + j * kCarryThreads + q, row);
        if (f & kTileReset) {
          cp_async_16(pre1 + j * kCarryThreads + q, row + (size_t)s_ls[j] * E);
        }
      }
    }
  } else if (live) {
    for (int j = 0; j < n; ++j) {
      const int f = s_tf[j];
      const F* row = base + j * stride + e;
      if (f & kTileIn) cp_async_one(pre0 + j * kCarryThreads + tid, row);
      if (f & kTileReset) {
        cp_async_one(pre1 + j * kCarryThreads + tid,
                     row + (size_t)s_ls[j] * E);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the first reset, and whether a tile up to it takes the entering carry
  int first = n;
  bool need_in = false;
  for (int j = 0; j < n; ++j) {
    const int f = s_tf[j];
    need_in = need_in || (f & kTileIn);
    if (f & kTileReset) {
      first = j;
      break;
    }
  }
  need_in = need_in || first == n;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the copies of other threads
  F* o = out + (size_t)k0 * stride + e;

  // tiles after the first reset: their carry starts there
  if (first < n) {
    const F c = walk_tiles(live ? pre1[first * kCarryThreads + tid] : F(0),
                           first + 1, n, s_tf, pre0, pre1, o, stride, live);
    publish_carry(c, seg, nseg, slice, nslice, e, E, live, carry_out,
                  seg_carry, flags);
  }
  // tiles up to the first reset: the carry entering the segment (tile
  // "first" only adds it: the carry leaving it was taken above)
  if (need_in) {
    F c = F(0);
    if (seg == 0) {
      if (live) c = carry_in[e];
    } else {
      if (tid == 0) {
        while (ld_acquire(flags + (seg - 1) * nslice + slice) == 0) {
          __nanosleep(32);
        }
      }
      __syncthreads();
      if (live) c = __ldcg(seg_carry + (size_t)(seg - 1) * E + e);
    }
    c = walk_tiles(c, 0, first < n ? first + 1 : n, s_tf, pre0, pre1, o,
                   stride, live);
    if (first == n) {
      publish_carry(c, seg, nseg, slice, nslice, e, E, live, carry_out,
                    seg_carry, flags);
    }
  }
}

// The carry walk over K tiles of E entries per slot (out [K, S, E] holds
// pass 1's partials); seg_carry holds ceil(K / G) * E values, sync 1 +
// ceil(K / G) * ceil(E / kCarryThreads) ints, zeroed by the caller (G =
// carry_seg(K, E)).
template <typename F>
int carry_walk(F* out, const int* cont_in, const int* cont_out,
               const int* last_slot, const void* carry_in, void* carry_out,
               void* seg_carry, int* sync, int K, int S, int E,
               cudaStream_t st) {
  const int G = carry_seg(K, E);
  const int nseg = (K + G - 1) / G;
  const int nslice = (E + kCarryThreads - 1) / kCarryThreads;
  const size_t smem = 2 * (size_t)G * kCarryThreads * sizeof(F);
  cudaError_t err = cudaFuncSetAttribute(
      carry_walk_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  carry_walk_kernel<F><<<nseg * nslice, kCarryThreads, smem, st>>>(
      out, cont_in, cont_out, last_slot, static_cast<const F*>(carry_in),
      static_cast<F*>(carry_out), static_cast<F*>(seg_carry), sync, K, S, E,
      nslice);
  return (int)cudaGetLastError();
}

// Whether mode names an arithmetic the dtype has: every mode for fp32,
// IEEE alone for fp64 (there is no fp64 tensor-core path).
template <typename F>
bool mode_ok(int mode) {
  return mode == kModeIEEE ||
         (sizeof(F) == 4 && (mode == kModeSplit || mode == kModeBf16));
}

// The pass-1 kernel of one (layout, mode); the caller checked mode_ok.
template <typename F, bool kRect>
auto cross_kernel(int mode) {
  if constexpr (sizeof(F) == 4) {
    if (mode == kModeSplit) return gram_tile_kernel<F, kRect, kModeSplit>;
    if (mode == kModeBf16) return gram_tile_kernel<F, kRect, kModeBf16>;
  }
  return gram_tile_kernel<F, kRect, kModeIEEE>;
}

template <typename F, bool kRect>
auto meta_kernel(int mode) {
  if constexpr (sizeof(F) == 4) {
    if (mode == kModeSplit) return gram_meta_tile_kernel<F, kRect, kModeSplit>;
    if (mode == kModeBf16) return gram_meta_tile_kernel<F, kRect, kModeBf16>;
  }
  return gram_meta_tile_kernel<F, kRect, kModeIEEE>;
}

// The wgmma pass-1 kernels of one reduced mode (fp32; the caller checked
// gram_pass_id == kPassWgmma).
template <typename F>
auto cross_wgmma_kernel(int mode) {
  return mode == kModeSplit ? gram_wgmma_tile_kernel<F, kModeSplit>
                            : gram_wgmma_tile_kernel<F, kModeBf16>;
}
template <typename F>
auto meta_wgmma_kernel(int mode) {
  return mode == kModeSplit ? gram_meta_wgmma_tile_kernel<F, kModeSplit>
                            : gram_meta_wgmma_tile_kernel<F, kModeBf16>;
}

// Opts kernel in to smem bytes of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Kernel 1's Gram pass alone (no carry): validates, sizes and opts in to
// the shared-memory stage, launches the pass-1 kernel that gram_pass_id
// names for (mode, D, out_rows).  The per-section timing (gram_sections.cu,
// level 2) launches exactly this.
template <typename F>
int launch_cross_grams(const void* aux2, const void* const* gths,
                       int n_cross, const void* wvsl, void* out, int K, int T,
                       int S, int R, int q_lo, int n_extra, int out_rows,
                       int mode, cudaStream_t st) {
  const int D = R + n_extra + 2;
  if (n_cross < 0 || n_cross > kMaxCross || S < 1 || S > kMaxSlots ||
      K < 1 || T < 1 || R < 0 || q_lo < 1 || n_extra < 0 || out_rows < 1 ||
      out_rows > D || !mode_ok<F>(mode)) {
    return (int)cudaErrorInvalidValue;
  }
  const int W = q_lo + R + n_extra + 1;
  CrossPtrs<F> cp;
  for (int c = 0; c < kMaxCross; ++c) {
    cp.p[c] = c < n_cross ? static_cast<const F*>(gths[c]) : nullptr;
  }
  const size_t own = (size_t)S * (R + 2) * sizeof(F) + (size_t)T * sizeof(int);
  const bool packs = packs_ok<F>(gths, n_cross, (size_t)T * W);
  if constexpr (sizeof(F) == 4) {
    if (gram_pass_id(mode, D, out_rows) == kPassWgmma) {
      const size_t smem = ring_bytes(D, mode) +
                          (size_t)min(T, ring_rows(mode)) * (W + 2) *
                              sizeof(F) +
                          own;
      const auto kernel = cross_wgmma_kernel<F>(mode);
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<K, kThreads, smem, st>>>(
          static_cast<const F*>(aux2), cp, n_cross,
          static_cast<const F*>(wvsl), static_cast<F*>(out), T, S, R, q_lo,
          n_extra, packs);
      return (int)cudaGetLastError();
    }
  }
  const size_t smem = (size_t)T * W * sizeof(F) + own;
  const auto kernel = out_rows < D ? cross_kernel<F, true>(mode)
                                    : cross_kernel<F, false>(mode);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<K, kThreads, smem, st>>>(
      static_cast<const F*>(aux2), cp, n_cross, static_cast<const F*>(wvsl),
      static_cast<F*>(out), T, S, R, q_lo, n_extra, out_rows, packs);
  return (int)cudaGetLastError();
}

template <typename F>
int launch_cross(const void* aux2, const void* const* gths, int n_cross,
                 const void* wvsl, const int* cont_in, const int* cont_out,
                 const int* last_slot, const void* carry_in, void* out,
                 void* carry_out, void* scratch, int* sync, int K, int T,
                 int S, int R, int q_lo, int n_extra, int out_rows, int mode,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_cross_grams<F>(aux2, gths, n_cross, wvsl, out, K, T,
                                        S, R, q_lo, n_extra, out_rows, mode,
                                        st);
  if (err != 0) return err;
  return carry_walk<F>(static_cast<F*>(out), cont_in, cont_out, last_slot,
                       carry_in, carry_out, scratch, sync, K, S,
                       out_rows * (R + n_extra + 2), st);
}

template <typename F>
int launch_meta(const void* meta, const void* q_other, const int* slot,
                const void* wvsl, const int* cont_in, const int* cont_out,
                const int* last_slot, const void* carry_in, void* out,
                void* carry_out, void* scratch, int* sync, int K, int T,
                int S, int R, int Rq, int out_rows, int mode, void* stream) {
  const int D = Rq + 2;
  if (S < 1 || S > kMaxSlots || K < 1 || T < 1 || R < 0 || Rq < R ||
      out_rows < 1 || out_rows > D || !mode_ok<F>(mode)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  F* o = static_cast<F*>(out);
  const size_t own = (size_t)S * (R + 1) * sizeof(F) + (size_t)T * sizeof(int);
  bool done = false;
  if constexpr (sizeof(F) == 4) {
    if (gram_pass_id(mode, D, out_rows) == kPassWgmma) {
      const size_t smem = ring_bytes(D, mode) +
                          (size_t)min(T, ring_rows(mode)) * D * sizeof(F) +
                          own;
      const auto kernel = meta_wgmma_kernel<F>(mode);
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<K, kThreads, smem, st>>>(
          static_cast<const F*>(meta), static_cast<const F*>(q_other), slot,
          static_cast<const F*>(wvsl), o, T, S, R, Rq);
      done = true;
    }
  }
  if (!done) {
    const size_t smem = (size_t)T * D * sizeof(F) + own;
    const auto kernel = out_rows < D ? meta_kernel<F, true>(mode)
                                      : meta_kernel<F, false>(mode);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<K, kThreads, smem, st>>>(
        static_cast<const F*>(meta), static_cast<const F*>(q_other), slot,
        static_cast<const F*>(wvsl), o, T, S, R, Rq, out_rows);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return carry_walk<F>(o, cont_in, cont_out, last_slot, carry_in, carry_out,
                       scratch, sync, K, S, out_rows * D, st);
}

template <typename F>
int launch_rows(const void* rows, const int* slot, const int* cont_in,
                const int* cont_out, const int* last_slot,
                const void* carry_in, void* out, void* carry_out,
                void* scratch, int* sync, int K, int T, int S, int D,
                void* stream) {
  if (S < 1 || S > kMaxSlots || K < 1 || T < 1 || D < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)T * D * sizeof(F) + (size_t)T * sizeof(int);
  cudaError_t err = allow_smem(gram_rows_tile_kernel<F>, smem);
  if (err != cudaSuccess) return (int)err;
  F* o = static_cast<F*>(out);
  gram_rows_tile_kernel<F><<<K, kThreads, smem, st>>>(
      static_cast<const F*>(rows), slot, o, T, S, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return carry_walk<F>(o, cont_in, cont_out, last_slot, carry_in, carry_out,
                       scratch, sync, K, S, D * D, st);
}

}  // namespace
