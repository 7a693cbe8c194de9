// Shared device code of the per-entity Gram kernels (csrc/fused_gram_cross.cu,
// csrc/gram_sections.cu): the Gram passes over a tile's z rows in shared
// memory (IEEE FMA, or bf16 tensor-core products in the "split" and "bf16"
// modes), the three carry kernels, and the launchers of kernels 1, 2 and 3.
// What they compute, what bounds them and how they are designed is set out
// at the top of fused_gram_cross.cu.  Everything here has internal linkage,
// so each source that includes it compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int kSegTiles = 32;

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

// Pass 1 of the cross entry point: one block per tile -> its S partial
// Grams (no carry).  kRect: out_rows < D (the rectangle, whose fp32 IEEE
// code is held to kRectBlocks blocks per SM), else the full square; kMode
// the Gram pass's arithmetic (its tensor-core code held to kMmaBlocks).
template <typename F, bool kRect, int kMode>
__global__ void __launch_bounds__(
    kThreads, kMode != kModeIEEE ? kMmaBlocks
              : kRect && sizeof(F) == 4 ? kRectBlocks : 0)
gram_tile_kernel(const F* __restrict__ aux2, CrossPtrs<F> gths, int n_cross,
                 const F* __restrict__ wvsl, F* __restrict__ out, int T,
                 int S, int R, int q_lo, int n_extra, int out_rows) {
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

  // cross sums per row, coalesced over the tile's rows (the unrolled loop
  // indexes the pointer array statically, so it stays in kernel-parameter
  // space instead of a local-memory copy)
  if constexpr (kRect || kMode != kModeIEEE) {
    // kStageBatch elements per thread at once: their loads are in flight
    // together (the same sums, in the same order).  The IEEE square's
    // stage lost to it in fp32 (and kernel 2's at the VI shapes), so it
    // keeps its one-at-a-time loop; the tensor-core kernels, at fewer
    // blocks per SM, batch.
    for (int i0 = tid; i0 < T * W; i0 += kStageBatch * kThreads) {
      F acc[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) acc[u] = F(0);
#pragma unroll
      for (int c = 0; c < kMaxCross; ++c) {
        if (c < n_cross) {
#pragma unroll
          for (int u = 0; u < kStageBatch; ++u) {
            const int i = i0 + u * kThreads;
            if (i < T * W) acc[u] += gths.p[c][tile_off + i];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < T * W) z[i] = acc[u];
      }
    }
  } else {
    for (int i = tid; i < T * W; i += blockDim.x) {
      F acc = F(0);
#pragma unroll
      for (int c = 0; c < kMaxCross; ++c) {
        if (c < n_cross) acc += gths.p[c][tile_off + i];
      }
      z[i] = acc;
    }
  }
  for (int i = tid; i < S * Wo; i += blockDim.x) {
    own[i] = wvsl[(size_t)k * S * Wo + i];
  }
  const F* slot_row = aux2 + (size_t)k * 2 * T;
  const F* tau_row = slot_row + T;
  for (int t = tid; t < T; t += blockDim.x) slot[t] = (int)slot_row[t];
  __syncthreads();

  // z row = [valid | e | zcols], built in place by the row's thread
  for (int t = tid; t < T; t += blockDim.x) {
    F* row = z + (size_t)t * W;
    const int s = slot[t];
    const bool valid = s >= 0 && s < S;
    const F lin = row[0];
    const F qs = row[q_lo + n_z];
    F e = F(0);
    if (valid) {
      const F* o = own + (size_t)s * Wo;
      F sq = F(0);
      for (int r = 0; r < R; ++r) {
        const F q = row[q_lo + r] + o[1 + r];
        sq = add_sq(sq, q);
      }
      e = lin - tau_row[t] + o[0] + F(0.5) * (sq - qs - o[R + 1]);
    }
    if (q_lo < 2) {
      for (int c = n_z - 1; c >= 0; --c) row[2 + c] = row[q_lo + c];
    } else if (q_lo > 2) {
      for (int c = 0; c < n_z; ++c) row[2 + c] = row[q_lo + c];
    }
    row[0] = valid ? F(1) : F(0);
    row[1] = e;
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
  for (int t = tid; t < T; t += blockDim.x) {
    const int s = slot_in[row0 + t];
    const bool valid = meta[(row0 + t) * 3] != F(0) && s >= 0 && s < S;
    slot[t] = valid ? s : S;
  }
  __syncthreads();

  for (int t = tid; t < T; t += blockDim.x) {
    F* row = z + (size_t)t * D;
    const F* m = meta + (row0 + t) * 3;
    const F ones = m[0];
    const int s = slot[t];
    F e = F(0);
    if (s < S) {
      const F* o = own + (size_t)s * Wo;
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

// Pass 2a: the composed carry map (A, b) of each segment of tiles, on the
// E = out_rows * D entries of a slot's rectangle.
template <typename F>
__global__ void carry_segment_kernel(const F* __restrict__ out,
                                     const int* __restrict__ cont_in,
                                     const int* __restrict__ cont_out,
                                     const int* __restrict__ last_slot,
                                     F* __restrict__ seg_b,
                                     F* __restrict__ seg_a, int K, int S,
                                     int E) {
  const int seg = blockIdx.x;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int k0 = seg * kSegTiles;
  const int k1 = min(K, k0 + kSegTiles);
  bool a = true;
  F b = F(0);
  for (int k = k0; k < k1; ++k) {
    if (cont_out[k]) {
      const int ls = last_slot[k];
      const F pk = out[((size_t)k * S + ls) * E + e];
      const bool ak = cont_in[k] && ls == 0;
      b = ak ? b + pk : pk;
      a = a && ak;
    }
  }
  seg_b[(size_t)seg * E + e] = b;
  if (e == 0) seg_a[seg] = a ? F(1) : F(0);
}

// Pass 2b: the carry entering each segment (one thread per entry).
template <typename F>
__global__ void carry_scan_kernel(const F* __restrict__ seg_b,
                                  const F* __restrict__ seg_a,
                                  const F* __restrict__ carry_in,
                                  F* __restrict__ seg_c, int nseg, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  F c = carry_in[e];
  for (int s = 0; s < nseg; ++s) {
    seg_c[(size_t)s * E + e] = c;
    const F b = seg_b[(size_t)s * E + e];
    c = seg_a[s] != F(0) ? c + b : b;
  }
}

// Pass 2c: apply the carries inside each segment, in tile order.
template <typename F>
__global__ void carry_apply_kernel(F* __restrict__ out,
                                   const int* __restrict__ cont_in,
                                   const int* __restrict__ cont_out,
                                   const int* __restrict__ last_slot,
                                   const F* __restrict__ seg_c,
                                   F* __restrict__ carry_out, int K, int S,
                                   int E, int nseg) {
  const int seg = blockIdx.x;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int k0 = seg * kSegTiles;
  const int k1 = min(K, k0 + kSegTiles);
  F c = seg_c[(size_t)seg * E + e];
  for (int k = k0; k < k1; ++k) {
    const int ls = last_slot[k];
    const F b = out[((size_t)k * S + ls) * E + e];  // before the add below
    if (cont_in[k]) {
      F* o0 = out + (size_t)k * S * E + e;
      *o0 = *o0 + c;
    }
    if (cont_out[k]) c = (cont_in[k] && ls == 0) ? c + b : b;
  }
  if (seg == nseg - 1) carry_out[e] = c;
}

template <typename F>
int carry_pass(F* out, const int* cont_in, const int* cont_out,
               const int* last_slot, const void* carry_in, void* carry_out,
               void* scratch, int K, int S, int E, cudaStream_t st) {
  const int nseg = (K + kSegTiles - 1) / kSegTiles;
  F* seg_b = static_cast<F*>(scratch);
  F* seg_c = seg_b + (size_t)nseg * E;
  F* seg_a = seg_c + (size_t)nseg * E;
  const dim3 grid2(nseg, (E + kThreads - 1) / kThreads);
  carry_segment_kernel<F><<<grid2, kThreads, 0, st>>>(
      out, cont_in, cont_out, last_slot, seg_b, seg_a, K, S, E);
  carry_scan_kernel<F><<<(E + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      seg_b, seg_a, static_cast<const F*>(carry_in), seg_c, nseg, E);
  carry_apply_kernel<F><<<grid2, kThreads, 0, st>>>(
      out, cont_in, cont_out, last_slot, seg_c, static_cast<F*>(carry_out),
      K, S, E, nseg);
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

// Kernel 1's Gram pass alone (no carry): validates, sizes and opts in to
// the shared-memory stage, launches gram_tile_kernel in ``mode``.  The
// per-section timing (gram_sections.cu, level 2) launches exactly this.
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
  const size_t smem = ((size_t)T * W + (size_t)S * (R + 2)) * sizeof(F) +
                      (size_t)T * sizeof(int);
  const auto kernel = out_rows < D ? cross_kernel<F, true>(mode)
                                    : cross_kernel<F, false>(mode);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  CrossPtrs<F> cp;
  for (int c = 0; c < kMaxCross; ++c) {
    cp.p[c] = c < n_cross ? static_cast<const F*>(gths[c]) : nullptr;
  }
  kernel<<<K, kThreads, smem, st>>>(
      static_cast<const F*>(aux2), cp, n_cross, static_cast<const F*>(wvsl),
      static_cast<F*>(out), T, S, R, q_lo, n_extra, out_rows);
  return (int)cudaGetLastError();
}

template <typename F>
int launch_cross(const void* aux2, const void* const* gths, int n_cross,
                 const void* wvsl, const int* cont_in, const int* cont_out,
                 const int* last_slot, const void* carry_in, void* out,
                 void* carry_out, void* scratch, int K, int T, int S, int R,
                 int q_lo, int n_extra, int out_rows, int mode,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_cross_grams<F>(aux2, gths, n_cross, wvsl, out, K, T,
                                        S, R, q_lo, n_extra, out_rows, mode,
                                        st);
  if (err != 0) return err;
  return carry_pass<F>(static_cast<F*>(out), cont_in, cont_out, last_slot,
                       carry_in, carry_out, scratch, K, S,
                       out_rows * (R + n_extra + 2), st);
}

template <typename F>
int launch_meta(const void* meta, const void* q_other, const int* slot,
                const void* wvsl, const int* cont_in, const int* cont_out,
                const int* last_slot, const void* carry_in, void* out,
                void* carry_out, void* scratch, int K, int T, int S, int R,
                int Rq, int out_rows, int mode, void* stream) {
  const int D = Rq + 2;
  if (S < 1 || S > kMaxSlots || K < 1 || T < 1 || R < 0 || Rq < R ||
      out_rows < 1 || out_rows > D || !mode_ok<F>(mode)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = ((size_t)T * D + (size_t)S * (R + 1)) * sizeof(F) +
                      (size_t)T * sizeof(int);
  const auto kernel = out_rows < D ? meta_kernel<F, true>(mode)
                                    : meta_kernel<F, false>(mode);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  F* o = static_cast<F*>(out);
  kernel<<<K, kThreads, smem, st>>>(
      static_cast<const F*>(meta), static_cast<const F*>(q_other), slot,
      static_cast<const F*>(wvsl), o, T, S, R, Rq, out_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return carry_pass<F>(o, cont_in, cont_out, last_slot, carry_in, carry_out,
                       scratch, K, S, out_rows * D, st);
}

template <typename F>
int launch_rows(const void* rows, const int* slot, const int* cont_in,
                const int* cont_out, const int* last_slot,
                const void* carry_in, void* out, void* carry_out,
                void* scratch, int K, int T, int S, int D, void* stream) {
  if (S < 1 || S > kMaxSlots || K < 1 || T < 1 || D < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)T * D * sizeof(F) + (size_t)T * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      gram_rows_tile_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  F* o = static_cast<F*>(out);
  gram_rows_tile_kernel<F><<<K, kThreads, smem, st>>>(
      static_cast<const F*>(rows), slot, o, T, S, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return carry_pass<F>(o, cont_in, cont_out, last_slot, carry_in, carry_out,
                       scratch, K, S, D * D, st);
}

}  // namespace
