// Per-entity Gram statistics of one categorical table, for Hopper (sm_90a).
//
// Three entry points share the Gram passes and one carry walk (their device
// code is in gram_tile.cuh, which gram_sections.cu includes too):
//
//   myfm_fused_gram_cross  replaces the Pallas TPU kernel
//     myfm_tpu/ops/pallas_gram.py fused_tile_gram_cross
//     (_fused_gram_cross_kernel + _emit_gram_tail) in both of its layouts:
//     the Gibbs layout (q_lo = 1, n_extra = 0, the full square Gram) and the
//     VI layout (q_lo = 2, n_extra = 2R, the [2 + R, D] rectangle);
//   myfm_fused_gram        replaces fused_tile_gram (_fused_gram_kernel +
//     _emit_gram_tail), the separate-meta variant that the VI
//     entity+attribute table pass feeds;
//   myfm_tile_gram         replaces tile_gram (_gram_kernel), the Grams of
//     rows the caller has already built: [K, T, D] rows with their slots
//     (ops/gram.entity_grams).
//
// Python side: myfm_tpu_torch/ops/gram.py, whose plain PyTorch versions
// fused_tile_gram_cross_reference, fused_tile_gram_reference and
// tile_gram_reference state the same arithmetic.
//
// What they compute.  Rows are packed into K tiles of T rows; a tile holds
// at most S entities ("slots"), its rows in slot order with pad rows last.
// For every row t of tile k a row z = [1 | e | zcols] of D columns is built
// and, for every slot s, the partial Gram  G[k, s] = sum_{rows of s} z z^T
// is emitted over its first out_rows rows (all D columns).
//   cross:  g = sum over the n_cross other tables of their gathered rows
//           [lin | .. | zcols (R own-factor columns, then n_extra more) | qs]
//           (W = q_lo + R + n_extra + 1 columns, zcols from column q_lo);
//           own = wvsl[k, slot] = [w | V | qs] (2 + R columns);
//           e = g.lin - tau + own.w + 0.5 (|g.z[:R] + own.V|^2 - g.qs - own.qs)
//           (w0 is NOT included; the consumers correct for it);
//           z = [1 | e | g.zcols], D = R + n_extra + 2; pad rows: slot == S.
//   meta:   meta = [ones | lin - tau (+ w0) | qs_other], q = q_other
//           (Rq = D - 2 columns), own = wvsl[k, slot] = [w | V] (1 + R);
//           e = ones (meta1 + own.w + 0.5 (|q[:R] + own.V|^2 - meta2 - |own.V|^2));
//           z = [ones | e | q]; a row counts where ones != 0 (ones is 0 or
//           1: the row-validity column).
//   rows:   z = rows[k, t] as given (D columns; pad rows are zero rows),
//           slot[k, t] its slot; the full D x D square.
// An entity that spans tiles continues at slot 0 of the next tile
// (cont_in / cont_out / last_slot); its running Gram is carried along the
// chain exactly as the TPU kernel's in-order grid carries it, so the
// complete Gram lands at the entity's last (tile, slot), and carry_out is
// the carry leaving the last tile.  Output: [K*S, out_rows, D] (the TPU
// kernel's 8-row padding of each slot is dropped) and carry_out
// [out_rows, D].
//
// What bounds them.  Per row they read the gathered rows ((n_cross) x W
// values, or 3 + Rq) once and write S x out_rows x D values per tile.  The
// Gram is ~out_rows (D - out_rows/2) FMAs per row: at the VI shapes (D = 32
// with 12 rows on ML-100k, D = 98 with 34 rows at rank 32) ~320-2,800 FMAs
// per ~140-800 B read in fp32, 0.6-3.5 FMA per byte, below the card's
// ~10 FMA/B balance point (67 TFLOP/s over 3.35 TB/s): by arithmetic
// intensity they are bound by memory bandwidth.  The Gram pass below does
// not reach that bound (PERF.md): it reads (TM + TN) / (TM TN) shared
// values per FMA, and at the ML-10M VI shape its pass 1 alone takes
// 2.6-2.8x the bound of the whole call (the carry adds a third to a half
// to it); the Gibbs square's pass 1 takes ~2.5x.
//
// Kernel 3 reads D values per row and does D (D + 1) / 2 FMAs: at D = 34 in
// fp32 ~595 FMAs per 136 B, 4.4 FMA per byte, under the balance point as
// well; its block only copies the tile's rows into shared memory (T * D
// values: 35 KB at T = 256, D = 34 in fp32, opted in up to 227 KB) before
// the shared Gram pass.
//
// What the design does about it.  One block per tile streams the tile's
// rows with coalesced loads (summing the n_cross tables as they arrive), so
// each input byte is read once and the [T, D] z block lives in shared
// memory, never in device memory.  Then one Gram pass (gram_pass): the
// block first lists the tile's maximal runs of equal valid slot in shared
// memory (a ballot per warp, 256 rows at a time), the same for every
// thread, so walking them does not diverge and the row loop carries no
// slot test.  Each thread owns a register block of the output and per row
// does TM + TN shared loads and TM TN FMAs; the block's rows and columns
// are strided (bi + m NI, bj + n NJ), so the threads of a warp load
// consecutive words (no bank conflicts) and store consecutive output
// columns.  Two block maps:
//   the square (out_rows == D: the Gibbs layout, kernel 3, kernel 2's
//     full square): a triangle of 2 x 2 blocks.  The transpose of block
//     (bi, bj) is block (bj, bi), so only bi >= bj is computed and each
//     value is written at (i, j) and (j, i): 153 blocks at D = 34 (595
//     entries in the triangle, 612 computed), one round of the 256
//     threads up to D = 44, and 1 shared load per FMA where the pass it
//     replaced, one entry per thread, read 2 plus the row's slot;
//   the rectangle (out_rows < D: every VI launch of kernels 1 and 2): the
//     whole [out_rows, D] (its lower-left part computed directly, not
//     mirrored: ~20% more FMAs at D = 98, no mirror writes) in 4 x 4
//     blocks at the ML-10M VI shape ([34, 98], 225 blocks), 2 x 2 where
//     4 x 4 would leave most threads idle (ML-100k, [12, 32]: 96 blocks).
// Each entry sums its rows in tile order with fma from 0 at each run, and
// fma(a, b, c) == fma(b, a, c): an entry and its mirror have the same bits
// whichever a block computes, and every block map gives the same bits (the
// square's equal the one-entry-per-thread pass's, PERF.md).  A kernel
// compiles one of the two maps (the rectangle's registers would bound the
// square's occupancy).  Kernel 1's rectangle kernel also stages the tile
// with 4 loads in flight per thread, and its fp32 code is held to 80
// registers (3 blocks per SM; its 4 x 4 loop left alone takes more and
// runs 2); kernel 2's stage and registers lost to both, and so did the
// square's stage in fp32, so they have neither (PERF.md).
// Every slot's output is written once (zeros included), or added to where
// a slot recurs later in the tile.  This is mode 0, IEEE fp32 (or fp64)
// FMA.
//
// The reduced-precision modes (kernels 1 and 2; the TPU kernel's
// fast_matmul "split" and "bf16", _emit_gram_tail).  Each z value splits
// into hi = bf16(x) (round to nearest even) and lo = bf16(x - hi); mode 1
// ("split") forms hi^T hi + hi^T lo + lo^T hi, mode 2 ("bf16") hi^T hi,
// both with f32 accumulation.  Every bf16 x bf16 product is exact in f32,
// and the kernel and its plain version (ops/gram.py, the same split in
// PyTorch) build the same z bit for bit: e's sums of squares are taken in
// one order with every product and sum rounded (add_sq; an fma in one and
// not the other would move e by a last bit, which bf16 rounding can turn
// into the mode's whole error for that row).  So a mode's result differs
// from its plain version only in the order of the f32 sums.  Against
// IEEE, split is off by ~1.5e-5 and bf16 by ~4e-3 of the Gram's scale
// (the self-check, gram_fast_selfcheck, gates them at 2e-4 and 2e-2).
// fp32 only: there is no fp64 tensor-core path, and an fp64 call with
// mode != 0 returns cudaErrorInvalidValue.  What bounds them: the same
// bytes as mode 0, and 2 (bf16) or 6 (split) flops per entry and row on
// the tensor cores (989 dense bf16 TFLOP/s), so bytes bound them at every
// shape here.  How they reach the tensor cores (grams_mma in
// gram_tile.cuh): warp-level mma.sync.m16n8k16 bf16 products on the fp32
// stage in shared memory, the fragments built in registers as they are
// loaded (no bf16 copy of the stage, so the rank-128 tile's ~67 KB stage
// is all the shared memory a block needs; splitting the stage once in
// place measured slower).  A = z^T and B = z read the same rows, so one
// 16-row k-chunk's fragment of an 8-column block is both a B operand and
// half an A operand.  Each warp keeps 2 16 x 8 output fragments in
// registers across a slot's runs (16 per round of the block: rank 32's
// square takes one round, the rank-128 square six) and walks each run in
// 16-row k-chunks of its own rows (the rows past the run's end read as
// zero), so the work is the rows', not the TPU kernel's masked product
// over all S slots at once; the square computes only the fragments that
// hold an entry i >= j and writes each such entry with its mirror.  The
// kernels are held to 4 blocks per SM (<= 64 registers), and the cross
// kernels' stage batches its loads: at 8 fragments and 2 blocks per SM
// the pass took 2x IEEE at rank 32 (PERF.md).
//
// The wgmma pass (wgmma_chunk in gram_tile.cuh) takes the fp32 square at
// D >= 64 in both reduced modes: the Gibbs layout at rank >= 62, where
// "auto" runs "bf16", and kernel 2's square.  The mma.sync pass rebuilt
// each operand fragment from the fp32 stage for every 16-row k-chunk and
// held 2 fragments per warp, so the rank-128 square's 89 fragments took 6
// walks of the tile.  Here each run of a slot is written once as bf16 (hi,
// and lo for split) into a ring in wgmma's K-major core-matrix layout, and
// each warpgroup runs m64n64k16 wgmma over its 64 x 64 blocks of the
// lower triangle from shared-memory descriptors, 32 fp32 accumulators per
// thread per block.  The fp32 stage stays, cut into 128-row chunks (64 in
// "split", whose two rings would otherwise leave one block per SM), so the
// z rows are built by the same code as every other pass (the kernel and
// plain version build the same z bit for bit; the zcols are read where
// they were loaded, the [valid, e] pair kept apart).  At rank 128, T = 128
// the chunk (66.5 KB) and the bf16 ring (34 KB) hold 2 blocks per SM.
// The gathered rows of a tile are one contiguous block per table, summed
// over the tables as they arrive (stage_cross, shared with the other
// cross kernels): 16-byte streaming loads (evict first, so the L2 keeps
// the Grams being written), 4 per table in flight per thread.  They are
// a gather of whole rows, so TMA's tiled mode does not fit them, and a
// 1-D bulk or cp.async copy saves no bytes.  What bounds the pass is
// bytes: the gathered rows in and the S x D x D fp32 Grams out per tile;
// with its products, the ring and the z build taken out, the pass ran
// within 10% of its time (PERF.md), so the tensor-core work is no longer
// what holds it, the memory pipeline is.  A chunk's loads finish before
// its z build: copying the next chunk's first table ahead with cp.async
// while this chunk's products and stores ran (blocks persistent over
// their tiles, 2 per SM) took 5-8% longer, and two tables ahead at 1
// block per SM no less; the other resident block's loads already overlap
// a block's products and stores (PERF.md).
// The launcher chooses the pass by D (gram_pass_id, myfm_gram_pass); a
// launch failure raises, there is no fallback to another pass.
//
// The carry.  A TPU grid runs in order, so the Pallas kernel threads the
// running Gram through a scratch buffer; a CUDA grid has no order.  One
// launch after pass 1 (carry_walk in gram_tile.cuh) walks the tiles in
// order, entry by entry, exactly as the plain version:
//   if cont_in[k]:  out[k, 0] = out[k, 0] + c
//   if cont_out[k]: c = out[k, last_slot[k]]
// so the carried Grams are bit-equal to the plain version's wherever pass
// 1's partials are.  Blocks of 64 entries x 16-128 tiles (carry_seg:
// short segments where a call has few tiles, so they fill the SMs) take
// tickets in order; a block walks from its first tile that resets the
// carry (whose outgoing carry does not depend on the incoming one) without
// waiting and publishes the carry leaving its segment; only tiles before
// that reset wait for the previous segment's.  A popular entity's chain (7,910 tiles
// of one 8,192-tile call for the ML-10M item table at rank 128; PERF.md)
// waits once per segment, not once per tile: folding the carry into
// pass 1's epilogue would have serialised that chain tile by tile.  Per
// continuing tile the walk reads the partial once and writes it once (the
// three-launch carry it replaced read it three times and wrote it once).
// No atomics on values, so every run gives the same bits.

#include "gram_tile.cuh"

extern "C" {

// Workspace of the carry walk over K tiles of E = out_rows * D entries per
// slot, which the wrappers allocate: the carries leaving each segment
// (elements of the output's dtype), and the ticket and flags (ints, zeroed
// before every launch).
int myfm_gram_carry_scratch(int K, int E) {
  const int G = carry_seg(K, E);
  return ((K + G - 1) / G) * E;
}
int myfm_gram_carry_sync(int K, int E) {
  const int G = carry_seg(K, E);
  return 1 + ((K + G - 1) / G) * ((E + kCarryThreads - 1) / kCarryThreads);
}

// Static shared memory of the Gram pass (its run list), which every
// pass-1 kernel uses on top of its dynamic stage.
int myfm_gram_static_smem() { return (int)sizeof(RunList); }

// The Gram pass a pass-1 launch takes in Gram mode ``mode`` (0 IEEE, 1
// split, 2 bf16) for a [out_rows, D] Gram: 0 FMA, 1 mma.sync, 2 wgmma.
int myfm_gram_pass(int mode, int D, int out_rows) {
  return gram_pass_id(mode, D, out_rows);
}

// Dynamic shared memory of the wgmma pass's ring(s) at width D in mode.
int myfm_gram_ring_bytes(int D, int mode) { return (int)ring_bytes(D, mode); }

// Returns 0 or the cudaError_t of the first failed launch.
// mode: 0 IEEE, 1 split, 2 bf16 (fp32 only).
int myfm_fused_gram_cross(int is_double, int mode, const void* aux2,
                          const void* const* gths, int n_cross,
                          const void* wvsl, const int* cont_in,
                          const int* cont_out, const int* last_slot,
                          const void* carry_in, void* out, void* carry_out,
                          void* scratch, int* sync, int K, int T, int S,
                          int R, int q_lo, int n_extra, int out_rows,
                          void* stream) {
  if (is_double) {
    return launch_cross<double>(aux2, gths, n_cross, wvsl, cont_in, cont_out,
                                last_slot, carry_in, out, carry_out, scratch,
                                sync, K, T, S, R, q_lo, n_extra, out_rows,
                                mode, stream);
  }
  return launch_cross<float>(aux2, gths, n_cross, wvsl, cont_in, cont_out,
                             last_slot, carry_in, out, carry_out, scratch,
                             sync, K, T, S, R, q_lo, n_extra, out_rows, mode,
                             stream);
}

// Returns 0 or the cudaError_t of the first failed launch.
int myfm_tile_gram(int is_double, const void* rows, const int* slot,
                   const int* cont_in, const int* cont_out,
                   const int* last_slot, const void* carry_in, void* out,
                   void* carry_out, void* scratch, int* sync, int K, int T,
                   int S, int D, void* stream) {
  if (is_double) {
    return launch_rows<double>(rows, slot, cont_in, cont_out, last_slot,
                               carry_in, out, carry_out, scratch, sync, K, T,
                               S, D, stream);
  }
  return launch_rows<float>(rows, slot, cont_in, cont_out, last_slot,
                            carry_in, out, carry_out, scratch, sync, K, T, S,
                            D, stream);
}

// Returns 0 or the cudaError_t of the first failed launch; mode as in
// myfm_fused_gram_cross.
int myfm_fused_gram(int is_double, int mode, const void* meta,
                    const void* q_other, const int* slot, const void* wvsl,
                    const int* cont_in, const int* cont_out,
                    const int* last_slot, const void* carry_in, void* out,
                    void* carry_out, void* scratch, int* sync, int K, int T,
                    int S, int R, int Rq, int out_rows, void* stream) {
  if (is_double) {
    return launch_meta<double>(meta, q_other, slot, wvsl, cont_in, cont_out,
                               last_slot, carry_in, out, carry_out, scratch,
                               sync, K, T, S, R, Rq, out_rows, mode, stream);
  }
  return launch_meta<float>(meta, q_other, slot, wvsl, cont_in, cont_out,
                            last_slot, carry_in, out, carry_out, scratch,
                            sync, K, T, S, R, Rq, out_rows, mode, stream);
}

}  // extern "C"
