// Per-section timing variants of kernel 1, and the (slot, tau) load probe,
// for Hopper (sm_90a).
//
//   myfm_gram_section     replaces the Pallas TPU microbench
//     scripts/microbench_kernel_sections.py run_variant (variant_kernel):
//     stripped variants of the fused cross Gram (kernel 1, Gibbs layout:
//     q_lo = 1, n_extra = 0, the D x D square), to bisect its cost per row.
//     The levels, each the one before it plus one section:
//       0  loads every operand into shared memory -- the first gathered
//          table's rows as they are, the other tables' rows into a running
//          checksum, the own rows, slot and tau -- reads every staged value
//          back into the checksum and writes the output tile with it (so
//          the compiler can elide no load);
//       1  + the Gram loop (gram_pass, the production pass: the run list
//          and the triangle of register blocks, or the tensor-core
//          fragments) over the loaded rows taken as z; the checksum is
//          added to entry [slot 0, 0, 0] of each tile;
//       2  the production Gram pass (launch_cross_grams: cross sums, score
//          and z build, Gram loop; the wgmma pass where production takes
//          it), no carry;
//       3  the whole production kernel (launch_cross: level 2 + the carry
//          walk), bit-equal to myfm_fused_gram_cross on the same operands
//          in the same mode.
//     Level 1 runs gram_pass (FMA or mma.sync) at every width: at D >= 64
//     in split and bf16 it times the mma.sync pass, not production's.
//     Levels 1-3 take kernel 1's Gram mode (0 IEEE, 1 split, 2 bf16; see
//     fused_gram_cross.cu); level 0, the checksum, has none.  Levels 2
//     and 3 run the production launchers of gram_tile.cuh, not a copy.
//     fp32 only, as the TPU microbench, which runs every level in split
//     and level 1 in bf16 too (it has no IEEE mode; IEEE is the port's
//     own addition).
//   myfm_interleave_probe replaces the Pallas TPU probe
//     scripts/probe_transpose.py run (k_transpose): there a [2, T] -> [T, 2]
//     transpose in a kernel; here the load kernel 1 makes of its aux2
//     operand ([K, 2, T]: slot row, tau row) into per-row (slot, tau)
//     pairs, written out as [K, T, 2]:
//       variant 0  each thread reads x[k, 0, t] and x[k, 1, t] (coalesced
//                  across the warp) and stores one 8-byte float2;
//       variant 1  a block stages its [2, n] slice in shared memory with
//                  coalesced reads, then writes the [n, 2] pairs with
//                  coalesced 4-byte stores.
//     Both are bit-equal to x.transpose(1, 2).contiguous().
//
// Python side: myfm_tpu_torch/ops/gram.py (gram_section, interleave_probe,
// and their plain versions gram_section_reference and
// interleave_probe_reference); time them with
// python -m myfm_tpu_torch.tools.kernel_sections.
//
// What bounds them.  Every level reads the same bytes (n_cross gathered
// rows of W = D values per row, the own rows, aux2) and writes the
// same S x D x D values per tile; levels 1-3 add the Gram loop's
// D (D + 1) / 2 FMAs per row (on the tensor cores in split and bf16) and
// level 2 the ~4 D operations of the score and z build.  By bytes alone
// each level's bound is the same; the gaps between levels are what the
// sections cost beyond moving their bytes.
// The probe moves 2 x 4 B in and 2 x 4 B out per row and is bound by bytes.
//
// What the design does about it.  Levels 0 and 1 keep the production
// block shape (one 256-thread block per tile, the same shared-memory
// stage, the same coalesced load loop), so the differences between levels
// are the sections' own.

#include "gram_tile.cuh"

namespace {

constexpr int kProbeRows = 1024;  // rows per block of the staged probe

template <int kLevel, int kMode>
__global__ void __launch_bounds__(kThreads,
                                  kMode != kModeIEEE ? kMmaBlocks : 0)
gram_section_kernel(const float* __restrict__ aux2, CrossPtrs<float> gths,
                    int n_cross, const float* __restrict__ wvsl,
                    float* __restrict__ out, int T, int S, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float part[kThreads / 32];
  const int D = R + 2;
  const int W = D;       // gathered [lin | V | qs] row width (q_lo = 1)
  const int Wo = R + 2;  // own [w | V | qs] row width
  float* z = reinterpret_cast<float*>(smem_raw);           // [T][W]
  float* own = z + (size_t)T * W;                          // [S][Wo]
  float* tau = own + (size_t)S * Wo;                       // [T]
  int* slot = reinterpret_cast<int*>(tau + T);             // [T]

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t tile_off = (size_t)k * T * W;
  float chk = 0.f;
  for (int i = tid; i < T * W; i += blockDim.x) {
    z[i] = gths.p[0][tile_off + i];
#pragma unroll
    for (int c = 1; c < kMaxCross; ++c) {
      if (c < n_cross) chk += gths.p[c][tile_off + i];
    }
  }
  for (int i = tid; i < S * Wo; i += blockDim.x) {
    own[i] = wvsl[(size_t)k * S * Wo + i];
  }
  const float* slot_row = aux2 + (size_t)k * 2 * T;
  for (int t = tid; t < T; t += blockDim.x) {
    slot[t] = (int)slot_row[t];
    tau[t] = slot_row[T + t];
  }
  __syncthreads();

  // every staged value back into the checksum, by rows (values other
  // threads wrote)
  for (int t = tid; t < T; t += blockDim.x) {
    const float* row = z + (size_t)t * W;
    for (int c = 0; c < W; ++c) chk += row[c];
    chk += tau[t] + (float)slot[t];
  }
  for (int i = tid; i < S * Wo; i += blockDim.x) chk += own[i];
  for (int o = 16; o > 0; o >>= 1) chk += __shfl_xor_sync(0xffffffffu, chk, o);
  if ((tid & 31) == 0) part[tid >> 5] = chk;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += part[w];

  float* out_tile = out + (size_t)k * S * D * D;
  if (kLevel == 0) {
    for (int p = tid; p < S * D * D; p += blockDim.x) out_tile[p] = total;
  } else {
    gram_pass<float, false, kMode>(z, W, slot, T, S, D, D, out_tile);
    __syncthreads();
    if (tid == 0) out_tile[0] += total;
  }
}

template <int kLevel, int kMode>
int launch_section(const void* aux2, const void* const* gths, int n_cross,
                   const void* wvsl, void* out, int K, int T, int S, int R,
                   cudaStream_t st) {
  const int W = R + 2;
  const size_t smem = ((size_t)T * W + (size_t)S * (R + 2) + T) *
                          sizeof(float) + (size_t)T * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      gram_section_kernel<kLevel, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  CrossPtrs<float> cp;
  for (int c = 0; c < kMaxCross; ++c) {
    cp.p[c] = c < n_cross ? static_cast<const float*>(gths[c]) : nullptr;
  }
  gram_section_kernel<kLevel, kMode><<<K, kThreads, smem, st>>>(
      static_cast<const float*>(aux2), cp, n_cross,
      static_cast<const float*>(wvsl), static_cast<float*>(out), T, S, R);
  return (int)cudaGetLastError();
}

__global__ void interleave_direct_kernel(const float* __restrict__ x,
                                         float2* __restrict__ out, int T) {
  const int k = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const float* xk = x + (size_t)k * 2 * T;
  out[(size_t)k * T + t] = make_float2(xk[t], xk[T + t]);
}

__global__ void interleave_staged_kernel(const float* __restrict__ x,
                                         float* __restrict__ out, int T) {
  __shared__ float s[2 * kProbeRows];
  const int k = blockIdx.y;
  const int t0 = blockIdx.x * kProbeRows;
  const int n = min(kProbeRows, T - t0);
  const float* xk = x + (size_t)k * 2 * T;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const int c = i / n;
    s[i] = xk[(size_t)c * T + t0 + (i - c * n)];
  }
  __syncthreads();
  float* ok = out + ((size_t)k * T + t0) * 2;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    ok[i] = s[(i & 1) * n + (i >> 1)];
  }
}

}  // namespace

extern "C" {

// Level 0-3 variant of kernel 1 (Gibbs layout, fp32) in Gram mode
// ``mode`` (0 IEEE, 1 split, 2 bf16; level 0 takes 0 only).  Levels 0-2
// write out only; level 3 also runs the carry walk (carry_in, carry_out,
// scratch and sync as myfm_fused_gram_cross takes them).  Returns 0 or the
// cudaError_t of the first failed launch.
int myfm_gram_section(int level, int mode, const void* aux2,
                      const void* const* gths, int n_cross, const void* wvsl,
                      const int* cont_in, const int* cont_out,
                      const int* last_slot, const void* carry_in, void* out,
                      void* carry_out, void* scratch, int* sync, int K,
                      int T, int S, int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_cross < 1 || n_cross > kMaxCross || S < 1 || S > kMaxSlots ||
      K < 1 || T < 1 || R < 0 || !mode_ok<float>(mode) ||
      (level == 0 && mode != kModeIEEE)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (level) {
    case 0:
      return launch_section<0, kModeIEEE>(aux2, gths, n_cross, wvsl, out, K,
                                          T, S, R, st);
    case 1:
      if (mode == kModeSplit) {
        return launch_section<1, kModeSplit>(aux2, gths, n_cross, wvsl, out,
                                             K, T, S, R, st);
      }
      if (mode == kModeBf16) {
        return launch_section<1, kModeBf16>(aux2, gths, n_cross, wvsl, out,
                                            K, T, S, R, st);
      }
      return launch_section<1, kModeIEEE>(aux2, gths, n_cross, wvsl, out, K,
                                          T, S, R, st);
    case 2:
      return launch_cross_grams<float>(aux2, gths, n_cross, wvsl, out, K, T,
                                       S, R, 1, 0, R + 2, mode, st);
    case 3:
      return launch_cross<float>(aux2, gths, n_cross, wvsl, cont_in,
                                 cont_out, last_slot, carry_in, out,
                                 carry_out, scratch, sync, K, T, S, R, 1, 0,
                                 R + 2, mode, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x [K, 2, T] -> out [K, T, 2], fp32; variant 0 direct, 1 staged.
// Returns 0 or the cudaError_t of the launch.
int myfm_interleave_probe(int variant, const void* x, void* out, int K,
                          int T, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || T < 1 || K > 65535) return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    const dim3 grid((T + kThreads - 1) / kThreads, K);
    interleave_direct_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float2*>(out), T);
  } else if (variant == 1) {
    const dim3 grid((T + kProbeRows - 1) / kProbeRows, K);
    interleave_staged_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), T);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
