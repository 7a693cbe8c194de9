// The joint Gibbs sweep's sequential color tail, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel myfm_tpu/ops/pallas_joint_tail.py
// joint_tail_pass (_tail_kernel).  Python side:
// myfm_tpu_torch/ops/joint_tail.py, whose plain PyTorch versions
// joint_tail_pass_reference (ops/joint.py _dense_color_apply, color
// after color) and tail_lists_reference state the same arithmetic.
//
// What it computes.  A block of B block rows carries a Gram per row,
// G_b = sum z z^T over the block row's original rows, z = [1, e, q]
// (D = R + 2), plus Atot [B][R] and Ct [B].  For each of C colors, in
// order, with x = xw[c][b] and slot p = segb[c][b] (p == Pf: absent):
//   stats per slot    sum x^2 G, sum x^3 G[0,:], sum x^4 G[0,0], sum x G[1,:]
//   S, t              assembled with the v_old border terms
//   A = alpha S + diag(lam),  rhs = alpha (S u0 - t) + lam mu
//   L L^T = A         Cholesky, pivot j floored at
//                     max(8 eps |A_jj| + tiny, lam_j) in the kernel's own
//                     precision (FLT / DBL eps and min)
//   u_new = L^-T (L^-1 rhs + xi)
// and then, per block row of the color, with s = [a0, 0, A_B],
//   a0 = x dw - x^2 (v_old . dv),  A_B = x dv:
//   Ct += a0 + A_B . Atot;  Atot += A_B;  G <- T G T^T via
//   g = G s, p = g + g_0 s^ + (sgs / 2) e1, r = G[:,0] + (G_00 / 2) s^,
//   G += e1 p^T + p e1^T + s^ r^T + r s^T      (s^ = [0, 0, A_B]).
// Every slot is drawn, pad slots (no rows in the color) included, from
// the same noise as the TPU kernel consumes; their rows are never touched.
//
// What bounds it.  The colors form one chain: each reads the G, Atot and
// Ct the previous one wrote, so the kernel is bound by per-color latency,
// not by bandwidth or FLOPs (the bytes bound of the two ML-100k tails is
// ~0.008 ms).  A color of the real tails touches ~50 block rows (median
// 26-37, up to 933) through 1-1.5 live slots of 8.  What is left per
// color: one dependent L2 round trip for the touched rows' Grams in the
// statistics, Dp dependent pivot steps and Dp back-substitution steps of
// the draw, the update's arithmetic and stores, and six block barriers.
// All of it runs on one SM.
//
// The design.
// * Two kernels per call.  tail_prep_kernel runs one CTA per color, all
//   colors at once, and writes each color's lists into the workspace:
//   the touched rows grouped by slot (in row order inside a slot, placed
//   stably by __match_any_sync), their xw, the live slots (slots that own
//   rows) with their row starts, and the live slots' (u0, lam, mu, xi).
//   It also draws every pad slot: with no rows S = 0 and t = 0, so A =
//   diag(lam) and its draw needs nothing of the chain.  A row whose segb
//   is Pf has xw = 0 on the TPU, so s = 0 and a zero correction: skipping
//   it is exact.
// * joint_tail_kernel runs the chain in one CTA (nothing carried between
//   blocks of a grid), 512 threads (256 where shared memory runs out).
//   While color c runs, cp.async copies color
//   c+1's lists and operands into the other half of a double-buffered
//   shared stage (commit / wait groups); lists longer than the stage
//   (kStageRows rows, 32 live slots) are read from the workspace beyond
//   it.  At the start of color c each row group of the update also
//   copies its first row's Gram, Atot row and Ct by cp.async: the draw
//   does not change them.
// * Statistics: every thread takes one (live slot, upper-triangle entry)
//   item and a fixed row stride (a slot's rows split over threads / items
//   groups), 8 rows' loads in flight at a time; the groups' partials are
//   added in group order.  The triangle holds rows 0 and 1, so n_tri
//   loads per row give all D(D+1)/2 + 2D + 1 statistics.  Then every
//   thread assembles an entry of the live slots' S and t.
// * Draw: one warp per live slot, several slots on different warps.  For
//   Dp <= kRegDp lane i holds row i of A in registers; the right-looking
//   Cholesky passes column j through shared memory (one __syncwarp a
//   step), each entry's updates subtracting in the order k = 0..j-1 as
//   the plain version, the forward solve rides along, and the backward
//   solve takes one __shfl_sync a step.  Wider draws run the same steps on A in a per-warp
//   shared scratch (lane i owns rows i and i + 32, Dp <= 64).
// * Update: one group of 16 lanes (32 where D > 16) per touched row: g =
//   G s, sgs, p and r come from the group's shared slab, and each entry
//   is written back once, a lane per column.
// * Every reduction runs in a fixed order (row strides, group order and
//   __shfl_xor_sync trees that do not depend on timing); integer atomics
//   count rows per slot in the prep kernel.  No float atomics: two runs
//   give the same bits.
// * No tensor cores: the per-color algebra is <= 33-dimensional and the
//   fp64 path keeps its precision.
// * G stays in device memory, resident in L2 (0.5-1 MB per tail, more
//   than one SM's 227 KB); the wrapper hands the kernel a row-major copy
//   [B][D^2], so a touched row is D^2 contiguous values.  Holding it in a
//   cluster's distributed shared memory, and spreading a color's rows over
//   the cluster's SMs, is the next step.
// * The timed instantiation (kTimed) adds clock64() cycles per phase and
//   per step of thread 0's own draw and rows into shared counters, for
//   tools/joint_tail.py.  Only a build with -DMYFM_JOINT_TAIL_TIMED (the
//   library "joint_tail_timed" of ops/_build.py) holds it, and holds only
//   it; the production build has none of it.
// Arithmetic is IEEE fp32 or fp64.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

#ifdef MYFM_JOINT_TAIL_TIMED
constexpr bool kTimedBuild = true;
#else
constexpr bool kTimedBuild = false;
#endif

constexpr int kPrepThreads = 128;
// threads per chain CTA at most: 128 registers each (at 1,024 threads the
// 64-register cap spilled and measured no faster)
constexpr int kMaxThreads = 512;
constexpr int kStageRows = 256;  // rows per color staged (more: from L2)
constexpr int kRegDp = 12;  // the draw keeps A in registers up to this Dp
constexpr int kPhases = 4;  // stage, stats, draw, update
// thread 0's own path inside two phases (timed instantiation): draw
// assemble / factor / solve, update load + G s / reductions + p, r / write
constexpr int kSubPhases = 6;

__device__ __forceinline__ void tick(long long* sub, int k, long long& t) {
  if (sub != nullptr && threadIdx.x == 0) {
    const long long now = clock64();
    sub[k] += now - t;
    t = now;
  }
}

template <typename F>
struct Lim;
template <>
struct Lim<float> {
  __device__ static float eps() { return FLT_EPSILON; }
  __device__ static float tiny() { return FLT_MIN; }
};
template <>
struct Lim<double> {
  __device__ static double eps() { return DBL_EPSILON; }
  __device__ static double tiny() { return DBL_MIN; }
};

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}
template <typename F>
__device__ __forceinline__ void cp_async_one(F* dst, const F* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(F)));
}

// Problem dimensions and the padded strides of the workspace lists.
struct Dims {
  int C, B, Pf, D;
  __host__ __device__ int R() const { return D - 2; }
  __host__ __device__ int Dp() const { return D - 1; }
  __host__ __device__ int n_tri() const { return D * (D + 1) / 2; }
  __host__ __device__ int n_stats() const { return n_tri() + 2 * D + 1; }
  __host__ __device__ int Bp() const { return round4(B); }
  __host__ __device__ int Pfp() const { return round4(Pf + 1); }
  // the live slots' operands of one color: [Pf][4][Dp], padded
  __host__ __device__ int U() const { return round4(Pf * 4 * Dp()); }
};

// The workspace: per color the grouped rows [Bp], the live slots' row
// starts [Pfp] and ids [Pfp] (ints), then their xw [Bp] and operands [U]
// (F), then, when they do not fit in shared memory, the live slots'
// statistics and deltas.
template <typename F>
struct Lists {
  int* rows;    // [C][Bp]: touched rows grouped by slot; -1 past the end
  int* lstart;  // [C][Pfp]: row start of live slot l; [nl..Pf] = n
  int* live;    // [C][Pfp]: live slot ids ascending; -1 past nl; [Pf] = nl
  F* xwg;       // [C][Bp]: xw of each grouped row
  F* uops;      // [C][U]: (u0, lam, mu, xi) of live slot l at [l][4][Dp]
  unsigned char* slot_ws;  // per-slot arrays when not in shared memory

  __host__ __device__ static size_t list_bytes(const Dims& d) {
    return (size_t)d.C * ((size_t)d.Bp() + 2 * (size_t)d.Pfp()) *
               sizeof(int) +
           (size_t)d.C * ((size_t)d.Bp() + (size_t)d.U()) * sizeof(F);
  }
  __host__ __device__ static Lists carve(unsigned char* ws, const Dims& d) {
    Lists l;
    l.rows = reinterpret_cast<int*>(ws);
    l.lstart = l.rows + (size_t)d.C * d.Bp();
    l.live = l.lstart + (size_t)d.C * d.Pfp();
    l.xwg = reinterpret_cast<F*>(l.live + (size_t)d.C * d.Pfp());
    l.uops = l.xwg + (size_t)d.C * d.Bp();
    l.slot_ws = ws + list_bytes(d);
    return l;
  }
};

// Per live slot: statistics [n_stats], deltas dw, dv, c0 [Dp + 1], then
// S [Dp][Dp] and t [Dp] of its draw.
__host__ __device__ __forceinline__ int s_size(const Dims& d) {
  return d.Dp() * d.Dp() + d.Dp();
}
template <typename F>
__host__ __device__ size_t slot_bytes(const Dims& d) {
  return (size_t)d.Pf * (d.n_stats() + d.Dp() + 1 + s_size(d)) * sizeof(F);
}

// Lanes per touched row in the update: half a warp while D <= 16.
__host__ __device__ __forceinline__ int row_lanes(int D) {
  return D <= 16 ? 16 : 32;
}
// Per warp: the draw's scratch (L of the registers path, A of the shared
// path), then one slab per row group of the update: the row's Gram
// [D*D], s, G s, p, r [D] each, its Atot row [R] and Ct.
__host__ __device__ __forceinline__ int a_ld(int Dp) { return Dp | 1; }
__host__ __device__ __forceinline__ int slab_size(int D) {
  return D * D + 4 * D + (D - 2) + 1;
}
template <typename F>
__host__ __device__ size_t draw_bytes(const Dims& d) {
  const size_t drw = d.Dp() <= kRegDp ? (size_t)kRegDp * (kRegDp + 4) + 2
                                      : (size_t)d.Dp() * a_ld(d.Dp());
  return align16(drw * sizeof(F));
}
template <typename F>
__host__ __device__ size_t warp_bytes(const Dims& d) {
  return draw_bytes<F>(d) +
         align16((size_t)(32 / row_lanes(d.D)) * slab_size(d.D) * sizeof(F));
}

// One half of the double-buffered stage.
template <typename F>
__host__ __device__ size_t stage_bytes(const Dims& d, int capR, int capL) {
  return (size_t)capR * (sizeof(int) + sizeof(F)) +
         2 * (size_t)d.Pfp() * sizeof(int) +
         align16((size_t)capL * 4 * d.Dp() * sizeof(F));
}

// The chain kernel's shared-memory plan for `threads` threads.
struct Plan {
  int threads, capR, capL;
  bool slots_in_smem;
  size_t smem;
};

template <typename F>
size_t fixed_bytes(const Dims& d, int threads) {
  return align16((size_t)threads * 4 * sizeof(F)) +        // partials
         (size_t)(threads / 32) * warp_bytes<F>(d) +       // warp scratch
         align16(2 * (size_t)d.n_tri() * sizeof(int));     // triangle maps
}

template <typename F>
bool make_plan(const Dims& d, int threads, size_t limit, Plan* p) {
  p->threads = threads;
  p->capL = d.Pf < 32 ? d.Pf : 32;
  p->capR = d.Bp() < kStageRows ? d.Bp() : kStageRows;
  limit -= 256;  // the kernel's static shared memory (phase clocks)
  const size_t fixed = fixed_bytes<F>(d, threads);
  const size_t slots = align16(slot_bytes<F>(d));
  auto total = [&](int capR, int capL, bool in_smem) {
    return fixed + 2 * stage_bytes<F>(d, capR, capL) + (in_smem ? slots : 0);
  };
  if (total(p->capR, p->capL, true) <= limit) {
    p->slots_in_smem = true;
  } else {
    p->slots_in_smem = false;
    while (p->capR > 64 && total(p->capR, p->capL, false) > limit) {
      p->capR = round4(p->capR / 2);
    }
    while (p->capL > 1 && total(p->capR, p->capL, false) > limit) {
      p->capL /= 2;
    }
    if (total(p->capR, p->capL, false) > limit) return false;
  }
  p->smem = total(p->capR, p->capL, p->slots_in_smem);
  return true;
}

cudaError_t smem_limit(size_t* limit) {
  int dev = 0, v = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  }
  *limit = (size_t)v;
  return err;
}

// The plan at the first of kMaxThreads, kMaxThreads / 2, ... (at least
// 256) whose shared memory fits.
template <typename F>
cudaError_t choose_plan(const Dims& d, Plan* p) {
  size_t limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  for (int t = kMaxThreads; t >= 256; t /= 2) {
    if (make_plan<F>(d, t, limit, p)) return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The prep kernel: one CTA per color.
// ---------------------------------------------------------------------------

template <typename F>
__global__ void __launch_bounds__(kPrepThreads)
tail_prep_kernel(const int* __restrict__ segb,  // [C][B]
                 const F* __restrict__ xw,      // [C][B]
                 const F* __restrict__ u0,      // [C][Pf][Dp]
                 const F* __restrict__ lam,
                 const F* __restrict__ mu,
                 const F* __restrict__ xi,
                 const F* __restrict__ alpha_p,
                 F* __restrict__ u_out,         // [C][Pf][Dp]: pad slots
                 Lists<F> L, Dims d) {
  extern __shared__ int psm[];
  int* cnt = psm;              // [Pf]: rows per slot
  int* cur = cnt + d.Pf;       // [Pf]: next free place of each slot
  int* lord = cur + d.Pf;      // [Pf]: live ordinal of each slot, or -1
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int B = d.B, Pf = d.Pf, Dp = d.Dp();
  const int* sg = segb + (size_t)c * B;
  int* rows = L.rows + (size_t)c * d.Bp();
  int* lstart = L.lstart + (size_t)c * d.Pfp();
  int* live = L.live + (size_t)c * d.Pfp();
  F* xwg = L.xwg + (size_t)c * d.Bp();

  for (int p = tid; p < Pf; p += kPrepThreads) cnt[p] = 0;
  __syncthreads();
  for (int b = tid; b < B; b += kPrepThreads) {
    const int s = sg[b];
    if (s >= 0 && s < Pf) atomicAdd(&cnt[s], 1);  // integers: exact
  }
  __syncthreads();
  if (tid < 32) {
    // slot starts (exclusive scan), live ids and ordinals, 32 at a time
    int carry = 0, nl = 0;
    for (int base = 0; base < Pf; base += 32) {
      const int p = base + lane;
      const int k = p < Pf ? cnt[p] : 0;
      int incl = k;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const unsigned m = __ballot_sync(0xffffffffu, k > 0);
      const int ord = nl + __popc(m & ((1u << lane) - 1u));
      if (p < Pf) {
        cur[p] = carry + incl - k;
        lord[p] = k > 0 ? ord : -1;
        if (k > 0) {
          live[ord] = p;
          lstart[ord] = carry + incl - k;
        }
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
      nl += __popc(m);
    }
    for (int l = nl + lane; l < Pf; l += 32) {
      live[l] = -1;
      lstart[l + 1] = carry;
    }
    if (lane == 0) {
      live[Pf] = nl;
      lstart[nl] = carry;
    }
    for (int t = carry + lane; t < d.Bp(); t += 32) {
      rows[t] = -1;
      xwg[t] = F(0);
    }
    __syncwarp();
    // the rows, grouped by slot and in row order inside each slot: per
    // 32 rows, the lanes of one slot take consecutive places
    for (int base = 0; base < B; base += 32) {
      const int b = base + lane;
      const int s = b < B ? sg[b] : -1;
      const bool ok = s >= 0 && s < Pf;
      const unsigned grp = __match_any_sync(0xffffffffu, ok ? s : -1);
      const int leader = __ffs(grp) - 1;
      int pos = 0;
      if (ok && lane == leader) {
        pos = cur[s];
        cur[s] = pos + __popc(grp);
      }
      pos = __shfl_sync(0xffffffffu, pos, leader);
      if (ok) {
        const int t = pos + __popc(grp & ((1u << lane) - 1u));
        rows[t] = b;
        xwg[t] = xw[(size_t)c * B + b];
      }
    }
  }
  __syncthreads();
  // pad slots drawn here (S = 0, t = 0: A = diag(lam), rhs = lam mu; the
  // full path's off-diagonal terms are all signed zeros, so these
  // diagonal steps give its values); live slots' operands gathered
  const F alpha = *alpha_p;
  const F eps8 = F(8) * Lim<F>::eps();
  const F tiny = Lim<F>::tiny();
  F* uops = L.uops + (size_t)c * d.U();
  for (int idx = tid; idx < Pf * Dp; idx += kPrepThreads) {
    const int p = idx / Dp;
    const int j = idx - p * Dp;
    const size_t at = ((size_t)c * Pf + p) * Dp + j;
    const int lo = lord[p];
    if (lo < 0) {
      const F lj = lam[at];
      const F ajj = alpha * F(0) + lj;
      const F floor_j = fmax(eps8 * fabs(ajj) + tiny, lj);
      const F pivot = fmax(ajj, floor_j);
      const F ljj = pivot * rsqrt_(pivot);
      const F z = (alpha * F(0) + lj * mu[at]) / ljj + xi[at];
      u_out[at] = z / ljj;
    } else {
      F* o = uops + (size_t)lo * 4 * Dp + j;
      o[0] = u0[at];
      o[Dp] = lam[at];
      o[2 * Dp] = mu[at];
      o[3 * Dp] = xi[at];
    }
  }
}

// ---------------------------------------------------------------------------
// The chain kernel: one CTA walks the colors in order.
// ---------------------------------------------------------------------------

template <typename F>
struct Stage {
  int* rows;    // [capR]
  F* xwg;       // [capR]
  int* lstart;  // [Pfp]
  int* live;    // [Pfp]
  F* uops;      // [capL][4][Dp]

  __device__ static Stage at(unsigned char* base, const Dims& d, int capR) {
    Stage s;
    s.rows = reinterpret_cast<int*>(base);
    s.lstart = s.rows + capR;
    s.live = s.lstart + d.Pfp();
    s.xwg = reinterpret_cast<F*>(s.live + d.Pfp());
    s.uops = s.xwg + capR;
    return s;
  }
};

// cp.async of color c's lists into stage s (16-byte pieces; every piece
// is 16-byte aligned: Bp, Pfp and U are multiples of 4 elements).
template <typename F>
__device__ void issue_stage(const Stage<F>& s, const Lists<F>& L,
                            const Dims& d, int c, int capR, int capL) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int* g_rows = L.rows + (size_t)c * d.Bp();
  const int* g_ls = L.lstart + (size_t)c * d.Pfp();
  const int* g_lv = L.live + (size_t)c * d.Pfp();
  const F* g_xw = L.xwg + (size_t)c * d.Bp();
  const F* g_u = L.uops + (size_t)c * d.U();
  constexpr int kPerF = 16 / sizeof(F);
  const int n_rows = capR / 4;
  const int n_pf = d.Pfp() / 4;
  const int n_xw = capR / kPerF;
  const int n_u = (capL * 4 * d.Dp() + kPerF - 1) / kPerF;
  const int total = n_rows + 2 * n_pf + n_xw + n_u;
  for (int k = tid; k < total; k += nt) {
    int q = k;
    if (q < n_rows) {
      cp_async16(s.rows + 4 * q, g_rows + 4 * q);
      continue;
    }
    q -= n_rows;
    if (q < n_pf) {
      cp_async16(s.lstart + 4 * q, g_ls + 4 * q);
      continue;
    }
    q -= n_pf;
    if (q < n_pf) {
      cp_async16(s.live + 4 * q, g_lv + 4 * q);
      continue;
    }
    q -= n_pf;
    if (q < n_xw) {
      cp_async16(s.xwg + kPerF * q, g_xw + kPerF * q);
      continue;
    }
    q -= n_xw;
    cp_async16(s.uops + kPerF * q, g_u + kPerF * q);
  }
}

// S(a, b) of a live slot's (R+1)-dim draw from its statistics sv,
// v_old = up[1..R]; b == Dp gives t_a.
template <typename F>
__device__ F s_entry(const F* sv, const F* up, int D, int n_tri, int a,
                     int b) {
  const int Dp = D - 1;
  if (b == Dp) {
    return a == 0 ? sv[n_tri + D + 1]
                  : sv[n_tri + D + 1 + a + 1] - sv[1] * up[a];
  }
  if (a > b) {
    const int t = a;
    a = b;
    b = t;
  }
  auto tri = [&](int i, int j) { return i * D - (i * (i - 1)) / 2 + (j - i); };
  if (a == 0) {
    if (b == 0) return sv[0];
    return sv[tri(0, b + 1)] - sv[n_tri] * up[b];
  }
  const F va = up[a];
  const F vb = up[b];
  return sv[tri(a + 1, b + 1)] - va * sv[n_tri + b + 1] -
         sv[n_tri + a + 1] * vb + sv[n_tri + D] * va * vb;
}

// One live slot's draw, by one warp: its S [Dp][Dp] and t [Dp] and its
// operands.
template <typename F>
struct Draw {
  const F* Sm;
  const F *up, *lp, *mp, *xp;  // u0, lam, mu, xi [Dp]
  F alpha, eps8, tiny;
  int D;

  // the right-hand side alpha (S u0 - t) + lam mu of row r, with row r
  // of A = alpha S + diag(lam) through put(m, A_rm) for m < Dp
  template <typename Put>
  __device__ F row(int r, Put put) const {
    const int Dp = D - 1;
    F acc = F(0);
    for (int m = 0; m < Dp; ++m) {
      const F s = Sm[r * Dp + m];
      acc = m == 0 ? s * up[0] : acc + s * up[m];
      put(m, alpha * s + (r == m ? lp[r] : F(0)));
    }
    return alpha * (acc - Sm[Dp * Dp + r]) + lp[r] * mp[r];
  }
};

// The draw with lane r owning row r of A in registers (Dp <= kN).  The
// right-looking Cholesky takes pivot
// column j's entries by __shfl_sync, each entry's updates subtracting in
// the order k = 0..j-1 as the plain version; the solves divide by L[j][j]
// as it does; L^T is read from a per-warp shared copy of L.
template <typename F, int kN>
__device__ void draw_regs(const Draw<F>& w, F* scr, F* out, F* dl,
                          int lane, long long* sub, long long& ts) {
  constexpr unsigned kAll = 0xffffffffu;
  const int Dp = w.D - 1;
  const int r = lane;
  const bool own = r < Dp;
  F a[kN];
  F rhs = F(0), dorig = F(0);
  {
    F acc = F(0);
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      const F sm = own && m < Dp ? w.Sm[r * Dp + m] : F(0);
      if (m < Dp) acc = m == 0 ? sm * w.up[0] : acc + sm * w.up[m];
      a[m] = w.alpha * sm + (m == r ? w.lp[r] : F(0));
      if (m == r) dorig = a[m];
    }
    if (own) rhs = w.alpha * (acc - w.Sm[Dp * Dp + r]) + w.lp[r] * w.mp[r];
  }
  const F fl = own ? fmax(w.eps8 * fabs(dorig) + w.tiny, w.lp[r]) : F(0);
  tick(sub, 0, ts);
  // column j before scaling goes through shared memory (two buffers by
  // the parity of j), so a step takes one __syncwarp and no shuffles
  // The forward solve L z = rhs rides along: rhs_j is final at step j.
  F* colv = scr + kN * (kN + 1);  // [2][kN + 1]: column j, then rhs_j
  F* fbuf = colv + 2 * (kN + 1);  // [kN] pivot floors
  if (own) fbuf[r] = fl;
  F z = F(0), dg = F(0);  // z_r and L[r][r]
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (j < Dp) {
      F* cv = colv + (j & 1) * (kN + 1);
      if (own && r >= j) cv[r] = a[j];
      if (r == j) cv[kN] = rhs;
      __syncwarp();
      const F pivot = fmax(cv[j], fbuf[j]);
      const F inv_d = rsqrt_(pivot);
      const F ljj = pivot * inv_d;
      const F zj = cv[kN] / ljj;  // lane j's rhs_j / L[j][j]
      if (r == j) {
        a[j] = ljj;
        dg = ljj;
        z = zj;
      } else if (own && r > j) {
        a[j] *= inv_d;
        rhs -= a[j] * zj;
      }
#pragma unroll
      for (int m = j + 1; m < kN; ++m) {
        // cv[m] * inv_d: the L[m][j] that lane m holds, the same bits
        if (m < Dp && own && r >= m) a[m] -= a[j] * (cv[m] * inv_d);
      }
    }
  }
  tick(sub, 1, ts);
  // L^T s = z + xi, with column r of L from the shared copy
  const int ld = kN + 1;
#pragma unroll
  for (int m = 0; m < kN; ++m) {
    if (own && m <= r) scr[r * ld + m] = a[m];
  }
  __syncwarp();
  F col[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    col[j] = own && j > r && j < Dp ? scr[j * ld + r] : F(0);
  }
  F acc = own ? z + w.xp[r] : F(0);
  F s_own = F(0);
#pragma unroll
  for (int j = kN - 1; j >= 0; --j) {
    if (j < Dp) {
      const F sj = __shfl_sync(kAll, r == j ? acc / dg : F(0), j);
      if (r == j) s_own = sj;
      else if (r < j) acc -= col[j] * sj;
    }
  }
  F c0 = F(0);
  if (own) {
    out[r] = s_own;
    const F d = s_own - w.up[r];
    dl[r] = d;
    if (r >= 1) c0 = w.up[r] * d;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c0 += __shfl_xor_sync(kAll, c0, off);
  if (lane == 0) dl[Dp] = c0;
  tick(sub, 2, ts);
}

// The draw for Dp > kRegDp: lane i owns rows i and i + 32 of A in a
// per-warp shared scratch [Dp][ld], with the same steps.
template <typename F>
__device__ void draw_smem(const Draw<F>& w, F* A, F* out, F* dl, int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const int Dp = w.D - 1;
  const int ld = a_ld(Dp);
  F acc[2], dorig[2], sol[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane + 32 * h;
    acc[h] = dorig[h] = sol[h] = F(0);
    if (r < Dp) {
      acc[h] = w.row(r, [&](int m, F v) {
        if (m <= r) A[r * ld + m] = v;
      });
      dorig[h] = A[r * ld + r];
    }
  }
  __syncwarp();
  // right-looking Cholesky, one pivot column per step
  for (int j = 0; j < Dp; ++j) {
    F inv_d = F(0);
    if (lane == (j & 31)) {
      const F dj = (j >> 5) ? dorig[1] : dorig[0];
      const F floor_j = fmax(w.eps8 * fabs(dj) + w.tiny, w.lp[j]);
      const F pivot = fmax(A[j * ld + j], floor_j);
      inv_d = rsqrt_(pivot);
      A[j * ld + j] = pivot * inv_d;
    }
    inv_d = __shfl_sync(kAll, inv_d, j & 31);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (r > j && r < Dp) A[r * ld + j] *= inv_d;
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (r > j && r < Dp) {
        const F lrj = A[r * ld + j];
        for (int m = j + 1; m <= r; ++m) A[r * ld + m] -= lrj * A[m * ld + j];
      }
    }
    __syncwarp();
  }
  // L z = rhs: z_j final at step j, then each later row subtracts
  for (int j = 0; j < Dp; ++j) {
    F z = F(0);
    if (lane == (j & 31)) {
      z = ((j >> 5) ? acc[1] : acc[0]) / A[j * ld + j];
      if (j >> 5) sol[1] = z; else sol[0] = z;
    }
    z = __shfl_sync(kAll, z, j & 31);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (r > j && r < Dp) acc[h] -= A[r * ld + j] * z;
    }
  }
  // L^T s = z + xi
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane + 32 * h;
    if (r < Dp) acc[h] = sol[h] + w.xp[r];
  }
  for (int j = Dp - 1; j >= 0; --j) {
    F s = F(0);
    if (lane == (j & 31)) {
      s = ((j >> 5) ? acc[1] : acc[0]) / A[j * ld + j];
      if (j >> 5) sol[1] = s; else sol[0] = s;
    }
    s = __shfl_sync(kAll, s, j & 31);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (r < j) acc[h] -= A[j * ld + r] * s;
    }
  }
  F c0 = F(0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane + 32 * h;
    if (r < Dp) {
      out[r] = sol[h];
      const F d = sol[h] - w.up[r];
      dl[r] = d;
      if (r >= 1) c0 += w.up[r] * d;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c0 += __shfl_xor_sync(kAll, c0, off);
  if (lane == 0) dl[Dp] = c0;
}

template <typename F, bool kSlotsInSmem, bool kTimed>
__global__ void __launch_bounds__(kMaxThreads)
joint_tail_kernel(F* __restrict__ G,   // [B][D*D]
                  F* __restrict__ At,  // [B][R]
                  F* __restrict__ Ct,  // [B]
                  const F* __restrict__ alpha_p,
                  F* __restrict__ u_out,  // [C][Pf][Dp]: live slots
                  Lists<F> L, Dims d, int capR, int capL,
                  long long* __restrict__ clk) {  // [kPhases + kSubPhases]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = d.D, R = d.R(), Dp = d.Dp(), DD = D * D, Pf = d.Pf;
  const int n_tri = d.n_tri();
  const int n_stats = d.n_stats();
  const int nt = blockDim.x;
  const int n_warps = nt >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  unsigned char* at = smem_raw;
  F* part = reinterpret_cast<F*>(at);  // [nt][4] statistics partials
  at += align16((size_t)nt * 4 * sizeof(F));
  F* wscr = reinterpret_cast<F*>(at + (size_t)warp * warp_bytes<F>(d));
  at += (size_t)n_warps * warp_bytes<F>(d);
  // the update's row groups: W lanes each, gpw per warp, one slab each
  const int W = row_lanes(D);
  const int gpw = 32 / W;
  const int gl = lane & (W - 1);
  F* slab = reinterpret_cast<F*>(reinterpret_cast<unsigned char*>(wscr) +
                                 draw_bytes<F>(d)) +
            (size_t)(lane / W) * slab_size(D);  // [D*D]
  F* sv = slab + DD;  // s
  F* gv = sv + D;     // G s
  F* pv = gv + D;     // p
  F* rv = pv + D;     // r
  F* at_s = rv + D;   // Atot row [R]
  F* ct_s = at_s + R; // Ct
  int* tri_i = reinterpret_cast<int*>(at);  // [n_tri]
  int* tri_j = tri_i + n_tri;               // [n_tri]
  at += align16(2 * (size_t)n_tri * sizeof(int));
  Stage<F> stage[2];
  stage[0] = Stage<F>::at(at, d, capR);
  at += stage_bytes<F>(d, capR, capL);
  stage[1] = Stage<F>::at(at, d, capR);
  at += stage_bytes<F>(d, capR, capL);
  unsigned char* slot_raw = kSlotsInSmem ? at : L.slot_ws;
  F* stats = reinterpret_cast<F*>(slot_raw);         // [Pf][n_stats]
  F* dlt = stats + (size_t)Pf * n_stats;             // [Pf][Dp + 1]
  F* Smat = dlt + (size_t)Pf * (Dp + 1);             // [Pf][Dp*Dp + Dp]
  const int n_s = s_size(d);

  const F eps8 = F(8) * Lim<F>::eps();
  const F tiny = Lim<F>::tiny();
  const F alpha = *alpha_p;

  for (int k = tid; k < n_tri; k += nt) {
    int i = 0, rem = k;
    while (rem >= D - i) {
      rem -= D - i;
      ++i;
    }
    tri_i[k] = i;
    tri_j[k] = i + rem;
  }

  __shared__ long long acc_clk[kPhases + kSubPhases];
  long long t_prev = 0;
  long long* sub = kTimed ? acc_clk + kPhases : nullptr;
  long long ts = 0;  // thread 0's clock inside a phase
  auto mark = [&](int k) {
    if (kTimed && tid == 0) {
      const long long t = clock64();
      acc_clk[k] += t - t_prev;
      t_prev = t;
    }
  };
  if (kTimed && tid == 0) {
    for (int k = 0; k < kPhases + kSubPhases; ++k) acc_clk[k] = 0;
    t_prev = clock64();
  }

  if (d.C > 0) issue_stage(stage[0], L, d, 0, capR, capL);
  cp_async_commit();

  for (int c = 0; c < d.C; ++c) {
    // -- color c's stage: issue c+1's copies, wait for c's --
    if (c + 1 < d.C) issue_stage(stage[(c + 1) & 1], L, d, c + 1, capR, capL);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const Stage<F> st = (c & 1) ? stage[1] : stage[0];
    const int* g_rows = L.rows + (size_t)c * d.Bp();
    const F* g_xw = L.xwg + (size_t)c * d.Bp();
    const F* g_u = L.uops + (size_t)c * d.U();
    auto row_at = [&](int t) { return t < capR ? st.rows[t] : g_rows[t]; };
    auto xw_at = [&](int t) { return t < capR ? st.xwg[t] : g_xw[t]; };
    auto uop = [&](int l) {  // (u0, lam, mu, xi) of live slot l
      return l < capL ? st.uops + (size_t)l * 4 * Dp
                      : g_u + (size_t)l * 4 * Dp;
    };
    const int nl = st.live[Pf];
    const int n = st.lstart[nl];
    // each row group's first row of the update (its Gram, Atot row, Ct)
    // by cp.async: the draw does not change them
    {
      const int t = warp * gpw + lane / W;
      if (t < n) {
        const int b = row_at(t);
        for (int k = gl; k < DD; k += W) cp_async_one(slab + k, G + (size_t)b * DD + k);
        for (int r = gl; r < R; r += W) cp_async_one(at_s + r, At + (size_t)b * R + r);
        if (gl == 0) cp_async_one(ct_s, Ct + b);
      }
      cp_async_commit();
    }
    mark(0);

    // -- statistics: items (live slot, triangle entry), each over a fixed
    // stride of its slot's rows; groups' partials added in group order --
    const int items = nl * n_tri;
    const int groups = items >= nt || items == 0 ? 1 : nt / items;
    for (int w = tid; w < items * groups; w += nt) {
      const int g = w / items;
      const int it = w - g * items;
      const int l = it / n_tri;
      const int k = it - l * n_tri;
      const int i = tri_i[k], j = tri_j[k];
      const int off = i * D + j;
      F a2 = F(0), a3 = F(0), a4 = F(0), a1 = F(0);
      const int t1 = st.lstart[l + 1];
      int t = st.lstart[l] + g;
      for (; t + 7 * groups < t1; t += 8 * groups) {
        int bq[8];
        F xq[8], gq[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          bq[u] = row_at(t + u * groups);
          xq[u] = xw_at(t + u * groups);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) gq[u] = G[(size_t)bq[u] * DD + off];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const F x = xq[u];
          const F x2 = x * x;
          a2 += x2 * gq[u];
          if (i == 0) a3 += x2 * x * gq[u];
          if (k == 0) a4 += x2 * x2 * gq[u];
          if (i == 1 || k == 1) a1 += x * gq[u];
        }
      }
      for (; t < t1; t += groups) {
        const F x = xw_at(t);
        const F gv = G[(size_t)row_at(t) * DD + off];
        const F x2 = x * x;
        a2 += x2 * gv;
        if (i == 0) a3 += x2 * x * gv;
        if (k == 0) a4 += x2 * x2 * gv;
        if (i == 1 || k == 1) a1 += x * gv;
      }
      if (groups == 1) {
        F* s = stats + (size_t)l * n_stats;
        s[k] = a2;
        if (i == 0) s[n_tri + j] = a3;
        if (k == 0) s[n_tri + D] = a4;
        if (i == 1 || k == 1) s[n_tri + D + 1 + (i == 1 ? j : 0)] = a1;
      } else {
        F* pp = part + (size_t)w * 4;
        pp[0] = a2;
        pp[1] = a3;
        pp[2] = a4;
        pp[3] = a1;
      }
    }
    if (groups > 1) {
      __syncthreads();
      for (int it = tid; it < items; it += nt) {
        const int l = it / n_tri;
        const int k = it - l * n_tri;
        const int i = tri_i[k], j = tri_j[k];
        F a[4];
        for (int q = 0; q < 4; ++q) a[q] = part[(size_t)it * 4 + q];
        for (int g = 1; g < groups; ++g) {
          for (int q = 0; q < 4; ++q) a[q] += part[((size_t)g * items + it) * 4 + q];
        }
        F* s = stats + (size_t)l * n_stats;
        s[k] = a[0];
        if (i == 0) s[n_tri + j] = a[1];
        if (k == 0) s[n_tri + D] = a[2];
        if (i == 1 || k == 1) s[n_tri + D + 1 + (i == 1 ? j : 0)] = a[3];
      }
    }
    __syncthreads();
    // S and t of each live slot, an entry per thread
    for (int e = tid; e < nl * n_s; e += nt) {
      const int l = e / n_s;
      const int q = e - l * n_s;
      const int a = q < Dp * Dp ? q / Dp : q - Dp * Dp;
      const int b2 = q < Dp * Dp ? q - a * Dp : Dp;
      Smat[e] = s_entry(stats + (size_t)l * n_stats, uop(l), D, n_tri, a, b2);
    }
    __syncthreads();
    mark(1);
    ts = t_prev;

    // -- the draw: one warp per live slot --
    for (int l = warp; l < nl; l += n_warps) {
      const F* uo = uop(l);
      F* out = u_out + ((size_t)c * Pf + st.live[l]) * Dp;
      F* dl = dlt + (size_t)l * (Dp + 1);
      const Draw<F> dr{Smat + (size_t)l * n_s, uo, uo + Dp, uo + 2 * Dp,
                       uo + 3 * Dp, alpha, eps8, tiny, D};
      if (Dp <= kRegDp) {
        draw_regs<F, kRegDp>(dr, wscr, out, dl, lane, sub, ts);
      } else {
        draw_smem(dr, wscr, out, dl, lane);
      }
      __syncwarp();
    }
    cp_async_wait_all();  // the update's prefetched rows
    __syncthreads();
    mark(2);
    ts = t_prev;

    // -- Ct, Atot and G <- T G T^T, one group of W lanes per touched row
    // (half a warp while D <= 16): the row's Gram read once into the
    // group's slab (the first row by the prefetch above), written once --
    for (int t0 = warp * gpw; t0 < n; t0 += n_warps * gpw) {
      const int t = t0 + lane / W;  // whole warps iterate: shuffles below
      const bool act = t < n;
      int b = 0;
      F x = F(0);
      const F* dl = dlt;
      if (act) {
        b = row_at(t);
        x = xw_at(t);
        // the live slot owning place t: the last l with lstart[l] <= t
        int lo = 0, hi = nl - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (st.lstart[mid] <= t) lo = mid; else hi = mid - 1;
        }
        dl = dlt + (size_t)lo * (Dp + 1);
      }
      F* Gr = G + (size_t)b * DD;
      F* Ab = At + (size_t)b * R;
      if (t0 != warp * gpw) {  // rows after a group's first
        if (act) {
          for (int k = gl; k < DD; k += W) cp_async_one(slab + k, Gr + k);
          for (int r = gl; r < R; r += W) cp_async_one(at_s + r, Ab + r);
          if (gl == 0) cp_async_one(ct_s, Ct + b);
        }
        cp_async_commit();
        cp_async_wait_all();
      }
      const F a0 = x * dl[0] - x * x * dl[Dp];
      if (act) {
        for (int i = gl; i < D; i += W) {
          sv[i] = i == 0 ? a0 : i == 1 ? F(0) : dl[i - 1] * x;
        }
      }
      __syncwarp();
      F sgs = F(0), cta = F(0);
      if (act) {
        for (int i = gl; i < D; i += W) {
          F a = F(0);
#pragma unroll 4
          for (int j = 0; j < D; ++j) a += slab[i * D + j] * sv[j];
          gv[i] = a;
          sgs += sv[i] * a;
        }
        for (int r = gl; r < R; r += W) cta += sv[2 + r] * at_s[r];
      }
      tick(sub, 3, ts);
      for (int off = W >> 1; off > 0; off >>= 1) {
        sgs += __shfl_xor_sync(0xffffffffu, sgs, off);
        cta += __shfl_xor_sync(0xffffffffu, cta, off);
      }
      __syncwarp();
      if (act) {
        const F g0 = gv[0];
        const F G00 = slab[0];
        for (int i = gl; i < D; i += W) {
          const F shi = i >= 2 ? sv[i] : F(0);
          F pi = gv[i] + g0 * shi;
          if (i == 1) pi += F(0.5) * sgs;
          pv[i] = pi;
          rv[i] = slab[i * D] + F(0.5) * G00 * shi;
        }
        if (gl == 0) Ct[b] = ct_s[0] + a0 + cta;
        for (int r = gl; r < R; r += W) Ab[r] = at_s[r] + sv[2 + r];
      }
      __syncwarp();
      tick(sub, 4, ts);
      if (act) {
        // lane owns column j: each store writes a row's D neighbours
        for (int j = gl; j < D; j += W) {
          const F shj = j >= 2 ? sv[j] : F(0);
          const F pj = pv[j];
          const F rj = rv[j];
          for (int i = 0; i < D; ++i) {
            const F shi = i >= 2 ? sv[i] : F(0);
            const F corr = (i == 1 ? pj : F(0)) + (j == 1 ? pv[i] : F(0)) +
                           shi * rj + rv[i] * shj;
            Gr[i * D + j] = slab[i * D + j] + corr;
          }
        }
      }
      __syncwarp();
      tick(sub, 5, ts);
    }
    __syncthreads();
    mark(3);
  }
  if (kTimed && tid == 0) {
    for (int k = 0; k < kPhases + kSubPhases; ++k) clk[k] = acc_clk[k];
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool valid(const Dims& d) {
  return d.C >= 0 && d.B >= 1 && d.Pf >= 1 && d.D >= 3 && d.D <= 65;
}

template <typename F>
long long workspace_bytes(const Dims& d) {
  if (!valid(d)) return -(long long)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = choose_plan<F>(d, &p);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)(Lists<F>::list_bytes(d) +
                     (p.slots_in_smem ? 0 : slot_bytes<F>(d)));
}

template <typename F>
int prep(const Dims& d, const int* segb, const void* xw, const void* u0,
         const void* lam, const void* mu, const void* xi, const void* alpha,
         void* u_out, void* ws, size_t ws_bytes, void* stream) {
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  if (ws_bytes < Lists<F>::list_bytes(d)) return (int)cudaErrorInvalidValue;
  if (d.C == 0) return 0;
  const Lists<F> L = Lists<F>::carve(static_cast<unsigned char*>(ws), d);
  const size_t smem = 3 * (size_t)d.Pf * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tail_prep_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tail_prep_kernel<F><<<d.C, kPrepThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      segb, static_cast<const F*>(xw), static_cast<const F*>(u0),
      static_cast<const F*>(lam), static_cast<const F*>(mu),
      static_cast<const F*>(xi), static_cast<const F*>(alpha),
      static_cast<F*>(u_out), L, d);
  return (int)cudaGetLastError();
}

template <typename F, bool kSlotsInSmem, bool kTimed>
int run_chain(const Plan& p, const Dims& d, void* G, void* At, void* Ct,
              const void* alpha, void* u_out, const Lists<F>& L,
              long long* clk, void* stream) {
  auto* kern = joint_tail_kernel<F, kSlotsInSmem, kTimed>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<1, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<F*>(G), static_cast<F*>(At), static_cast<F*>(Ct),
      static_cast<const F*>(alpha), static_cast<F*>(u_out), L, d, p.capR,
      p.capL, clk);
  return (int)cudaGetLastError();
}

template <typename F>
int chain(const Dims& d, void* G, void* At, void* Ct, const void* alpha,
          void* u_out, void* ws, size_t ws_bytes, void* stream,
          long long* clk) {
  if (!valid(d) || (clk != nullptr) != kTimedBuild) {
    return (int)cudaErrorInvalidValue;
  }
  Plan p;
  const cudaError_t err = choose_plan<F>(d, &p);
  if (err != cudaSuccess) return (int)err;
  if (ws_bytes < Lists<F>::list_bytes(d) +
                     (p.slots_in_smem ? 0 : slot_bytes<F>(d))) {
    return (int)cudaErrorInvalidValue;
  }
  if (d.C == 0) return 0;
  const Lists<F> L = Lists<F>::carve(static_cast<unsigned char*>(ws), d);
  return p.slots_in_smem
             ? run_chain<F, true, kTimedBuild>(p, d, G, At, Ct, alpha, u_out,
                                               L, clk, stream)
             : run_chain<F, false, kTimedBuild>(p, d, G, At, Ct, alpha,
                                                u_out, L, clk, stream);
}

}  // namespace

extern "C" {

// Bytes of device workspace the tail needs at these dims (on the current
// device), or minus the cudaError_t.
long long myfm_joint_tail_workspace(int is_double, int C, int B, int Pf,
                                    int D) {
  const Dims d{C, B, Pf, D};
  return is_double ? workspace_bytes<double>(d)
                   : workspace_bytes<float>(d);
}

// The workspace's lists: byte offsets of rows, lstart and live, then
// their row strides (int32 [C][round4(B)], [C][round4(Pf + 1)] twice).
void myfm_joint_tail_lists_layout(int C, int B, int Pf, long long* out) {
  const Dims d{C, B, Pf, 3};
  out[0] = 0;
  out[1] = (long long)C * d.Bp() * sizeof(int);
  out[2] = out[1] + (long long)C * d.Pfp() * sizeof(int);
  out[3] = d.Bp();
  out[4] = d.Pfp();
}

// The prep kernel: each color's lists into ws, and the pad slots' draws
// into u_out.
int myfm_joint_tail_prep(int is_double, const void* segb, const void* xw,
                         const void* u0, const void* lam, const void* mu,
                         const void* xi, const void* alpha, void* u_out,
                         void* ws, size_t ws_bytes, int C, int B, int Pf,
                         int D, void* stream) {
  const Dims d{C, B, Pf, D};
  const int* sg = static_cast<const int*>(segb);
  return is_double ? prep<double>(d, sg, xw, u0, lam, mu, xi, alpha, u_out,
                                  ws, ws_bytes, stream)
                   : prep<float>(d, sg, xw, u0, lam, mu, xi, alpha, u_out,
                                 ws, ws_bytes, stream);
}

// The chain over every color, in place on G ([B][D*D]), At ([B][R]) and
// Ct ([B]), reading the lists myfm_joint_tail_prep wrote; writes the
// live slots' u_out.  clk is null in the production build; the timed
// build (-DMYFM_JOINT_TAIL_TIMED) needs it (device int64 [kPhases +
// kSubPhases]) and thread 0 adds the clock64() cycles of each phase
// (stage, statistics, draw, update) of every color, then of each step of
// its own path.  Returns 0 or the cudaError_t.
int myfm_joint_tail_chain(int is_double, void* G, void* At, void* Ct,
                          const void* alpha, void* u_out, void* ws,
                          size_t ws_bytes, int C, int B, int Pf, int D,
                          void* stream, void* clk) {
  const Dims d{C, B, Pf, D};
  long long* ck = static_cast<long long*>(clk);
  return is_double ? chain<double>(d, G, At, Ct, alpha, u_out, ws, ws_bytes,
                                   stream, ck)
                   : chain<float>(d, G, At, Ct, alpha, u_out, ws, ws_bytes,
                                  stream, ck);
}

}  // extern "C"
