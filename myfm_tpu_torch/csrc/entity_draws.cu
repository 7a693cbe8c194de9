// The entity draws of one one-hot table of the categorical fast path, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package writes the same draws as a
// Python loop (myfm_tpu/ops/categorical.py _entity_draws, the factor scan at
// :487) that XLA compiles into one program.  Run eagerly, that loop is ~15
// small launches a factor, ~2,200 a table at rank 128, and their enqueue
// paced the whole sweep.  Python side: myfm_tpu_torch/ops/entity_draws.py;
// the plain PyTorch version that states the same arithmetic is
// ops/categorical.py _entity_draws.
//
// What it computes.  For every entity b of the table, from its Gram
// G_b [D, D] (D = R + 2) over z = [1 | e0 | phi], e0 the residual without w0:
//   card = G[0,0], E1 = G[0,1] + w0 card, Sphi_s = G[0,2+s],
//   EQ_s = G[1,2+s] + w0 Sphi_s;
//   fit_linear:  quad = alpha card + lam_w[g],
//                lin = alpha (card w - E1) + lam_w[g] mu_w[g],
//                w' = lin / quad + xi_w rsqrt(quad),  EQ_s += (w' - w) Sphi_s;
//   then the factors in order, r = 0 .. R-1:
//                quad = alpha G[2+r,2+r] + lam_V[g,r],
//                lin = alpha (G[2+r,2+r] v_r - EQ_r) + lam_V[g,r] mu_V[g,r],
//                v_r' = lin / quad + xi_r rsqrt(quad),
//                EQ_s += (v_r' - v_r) G[2+r,2+s]  for every s > r.
// Asked for the moments (the sweep's last table), each entity also writes
// its post-draw residual sums: with a = w0 + w' - w and EQ_r as drawn,
//   sum e   = E1 + (w' - w) card + sum_r delta_r Sphi_r,
//   sum e^2 = G[1,1] + a (2 G[0,1] + a card)
//             + sum_r delta_r (2 EQ_r + delta_r G[2+r,2+r])
// (c' G c for c = [a | 1 | delta], as the plain version expands it), which
// the wrapper adds over the entities.
// g is the entity's group; alpha and w0 are read from device memory.  IEEE
// arithmetic: a true division, rsqrt as PyTorch's, no fast-math flags.  EQ
// accumulates in factor order (the plain version adds 8 factors at a time),
// so float32 results differ from it by rounding only.
//
// What bounds it.  Entities are independent; each one's R draws form a
// chain.  Each entity reads the upper triangle of its Gram's factor block
// (row r from column r: R (R + 1) / 2 values), rows 0 and 1, and its R
// weights, noises and draws: ~33 KB at rank 128 in float32, 3.0 GB over the
// three ML-10M tables, 0.9 ms at 3.35 TB/s.  Each step is a dependent chain
// (a shared-memory read, the division, a shuffle, the fma) that the other
// resident warps overlap; the bytes are the bound (PERF.md has the kernel's
// time beside it).
//
// The design.  One warp per entity.  Lane l owns the factors s = 32 k + l of
// a panel of 32 NPL factors (NPL from R: 1 up to rank 32, 2 up to 64, else
// 4) and keeps their EQ_s, v_s, lam, lam mu and noise in registers.  Step r:
// the lane that owns r draws and broadcasts its delta with __shfl_sync, and
// every lane adds delta G[2+r, 2+s] to its EQ_s.  G does not depend on the
// draws, so the rows stream ahead of the scan: each warp keeps kAhead rows
// in flight with cp.async into its own ring of kAhead + 1 rows in shared
// memory, one commit group a row.  Each lane copies and reads only its own
// factors' entries, so a step needs no barrier: a wait_group for its row,
// and its refill goes to the slot the step before has read.  The steps of
// a slot run as a loop: fully unrolled, rank 128's 128 steps of straight
// code ran 2x slower (likely instruction fetch: each warp is at its own
// place in ~100 KB of code).  Factors past the panel (R > 128) keep their
// EQ_s in their own slot of the output row V_new[b], which only lane
// s mod 32 touches until its panel draws it, and read their rows of G
// directly; so the launch takes any R.  Each entity's sums run in one
// fixed order and nothing is atomic: two runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // entities (warps) per block
// rows of G in flight per warp: 4 in float32, 2 in float64 (a ring of
// kAhead + 1 rows of 32 NPL values per warp, <= 12 KB a block); 8 or 16
// rows ran no faster
template <typename F>
constexpr int kAhead = 16 / (int)sizeof(F);

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

template <typename F>
__device__ __forceinline__ void cp_async_one(F* dst, const F* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(F))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts copying this lane's part of row r of the factor block (row points
// at G[2+r][2]) into dst: the panel's factors s >= r, s < R, in slots
// k >= k_lo, to dst[32 k + lane].  Other entries of dst are left as they
// are (nothing reads them).
template <typename F, int NPL>
__device__ __forceinline__ void fetch_row(F* dst, const F* row, int r,
                                          int p0, int R, int lane,
                                          int k_lo) {
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int s = p0 + 32 * k + lane;
    if (k >= k_lo && s >= r && s < R) {
      cp_async_one(dst + 32 * k + lane, row + s);
    }
  }
}

// EQ_s before the factor draws: G[1, 2+s] + w0 Sphi_s, plus dw Sphi_s
// after a linear draw.
template <typename F>
__device__ __forceinline__ F eq_start(const F* G1, const F* Sphi, int s,
                                      F w0, F dw, int fit_linear) {
  F e = G1[s] + w0 * Sphi[s];
  if (fit_linear) e = e + dw * Sphi[s];
  return e;
}

template <typename F, int NPL>
__global__ void __launch_bounds__(kWarps * 32)
entity_draws_kernel(const F* __restrict__ G, const F* __restrict__ w0p,
                    const F* __restrict__ alphap, const F* __restrict__ w_t,
                    const F* __restrict__ V_t,
                    const int64_t* __restrict__ g_t,
                    const F* __restrict__ lambda_w,
                    const F* __restrict__ mu_w,
                    const F* __restrict__ lambda_V,
                    const F* __restrict__ mu_V,
                    const F* __restrict__ noise_w,
                    const F* __restrict__ noise_V, F* __restrict__ w_new,
                    F* __restrict__ V_new, F* __restrict__ moments, int B,
                    int R, int fit_linear) {
  constexpr int PW = 32 * NPL;
  constexpr int A = kAhead<F>;
  __shared__ F ring_all[kWarps][A + 1][PW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp
  F(*ring)[PW] = ring_all[warp];
  const int D = R + 2;
  const F* Gb = G + (size_t)b * D * D;
  const F alpha = *alphap, w0 = *w0p;
  const int64_t g = g_t[b];

  // the linear draw, every lane alike
  const F card = Gb[0];
  const F E1 = Gb[1] + w0 * card;
  const F w_old = w_t[b];
  F dw = F(0), wn = w_old;
  if (fit_linear) {
    const F lam = lambda_w[g];
    const F quad = alpha * card + lam;
    const F lin = alpha * (card * w_old - E1) + lam * mu_w[g];
    wn = lin / quad + noise_w[b] * rsqrt_(quad);
    dw = wn - w_old;
  }
  if (lane == 0) w_new[b] = wn;

  const F* Sphi = Gb + 2;
  const F* G1 = Gb + D + 2;
  const F* Vo = V_t + (size_t)b * R;
  const F* nzb = noise_V + (size_t)b * R;
  const F* lamg = lambda_V + g * R;
  const F* mug = mu_V + g * R;
  F* Vn = V_new + (size_t)b * R;
  const int n_slots = (R + 31) / 32;
  // this lane's parts of sum_r delta_r Sphi_r and
  // sum_r delta_r (2 EQ_r + delta_r G[2+r, 2+r]), EQ_r as drawn
  F m1 = F(0), m2 = F(0);
  // EQ of the factors past the first panel waits in their V_new slots
  for (int q = NPL; q < n_slots; ++q) {
    const int s = 32 * q + lane;
    if (s < R) Vn[s] = eq_start(G1, Sphi, s, w0, dw, fit_linear);
  }

  for (int p0 = 0; p0 < R; p0 += PW) {
    const F* rows = Gb + (size_t)(2 + p0) * D + 2;  // row p0 of the block
    // row i of the panel lands in ring[i % (A + 1)], one commit group a
    // row (empty groups keep the count)
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (a < PW && p0 + a < R) {
        fetch_row<F, NPL>(ring[a], rows + (size_t)a * D, p0 + a, p0, R, lane,
                          a / 32);
      }
      cp_async_commit();
    }
    F eq[NPL], vo[NPL], lam[NPL], lm[NPL], nz[NPL], sph[NPL], vn[NPL];
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int s = p0 + 32 * k + lane;
      const bool ok = s < R;
      eq[k] = ok ? (p0 == 0 ? eq_start(G1, Sphi, s, w0, dw, fit_linear)
                            : Vn[s])
                 : F(0);
      vo[k] = ok ? Vo[s] : F(0);
      lam[k] = ok ? lamg[s] : F(0);
      lm[k] = ok ? lam[k] * mug[s] : F(0);
      nz[k] = ok ? nzb[s] : F(0);
      sph[k] = ok ? Sphi[s] : F(0);
      vn[k] = F(0);
    }
    const int q_past = (p0 + PW) / 32;  // first slot past the panel
    int slot = 0;   // ring slot of row t
    int refill = A; // ring slot of row t + A, the one row t - 1 left
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      // a loop: unrolled, the steps ran 2x slower (see The design)
#pragma unroll 1
      for (int j = 0; j < 32; ++j) {
        const int t = 32 * k + j;
        const int r = p0 + t;
        if (r >= R) break;
        // groups 0..t are done: row t is in (this lane copied its own part)
        cp_async_wait<A - 1>();
        F row[NPL];
#pragma unroll
        for (int k2 = 0; k2 < NPL; ++k2) {
          row[k2] = k2 >= k ? ring[slot][32 * k2 + lane] : F(0);
        }
        F delta = F(0);
        if (lane == j) {
          const F d = row[k];  // G[2+r, 2+r]
          const F quad = alpha * d + lam[k];
          const F lin = alpha * (d * vo[k] - eq[k]) + lm[k];
          const F v = lin / quad + nz[k] * rsqrt_(quad);
          vn[k] = v;
          delta = v - vo[k];
          m1 += delta * sph[k];
          m2 += delta * (F(2) * eq[k] + delta * d);
        }
        delta = __shfl_sync(0xffffffffu, delta, j);
#pragma unroll
        for (int k2 = k; k2 < NPL; ++k2) {
          if (k2 > k || lane > j) eq[k2] += delta * row[k2];
        }
        const F* grow = rows + (size_t)t * D;
        for (int q = q_past; q < n_slots; ++q) {
          const int s = 32 * q + lane;
          if (s < R) Vn[s] += delta * grow[s];
        }
        if (t + A < PW && r + A < R) {
          fetch_row<F, NPL>(ring[refill], rows + (size_t)(t + A) * D, r + A,
                            p0, R, lane, (t + A) / 32);
        }
        cp_async_commit();
        slot = slot == A ? 0 : slot + 1;
        refill = refill == A ? 0 : refill + 1;
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int s = p0 + 32 * k + lane;
      if (s < R) Vn[s] = vn[k];
    }
  }
  if (moments == nullptr) return;
  // the entity's post-draw (sum e, sum e^2): e = c . z over its rows with
  // c = [w0 + dw | 1 | delta], so sum e = c . G[0] and sum e^2 = c' G c;
  // the lanes' parts added in a fixed tree
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m1 += __shfl_xor_sync(0xffffffffu, m1, o);
    m2 += __shfl_xor_sync(0xffffffffu, m2, o);
  }
  if (lane == 0) {
    const F a = w0 + dw;
    moments[2 * (size_t)b] = (E1 + dw * card) + m1;
    moments[2 * (size_t)b + 1] =
        (Gb[D + 1] + a * (F(2) * Gb[1] + a * card)) + m2;
  }
}

template <typename F, int NPL>
cudaError_t launch(const void* G, const void* w0, const void* alpha,
                   const void* w_t, const void* V_t, const int64_t* g_t,
                   const void* lambda_w, const void* mu_w,
                   const void* lambda_V, const void* mu_V,
                   const void* noise_w, const void* noise_V, void* w_new,
                   void* V_new, void* moments, int B, int R, int fit_linear,
                   cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  entity_draws_kernel<F, NPL><<<blocks, kWarps * 32, 0, stream>>>(
      (const F*)G, (const F*)w0, (const F*)alpha, (const F*)w_t,
      (const F*)V_t, g_t, (const F*)lambda_w, (const F*)mu_w,
      (const F*)lambda_V, (const F*)mu_V, (const F*)noise_w,
      (const F*)noise_V, (F*)w_new, (F*)V_new, (F*)moments, B, R,
      fit_linear);
  return cudaGetLastError();
}

template <typename F>
cudaError_t launch_rank(const void* G, const void* w0, const void* alpha,
                        const void* w_t, const void* V_t, const int64_t* g_t,
                        const void* lambda_w, const void* mu_w,
                        const void* lambda_V, const void* mu_V,
                        const void* noise_w, const void* noise_V,
                        void* w_new, void* V_new, void* moments, int B, int R,
                        int fit_linear, cudaStream_t stream) {
  if (R <= 32) {
    return launch<F, 1>(G, w0, alpha, w_t, V_t, g_t, lambda_w, mu_w,
                        lambda_V, mu_V, noise_w, noise_V, w_new, V_new,
                        moments, B, R, fit_linear, stream);
  }
  if (R <= 64) {
    return launch<F, 2>(G, w0, alpha, w_t, V_t, g_t, lambda_w, mu_w,
                        lambda_V, mu_V, noise_w, noise_V, w_new, V_new,
                        moments, B, R, fit_linear, stream);
  }
  return launch<F, 4>(G, w0, alpha, w_t, V_t, g_t, lambda_w, mu_w, lambda_V,
                      mu_V, noise_w, noise_V, w_new, V_new, moments, B, R,
                      fit_linear, stream);
}

}  // namespace

extern "C" {

// Draws w_new [B] and V_new [B, R] for the B entities of G [B, R+2, R+2]
// (all contiguous; g_t int64 group ids into lambda_w / mu_w [n_groups] and
// lambda_V / mu_V [n_groups, R]; w0, alpha one value each) and, unless
// moments is null, each entity's post-draw (sum e, sum e^2) into moments
// [B, 2].  Returns 0 or the cudaError_t of the launch.
int myfm_entity_draws(int is_double, const void* G, const void* w0,
                      const void* alpha, const void* w_t, const void* V_t,
                      const int64_t* g_t, const void* lambda_w,
                      const void* mu_w, const void* lambda_V,
                      const void* mu_V, const void* noise_w,
                      const void* noise_V, void* w_new, void* V_new,
                      void* moments, int B, int R, int fit_linear,
                      void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double) {
    return launch_rank<double>(G, w0, alpha, w_t, V_t, g_t, lambda_w, mu_w,
                               lambda_V, mu_V, noise_w, noise_V, w_new,
                               V_new, moments, B, R, fit_linear, s);
  }
  return launch_rank<float>(G, w0, alpha, w_t, V_t, g_t, lambda_w, mu_w,
                            lambda_V, mu_V, noise_w, noise_V, w_new, V_new,
                            moments, B, R, fit_linear, s);
}

}  // extern "C"
