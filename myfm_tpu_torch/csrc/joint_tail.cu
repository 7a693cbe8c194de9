// The joint Gibbs sweep's sequential color tail, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel myfm_tpu/ops/pallas_joint_tail.py
// joint_tail_pass (_tail_kernel).  Python side:
// myfm_tpu_torch/ops/joint_tail.py, whose plain PyTorch version
// joint_tail_pass_reference (ops/joint.py _dense_color_apply, color
// after color) states the same arithmetic.
//
// What it computes.  A block of B block rows carries a Gram per row,
// G_b = sum z z^T over the block row's original rows, z = [1, e, q]
// (D = R + 2), plus Atot [B][R] and Ct [B].  For each of C colors, in
// order, with x = xw[c][b] and slot p = segb[c][b] (p == Pf: absent):
//   stats per slot    sum x^2 G, sum x^3 G[0,:], sum x^4 G[0,0], sum x G[1,:]
//   S, t              assembled with the v_old border terms
//   A = alpha S + diag(lam),  rhs = alpha (S u0 - t) + lam mu
//   L L^T = A         unrolled Cholesky, pivot j floored at
//                     max(8 eps |A_jj| + tiny, lam_j) in the kernel's own
//                     precision (FLT / DBL eps and min)
//   u_new = L^-T (L^-1 rhs + xi)
// and then, per block row of the color, with s = [a0, 0, A_B],
//   a0 = x dw - x^2 (v_old . dv),  A_B = x dv:
//   Ct += a0 + A_B . Atot;  Atot += A_B;  G <- T G T^T via
//   g = G s, p = g + g_0 s^ + (sgs / 2) e1, r = G[:,0] + (G_00 / 2) s^,
//   G += e1 p^T + p e1^T + s^ r^T + r s^T      (s^ = [0, 0, A_B]).
// Every slot is drawn, pad slots (features with no rows) included, from
// the same noise as the TPU kernel consumes; their rows are never touched.
//
// What bounds it.  The colors form one chain: each reads the G, Atot and
// Ct the previous one wrote.  Per color the work is small (a tail color
// holds <= Pf implicit columns touching tens to hundreds of block rows,
// ~1.1 KB of Gram each at D = 12 in fp64) and the Cholesky of each slot
// is a dependent sequence of ~Dp^3/6 multiply-adds.  So the kernel is
// bound by per-color latency — the Cholesky's dependent steps, the block
// barriers and the L2 round trips to G — not by bandwidth or FLOPs.
//
// The design.
// * One CTA loops over the C colors in order, so the carried state needs
//   no grid-wide sync and nothing is carried between blocks of a grid.
// * Only the rows a color touches are visited.  A row with segb == Pf has
//   xw = 0 at that color on the TPU, so s = [a0, 0, A_B] = 0, hence
//   g = p = 0 and a zero correction: its G, Atot and Ct are left exactly
//   as they are.  Skipping it is therefore exact.  The touched rows are
//   compacted per color (each thread counts a contiguous chunk of rows, a
//   block scan gives the offsets, so the list is in row order), then
//   grouped by slot (rows counted per slot with integer atomics, exact in
//   any order; one warp per slot that owns rows places them with ballots
//   over the list, stable), so every reduction runs in a fixed order: no
//   atomics on floats, the same bits on every run.
// * G does not fit in shared memory (0.5-1 MB at D = 12), so it stays in
//   device memory, resident in L2.  The wrapper hands the kernel a
//   row-major copy [B][D^2], so one touched row is D^2 contiguous values.
// * The draw runs one thread per feature slot, over the slot's statistics
//   and A (then L).  These per-slot arrays live in shared memory when all
//   Pf slots fit there (Pf = 8 at D = 12 takes ~13 KB), and otherwise in
//   a global workspace, where they stay L1/L2-resident; the two variants
//   are one template.  So any Pf and any D >= 3 runs: a tail that holds
//   one-hot id colours (Pf in the hundreds) or rank 32 (D = 34, ~7 KB a
//   slot in fp32) takes the workspace variant.  A slot without rows (a
//   pad slot: most slots of a tail padded to a one-hot colour's width)
//   gets no statistics, and its draw reduces to the diagonal A = diag(lam)
//   in O(Dp), with the values of the full factorization.
// * The update runs one warp per touched row: the row's G is read
//   (g, r), then written, inside the warp; a block barrier separates the
//   stats pass (which reads G) from the updates (which write it).
// Arithmetic is IEEE fp32 or fp64; no tensor cores.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// upper-triangle (i <= j) row-major index of a D x D symmetric matrix
__device__ __forceinline__ int tri_idx(int i, int j, int D) {
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  return i * D - (i * (i - 1)) / 2 + (j - i);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Shared memory every launch holds: per-warp update vectors [kWarps][4][D],
// the triangle index maps [2][n_tri], the scan's warp totals and count.
template <typename F>
__host__ __device__ size_t fixed_bytes(int D) {
  const size_t n_tri = (size_t)D * (D + 1) / 2;
  return align16((size_t)kWarps * 4 * D * sizeof(F) +
                 (2 * n_tri + kWarps + 2) * sizeof(int));
}

// Per-slot arrays: stats [Pf][n_stats], A/L [Pf][Dp*Dp], rhs/z/s [Pf][Dp],
// dw/dv/c0 [Pf][Dp+1], then the slot counts, starts and the list of the
// slots that own rows [3][Pf+1].
template <typename F>
__host__ __device__ size_t slot_bytes(int D, int Pf) {
  const size_t Dp = D - 1;
  const size_t n_stats = (size_t)D * (D + 1) / 2 + 2 * D + 1;
  return (size_t)Pf * (n_stats + Dp * Dp + 2 * Dp + 1) * sizeof(F) +
         3 * (size_t)(Pf + 1) * sizeof(int);
}

size_t rows_bytes(int B) { return align16(3 * (size_t)B * sizeof(int)); }

template <typename F, bool kSlotsInSmem>
__global__ void __launch_bounds__(kThreads)
joint_tail_kernel(F* __restrict__ G,            // [B][D*D]
                  F* __restrict__ At,           // [B][R]
                  F* __restrict__ Ct,           // [B]
                  const F* __restrict__ xw,     // [C][B]
                  const int* __restrict__ segb, // [C][B]
                  const F* __restrict__ u0,     // [C][Pf][Dp]
                  const F* __restrict__ lam,    // [C][Pf][Dp]
                  const F* __restrict__ mu,     // [C][Pf][Dp]
                  const F* __restrict__ xi,     // [C][Pf][Dp]
                  const F* __restrict__ alpha_p,
                  F* __restrict__ u_out,        // [C][Pf][Dp]
                  int* __restrict__ rows_buf,   // [3B] scratch
                  unsigned char* __restrict__ slot_ws,  // slot_bytes, unless
                                                        // kSlotsInSmem
                  int C, int B, int Pf, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = D - 2;
  const int Dp = D - 1;
  const int DD = D * D;
  const int n_tri = D * (D + 1) / 2;
  const int n_stats = n_tri + 2 * D + 1;
  F* wv = reinterpret_cast<F*>(smem_raw);                    // [kWarps][4][D]
  int* tri_i = reinterpret_cast<int*>(wv + kWarps * 4 * D);  // [n_tri]
  int* tri_j = tri_i + n_tri;                                // [n_tri]
  int* warp_tot = tri_j + n_tri;                             // [kWarps]
  int* n_touched = warp_tot + kWarps;  // [2]: touched rows, slots with rows
  unsigned char* slot_raw =
      kSlotsInSmem ? smem_raw + fixed_bytes<F>(D) : slot_ws;
  F* stats = reinterpret_cast<F*>(slot_raw);    // [Pf][n_stats]
  F* Am = stats + (size_t)Pf * n_stats;         // [Pf][Dp*Dp], A then L
  F* vec = Am + (size_t)Pf * Dp * Dp;           // [Pf][Dp]: rhs, z, s
  F* dlt = vec + (size_t)Pf * Dp;               // [Pf][Dp+1]: dw, dv, c0
  int* slot_cnt = reinterpret_cast<int*>(dlt + (size_t)Pf * (Dp + 1));
  int* slot_start = slot_cnt + Pf + 1;          // [Pf+1]
  int* live = slot_start + Pf + 1;              // [Pf+1]: slots with rows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const F eps8 = F(8) * Lim<F>::eps();
  const F tiny = Lim<F>::tiny();
  const F alpha = *alpha_p;

  for (int k = tid; k < n_tri; k += kThreads) {
    int i = 0, rem = k;
    while (rem >= D - i) {
      rem -= D - i;
      ++i;
    }
    tri_i[k] = i;
    tri_j[k] = i + rem;
  }
  int* touched = rows_buf;         // touched rows, row order
  int* tslot = rows_buf + B;       // the slot of each touched row
  int* grouped = rows_buf + 2 * B; // touched rows, grouped by slot
  const int chunk = (B + kThreads - 1) / kThreads;
  const int b0 = min(B, tid * chunk);
  const int b1 = min(B, b0 + chunk);

  for (int c = 0; c < C; ++c) {
    const F* xw_c = xw + (size_t)c * B;
    const int* sg_c = segb + (size_t)c * B;

    // -- touched rows, in row order (block exclusive scan of counts) --
    int cnt = 0;
    for (int b = b0; b < b1; ++b) {
      const int s = sg_c[b];
      cnt += (s >= 0 && s < Pf) ? 1 : 0;
    }
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int t = warp_tot[w];
        warp_tot[w] = acc;
        acc += t;
      }
      n_touched[0] = acc;
    }
    __syncthreads();
    int pos = warp_tot[warp] + incl - cnt;
    for (int b = b0; b < b1; ++b) {
      const int s = sg_c[b];
      if (s >= 0 && s < Pf) {
        touched[pos] = b;
        tslot[pos] = s;
        ++pos;
      }
    }
    __syncthreads();
    const int n = n_touched[0];

    // -- grouped by slot, row order inside each slot: rows counted per
    // slot (integer atomics: exact in any order), the slots that own rows
    // listed, then one warp per such slot places its rows 32 list entries
    // at a time --
    for (int p = tid; p < Pf; p += kThreads) slot_cnt[p] = 0;
    __syncthreads();
    for (int t = tid; t < n; t += kThreads) atomicAdd(&slot_cnt[tslot[t]], 1);
    __syncthreads();
    if (tid == 0) {
      int acc = 0, nl = 0;
      for (int p = 0; p < Pf; ++p) {
        const int k = slot_cnt[p];
        slot_start[p] = acc;
        acc += k;
        if (k > 0) live[nl++] = p;
      }
      slot_start[Pf] = acc;
      n_touched[1] = nl;
    }
    __syncthreads();
    const int n_live = n_touched[1];
    for (int l = warp; l < n_live; l += kWarps) {
      const int p = live[l];
      int k = slot_start[p];
      for (int t0 = 0; t0 < n; t0 += 32) {
        const int t = t0 + lane;
        const bool hit = t < n && tslot[t] == p;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) grouped[k + __popc(m & ((1u << lane) - 1u))] = touched[t];
        k += __popc(m);
      }
    }
    __syncthreads();

    // -- per-slot statistics of the slots that own rows, each summed in
    // row order --
    for (int w = tid; w < n_live * n_stats; w += kThreads) {
      const int l = w / n_stats;
      const int p = live[l];
      const int k = w - l * n_stats;
      int off, pw;  // Gram entry and power of x
      if (k < n_tri) {
        off = tri_i[k] * D + tri_j[k];
        pw = 2;
      } else if (k < n_tri + D) {
        off = k - n_tri;  // G[0, j]
        pw = 3;
      } else if (k == n_tri + D) {
        off = 0;
        pw = 4;
      } else {
        off = D + (k - n_tri - D - 1);  // G[1, j]
        pw = 1;
      }
      F acc = F(0);
#pragma unroll 4
      for (int t = slot_start[p]; t < slot_start[p + 1]; ++t) {
        const int b = grouped[t];
        const F x = xw_c[b];
        const F x2 = x * x;
        const F wgt = pw == 2 ? x2 : pw == 3 ? x2 * x : pw == 4 ? x2 * x2 : x;
        acc += wgt * G[(size_t)b * DD + off];
      }
      stats[(size_t)p * n_stats + k] = acc;
    }
    __syncthreads();

    // -- the draw, one thread per slot --
    for (int p = tid; p < Pf; p += kThreads) {
      const F* st = stats + (size_t)p * n_stats;
      const size_t row0 = ((size_t)c * Pf + p) * Dp;
      const F* up = u0 + row0;
      const F* lp = lam + row0;
      const F* mp = mu + row0;
      const F* xp = xi + row0;
      if (slot_cnt[p] == 0) {
        // a slot without rows (a pad slot): S = 0 and t = 0, so
        // A = diag(lam) and rhs = lam mu; every off-diagonal term of the
        // full path below is a signed zero, so these diagonal steps give
        // its values (up to the sign of a zero).  No row reads its deltas.
        F* out = u_out + row0;
        for (int j = 0; j < Dp; ++j) {
          const F ajj = alpha * F(0) + lp[j];
          const F floor_j = fmax(eps8 * fabs(ajj) + tiny, lp[j]);
          const F pivot = fmax(ajj, floor_j);
          const F ljj = pivot * rsqrt_(pivot);
          const F z = (alpha * F(0) + lp[j] * mp[j]) / ljj + xp[j];
          out[j] = z / ljj;
        }
        continue;
      }
      F* A = Am + (size_t)p * Dp * Dp;
      F* vv = vec + (size_t)p * Dp;
      const F s3c = st[n_tri];
      const F x4c = st[n_tri + D];
      const F g01 = st[tri_idx(0, 1, D)];
      // S(i, j) of the (R+1)-dim draw; v_old = up[1..R]
      auto S = [&](int i, int j) -> F {
        if (i > j) {
          const int t = i;
          i = j;
          j = t;
        }
        if (i == 0) {
          if (j == 0) return st[0];
          return st[tri_idx(0, j + 1, D)] - s3c * up[j];
        }
        const F vi = up[i];
        const F vj = up[j];
        return st[tri_idx(i + 1, j + 1, D)] - vi * st[n_tri + j + 1] -
               st[n_tri + i + 1] * vj + x4c * vi * vj;
      };
      for (int i = 0; i < Dp; ++i) {
        const F t_i = i == 0 ? st[n_tri + D + 1]
                             : st[n_tri + D + 1 + i + 1] - g01 * up[i];
        F acc = S(i, 0) * up[0];
        for (int j = 1; j < Dp; ++j) acc += S(i, j) * up[j];
        vv[i] = alpha * (acc - t_i) + lp[i] * mp[i];
        for (int j = 0; j < Dp; ++j) {
          A[i * Dp + j] = alpha * S(i, j) + (i == j ? lp[i] : F(0));
        }
      }
      // Cholesky in place: L[i][j] (i >= j) over A's lower triangle
      for (int j = 0; j < Dp; ++j) {
        const F ajj = A[j * Dp + j];
        for (int i = j; i < Dp; ++i) {
          F cij = A[i * Dp + j];
          for (int k = 0; k < j; ++k) cij -= A[i * Dp + k] * A[j * Dp + k];
          A[i * Dp + j] = cij;
        }
        const F floor_j = fmax(eps8 * fabs(ajj) + tiny, lp[j]);
        const F pivot = fmax(A[j * Dp + j], floor_j);
        const F inv_d = rsqrt_(pivot);
        A[j * Dp + j] = pivot * inv_d;
        for (int i = j + 1; i < Dp; ++i) A[i * Dp + j] *= inv_d;
      }
      for (int j = 0; j < Dp; ++j) {  // L z = rhs, then z + xi
        F acc = vv[j];
        for (int k = 0; k < j; ++k) acc -= A[j * Dp + k] * vv[k];
        vv[j] = acc / A[j * Dp + j];
      }
      for (int j = 0; j < Dp; ++j) vv[j] += xp[j];
      for (int j = Dp - 1; j >= 0; --j) {  // L^T s = z + xi
        F acc = vv[j];
        for (int k = j + 1; k < Dp; ++k) acc -= A[k * Dp + j] * vv[k];
        vv[j] = acc / A[j * Dp + j];
      }
      F* out = u_out + row0;
      F* dl = dlt + (size_t)p * (Dp + 1);
      F c0 = F(0);
      for (int i = 0; i < Dp; ++i) {
        out[i] = vv[i];
        const F d = vv[i] - up[i];
        dl[i] = d;
        if (i >= 1) c0 = (i == 1) ? up[i] * d : c0 + up[i] * d;
      }
      dl[Dp] = c0;
    }
    __syncthreads();

    // -- Ct, Atot and G <- T G T^T, one warp per touched row --
    F* sv = wv + (size_t)warp * 4 * D;
    F* gv = sv + D;
    F* pv = gv + D;
    F* rv = pv + D;
    for (int t = warp; t < n; t += kWarps) {
      const int b = grouped[t];
      const int p = sg_c[b];
      const F x = xw_c[b];
      const F* dl = dlt + (size_t)p * (Dp + 1);
      const F a0 = x * dl[0] - x * x * dl[Dp];
      for (int i = lane; i < D; i += 32) {
        sv[i] = i == 0 ? a0 : i == 1 ? F(0) : dl[i - 1] * x;
      }
      __syncwarp();
      F* Gr = G + (size_t)b * DD;
      for (int i = lane; i < D; i += 32) {
        F acc = F(0);
        for (int j = 0; j < D; ++j) acc += Gr[i * D + j] * sv[j];
        gv[i] = acc;
      }
      __syncwarp();
      F sgs = F(0);
      for (int i = 0; i < D; ++i) sgs += sv[i] * gv[i];
      const F g0 = gv[0];
      const F G00 = Gr[0];
      for (int i = lane; i < D; i += 32) {
        const F shi = i >= 2 ? sv[i] : F(0);
        F pi = gv[i] + g0 * shi;
        if (i == 1) pi += F(0.5) * sgs;
        pv[i] = pi;
        rv[i] = Gr[i * D] + F(0.5) * G00 * shi;
      }
      F* Ab = At + (size_t)b * R;
      if (lane == 0) {
        F acc = F(0);
        for (int r = 0; r < R; ++r) acc += sv[2 + r] * Ab[r];
        Ct[b] = Ct[b] + a0 + acc;
      }
      __syncwarp();
      for (int r = lane; r < R; r += 32) Ab[r] += sv[2 + r];
      for (int k = lane; k < DD; k += 32) {
        const int i = k / D;
        const int j = k - i * D;
        const F shi = i >= 2 ? sv[i] : F(0);
        const F shj = j >= 2 ? sv[j] : F(0);
        const F corr = (i == 1 ? pv[j] : F(0)) + (j == 1 ? pv[i] : F(0)) +
                       shi * rv[j] + rv[i] * shj;
        Gr[k] += corr;
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// Whether the Pf slots' arrays fit in the block's opt-in shared memory.
template <typename F>
cudaError_t slots_in_smem(int D, int Pf, bool* fits) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  *fits = fixed_bytes<F>(D) + slot_bytes<F>(D, Pf) <= (size_t)limit;
  return err;
}

template <typename F>
long long workspace_bytes(int B, int Pf, int D) {
  if (B < 1 || Pf < 1 || D < 3) return -(long long)cudaErrorInvalidValue;
  bool fits = false;
  const cudaError_t err = slots_in_smem<F>(D, Pf, &fits);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)(rows_bytes(B) + (fits ? 0 : slot_bytes<F>(D, Pf)));
}

template <typename F, bool kSlotsInSmem>
int run(size_t smem, void* G, void* At, void* Ct, const void* xw,
        const int* segb, const void* u0, const void* lam, const void* mu,
        const void* xi, const void* alpha, void* u_out, int* rows,
        unsigned char* slot_ws, int C, int B, int Pf, int D, void* stream) {
  // a block whose fixed part alone overflows shared memory fails here
  cudaError_t err = cudaFuncSetAttribute(
      joint_tail_kernel<F, kSlotsInSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  joint_tail_kernel<F, kSlotsInSmem>
      <<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<F*>(G), static_cast<F*>(At), static_cast<F*>(Ct),
          static_cast<const F*>(xw), segb, static_cast<const F*>(u0),
          static_cast<const F*>(lam), static_cast<const F*>(mu),
          static_cast<const F*>(xi), static_cast<const F*>(alpha),
          static_cast<F*>(u_out), rows, slot_ws, C, B, Pf, D);
  return (int)cudaGetLastError();
}

template <typename F>
int launch(void* G, void* At, void* Ct, const void* xw, const int* segb,
           const void* u0, const void* lam, const void* mu, const void* xi,
           const void* alpha, void* u_out, void* ws, size_t ws_bytes, int C,
           int B, int Pf, int D, void* stream) {
  if (C < 0 || B < 1 || Pf < 1 || D < 3) return (int)cudaErrorInvalidValue;
  bool fits = false;
  const cudaError_t err = slots_in_smem<F>(D, Pf, &fits);
  if (err != cudaSuccess) return (int)err;
  if (ws_bytes < rows_bytes(B) + (fits ? 0 : slot_bytes<F>(D, Pf))) {
    return (int)cudaErrorInvalidValue;
  }
  if (C == 0) return 0;
  int* rows = static_cast<int*>(ws);
  unsigned char* slot_ws = static_cast<unsigned char*>(ws) + rows_bytes(B);
  if (fits) {
    return run<F, true>(fixed_bytes<F>(D) + slot_bytes<F>(D, Pf), G, At, Ct,
                        xw, segb, u0, lam, mu, xi, alpha, u_out, rows,
                        nullptr, C, B, Pf, D, stream);
  }
  return run<F, false>(fixed_bytes<F>(D), G, At, Ct, xw, segb, u0, lam, mu,
                       xi, alpha, u_out, rows, slot_ws, C, B, Pf, D, stream);
}

}  // namespace

extern "C" {

// Bytes of device workspace myfm_joint_tail needs at these dims (on the
// current device), or minus the cudaError_t.
long long myfm_joint_tail_workspace(int is_double, int B, int Pf, int D) {
  return is_double ? workspace_bytes<double>(B, Pf, D)
                   : workspace_bytes<float>(B, Pf, D);
}

// Runs every color of the tail in one launch, in place on G ([B][D*D]),
// At ([B][R]) and Ct ([B]); writes u_out.  ws: at least
// myfm_joint_tail_workspace bytes of device scratch.  Returns 0 or the
// cudaError_t of the failed launch.
int myfm_joint_tail(int is_double, void* G, void* At, void* Ct,
                    const void* xw, const void* segb, const void* u0,
                    const void* lam, const void* mu, const void* xi,
                    const void* alpha, void* u_out, void* ws,
                    size_t ws_bytes, int C, int B, int Pf, int D,
                    void* stream) {
  const int* sg = static_cast<const int*>(segb);
  if (is_double) {
    return launch<double>(G, At, Ct, xw, sg, u0, lam, mu, xi, alpha, u_out,
                          ws, ws_bytes, C, B, Pf, D, stream);
  }
  return launch<float>(G, At, Ct, xw, sg, u0, lam, mu, xi, alpha, u_out, ws,
                       ws_bytes, C, B, Pf, D, stream);
}

}  // extern "C"
