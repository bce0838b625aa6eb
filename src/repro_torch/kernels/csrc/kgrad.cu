// The Eq. 2 backward's kernel (B5) for NVIDIA Hopper (sm_90a): the gradient
// in the kernel's hyperparameters of the quadratic form
//   q = sum_ij W_ij k(d2_ij),   W = A V^T,   k = sum_c w_c prod_f phi_cf(q_cf d2)
// over one fused pass (X pre-scaled by the pass's lengthscale, the scalars in
// `kmvm.scalar_layout` order), in one walk over the (n, n) tiles as B1 walks
// them. Neither the slab, nor W, nor dK/dtheta reaches device memory.
//
// Replaces no TPU kernel: the reference differentiates the same contraction
// with XLA's autodiff over row slabs (src/repro/core/partitioned.py:207,
// `quad_form_partials`) and has no Pallas kernel for it. The port ran it as
// eager torch autograd over (512, n) slabs (about ten elementwise passes
// through device memory a slab, and an fp32 GEMM for K @ V), 400 times its
// counted least time. That loop stays for what B5 does not compute: ARD,
// linear and fallback terms, specs past its classes (below), d > 16, and
// gradients in X.
//
// What it computes. One fp64 sum per scalar slot, with u = q_cf d2, psi =
// u phi'(u) and "others" the product of the component's other factors:
//   slot w_c       sum W T_c                       T_c = prod_f phi_cf
//   slot q_cf      sum W psi_cf others
//   slot alpha_cf  sum W (d phi_cf / d alpha) others       (rq factors)
// kgrad_reduce turns them into the outputs [S0, S1, dq/ds_0 .. dq/ds_L-1]:
// S0 = sum W k = sum_c w_c R_wc (the gradient in the pass's base weight),
// S1 = sum W d2 dk/dd2 = sum_cf w_c R_qcf (d2 = |x_i - x_j|^2 / l^2, so the
// gradient in the reference lengthscale is -(2 / l) S1), dq/dw_c = R_wc,
// dq/dq_cf = w_c R_qcf / q_cf, dq/dalpha_cf = w_c R_alpha_cf. psi has a
// closed form for each kind that reuses the value's exp and sqrt and divides
// nothing (rq aside), and it vanishes with u, so a diagonal entry (d2 ~ 0)
// gives no 0/0.
//
// What bounds it. Per entry: the cross term (2d operations), the weight W
// (2t), the value epilogue of B1 and the derivative's few operations and
// FMAs, over n^2 entries; the bytes, O(n (d + t)), are negligible. As in B1
// the epilogue's issue and latency bound it, so both products go to the
// tensor cores and the entry loop keeps nothing else.
//
// Design (B1's tile body, kmvm.cu, with a second product). A block of four
// warps owns a 64-row tile; warp w owns rows 16w..16w+15 against all 64
// columns of each column chunk, in groups of two n8 tiles (8 entries a
// thread). A column split over gridDim.y fills the 132 SMs.
// - The cross term G = X_i X_j^T is B1's 3xTF32 m16n8k8 `mma.sync` (d <= 16
//   features in one stage of 12 or 16, zero-padded: d = 9 is a k8 and a k4
//   step), the squared norms from the same fragment loads.
// - The weight tile W = A_i V_j^T is a second 3xTF32 product over the t
//   columns of A and V, staged as the features are (12 columns a pass,
//   zero-padded; t = 9 is a k8 and a k4 step; a larger t walks the columns
//   again per 12, W being linear in them). Its C fragments line up
//   with G's, so each entry meets its weight in registers. Padded rows,
//   columns and features are zero in shared memory, so their W is 0 and no
//   entry needs a mask.
// - The rows and the columns are the same points, so a point against
//   itself gets d2 = 0 exactly: the norm expansion leaves ~1e-7 |x|^2
//   there, which matern12's sqrt turns into ~3e-4 of phi (B1 keeps it; the
//   gradient of the exact kernel does not).
// - Accumulation: each thread sums a chunk's 32 entries per slot in fp32
//   registers from zero, then adds that to its running sum in fp64 (shared
//   memory, one add per slot a chunk). The tensor cores truncate what they
//   add into a large accumulator (B1's lesson), and an fp32 running sum over
//   a 2^16-column walk would lose the gradient's last digits.
// - Reduction: each block sums its threads' running sums by a fixed tree and
//   writes one row of a (blocks, L) fp64 buffer; kgrad_reduce sums that in a
//   fixed order. No atomics: every run gives the same bits.
// - Spec classes: the slots live in registers indexed by (component,
//   factor), so the kernel is compiled for at most (1, 1) or (2, 2)
//   components and factors (he-train's matern32 is (1, 1): three slot
//   registers). A (4, 4) class took ptxas five minutes and spilled; a larger
//   spec keeps the autograd loop. Four instances in all, so nvcc stays under
//   B1's build time.
// The full square is walked; the triangle (K symmetric) would halve the
// epilogue at the price of a k = 2t weight product and a diagonal case.

#include "kmvm_common.cuh"

namespace {

constexpr int KG_THREADS = 128;  // four warps of 16 rows
constexpr int KG_BLOCKS = 4;     // blocks per SM the kernel is compiled for
constexpr int KG_RED = 256;      // threads of kgrad_reduce
constexpr int TK = 12;           // columns of A and V a pass: a k8 and a k4 step
constexpr int KG_MAX_SLOTS = 2 * (1 + 2 * 2);  // slots of the (2, 2) class

// A chunk's partial sums: per component its w slot, per factor its q and
// alpha slots (fp32, from zero each chunk)
template <int MC, int MF>
struct Slots {
  float w[MC];
  float q[MC][MF];
  float a[MC][MF];
};

// phi, psi = u phi'(u) (u = q d2) and d phi / d alpha (rq) of one factor
// over N entries; `kind` is block-uniform. phi is B1's expression.
template <int N>
__device__ __forceinline__ void factor_grad(int kind, float q, float sq, float al,
                                            const float (&d2)[N], const float (&r)[N],
                                            float (&phi)[N], float (&psi)[N],
                                            float (&dal)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) dal[e] = 0.0f;
  switch (kind) {
    case RBF:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float u = q * d2[e];
        phi[e] = expf(-0.5f * u);
        psi[e] = -0.5f * u * phi[e];
      }
      break;
    case RQ:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float u = q * d2[e];
        const float z = u / (2.0f * al);
        const float l = log1pf(z);
        const float iz = 1.0f / (1.0f + z);
        phi[e] = expf(-al * l);
        psi[e] = -0.5f * u * phi[e] * iz;
        dal[e] = phi[e] * (z * iz - l);
      }
      break;
    case MATERN12:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float rr = sq * r[e];
        phi[e] = expf(-rr);
        psi[e] = -0.5f * rr * phi[e];
      }
      break;
    case MATERN32:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float a = 1.7320508075688772f * (sq * r[e]);
        const float ea = expf(-a);
        phi[e] = (1.0f + a) * ea;
        psi[e] = -0.5f * (a * a) * ea;
      }
      break;
    case MATERN52:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float a = 2.23606797749979f * (sq * r[e]);
        const float ea = expf(-a);
        phi[e] = (1.0f + a + (a * a) / 3.0f) * ea;
        psi[e] = -((a * a) / 6.0f) * (1.0f + a) * ea;
      }
      break;
    case WENDLAND2:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float rr = sq * r[e];
        const float b = fmaxf(1.0f - rr, 0.0f);
        const float b2 = b * b;
        phi[e] = b2 * b2 * (4.0f * rr + 1.0f);
        psi[e] = -10.0f * (rr * rr) * (b2 * b);
      }
      break;
    case WENDLAND4:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float rr = sq * r[e];
        const float b = fmaxf(1.0f - rr, 0.0f);
        const float b2 = b * b;
        const float b3 = b2 * b;
        phi[e] = b3 * b3 * ((35.0f * rr * rr + 18.0f * rr + 3.0f) / 3.0f);
        psi[e] = -(28.0f / 3.0f) * (rr * rr) * (b3 * b2) * (5.0f * rr + 1.0f);
      }
      break;
  }
}

// N entries with squared distances d2 and weights wv into the chunk's
// partials: per component, wv T_c; per factor, wv psi others (and wv
// dphi/dalpha others for rq), others by prefix and suffix products.
template <int MC, int MF, int N>
__device__ __forceinline__ void grad_epilogue(const Spec& s, const float (&d2)[N],
                                              const float (&wv)[N],
                                              Slots<MC, MF>& acc) {
  float r[N];
#pragma unroll
  for (int e = 0; e < N; ++e) r[e] = s.need_r ? sqrtf(d2[e]) : 0.0f;
#pragma unroll
  for (int c = 0; c < MC; ++c) {
    if (c < s.ncomp) {
      const int f0 = c == 0 ? 0 : s.fend[c - 1];
      const int nf = s.fend[c] - f0;
      float phi[MF][N], psi[MF][N], dal[MF][N];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        if (i < nf) {
          const int f = f0 + i;
          factor_grad<N>(s.kind[f], s.q[f], s.sq[f], s.alpha[f], d2, r, phi[i],
                         psi[i], dal[i]);
        } else {
#pragma unroll
          for (int e = 0; e < N; ++e) phi[i][e] = 1.0f, psi[i][e] = dal[i][e] = 0.0f;
        }
      }
      // ex[i] = wv prod_{g < i} phi_g, then times prod_{g > i} phi_g; pre
      // ends as wv T_c
      float ex[MF][N], pre[N];
#pragma unroll
      for (int e = 0; e < N; ++e) pre[e] = wv[e];
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int e = 0; e < N; ++e) {
          ex[i][e] = pre[e];
          pre[e] *= phi[i][e];
        }
      if constexpr (MF > 1) {
        float suf[N];
#pragma unroll
        for (int e = 0; e < N; ++e) suf[e] = 1.0f;
#pragma unroll
        for (int i = MF - 1; i >= 0; --i)
#pragma unroll
          for (int e = 0; e < N; ++e) {
            ex[i][e] *= suf[e];
            suf[e] *= phi[i][e];
          }
      }
#pragma unroll
      for (int e = 0; e < N; ++e) acc.w[c] += pre[e];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        if (i < nf) {
#pragma unroll
          for (int e = 0; e < N; ++e) acc.q[c][i] = fmaf(ex[i][e], psi[i][e], acc.q[c][i]);
          if (s.kind[f0 + i] == RQ) {
#pragma unroll
            for (int e = 0; e < N; ++e) acc.a[c][i] = fmaf(ex[i][e], dal[i][e], acc.a[c][i]);
          }
        }
      }
    }
  }
}

// The split A fragments of rows r0, r1 (m16n8k8: k slots tig, tig + 4) of a
// transposed tile x [k][row] over KS k8 steps and a k4 step (K4), and the
// rows' squared-norm partials over this lane's k slots.
template <int KS, bool K4>
__device__ __forceinline__ void row_frags(const float* x, int r0, int r1, int tig,
                                          unsigned (&h)[KS > 0 ? KS : 1][4],
                                          unsigned (&l)[KS > 0 ? KS : 1][4],
                                          unsigned (&h4)[2], unsigned (&l4)[2],
                                          float (&pn)[2]) {
  pn[0] = pn[1] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const float* xk = x + (8 * ks + tig) * LDT;
    const float a[4] = {xk[r0], xk[r1], xk[4 * LDT + r0], xk[4 * LDT + r1]};
    pn[0] = fmaf(a[2], a[2], fmaf(a[0], a[0], pn[0]));
    pn[1] = fmaf(a[3], a[3], fmaf(a[1], a[1], pn[1]));
#pragma unroll
    for (int e = 0; e < 4; ++e) split<true>(a[e], h[ks][e], l[ks][e]);
  }
  if constexpr (K4) {
    const float* xk = x + (8 * KS + tig) * LDT;
    const float a[2] = {xk[r0], xk[r1]};
    pn[0] = fmaf(a[0], a[0], pn[0]);
    pn[1] = fmaf(a[1], a[1], pn[1]);
    split<true>(a[0], h4[0], l4[0]);
    split<true>(a[1], h4[1], l4[1]);
  }
}

// c += the rows' fragments times n8 tile nn of a transposed tile y [k][col]
// (B fragments of column 8 nn + gid), 3xTF32; pc += that column's
// squared-norm partials.
template <int KS, bool K4>
__device__ __forceinline__ void tile_product(const float* y, int nn, int gid, int tig,
                                             const unsigned (&h)[KS > 0 ? KS : 1][4],
                                             const unsigned (&l)[KS > 0 ? KS : 1][4],
                                             const unsigned (&h4)[2],
                                             const unsigned (&l4)[2], float (&c)[4],
                                             float& pc) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const float* yk = y + (8 * ks + tig) * LDT + 8 * nn + gid;
    const float b0 = yk[0], b1 = yk[4 * LDT];
    pc = fmaf(b1, b1, fmaf(b0, b0, pc));
    mma_step<true>(c, h[ks], l[ks], b0, b1);
  }
  if constexpr (K4) {
    const float b = y[(8 * KS + tig) * LDT + 8 * nn + gid];
    pc = fmaf(b, b, pc);
    mma_step_k4<true>(c, h4, l4, b);
  }
}

// The scalar_layout slot of component c's weight (i < 0), of its factor i's
// q, or of that factor's alpha (alpha); -1 where the spec has none.
__device__ __forceinline__ int layout_slot(const KSpec& sp, int c, int i, bool alpha) {
  int slot = 0;
#pragma unroll
  for (int cc = 0; cc < MAX_COMP; ++cc) {
    if (cc < sp.ncomp) {
      if (cc == c && i < 0) return alpha ? -1 : slot;
      ++slot;
#pragma unroll
      for (int ff = 0; ff < MAX_FAC; ++ff) {
        if (ff < sp.nfac[cc]) {
          const bool rq = sp.kind[cc][ff] == RQ;
          if (cc == c && ff == i) return alpha ? (rq ? slot + 1 : -1) : slot;
          slot += rq ? 2 : 1;
        }
      }
    }
  }
  return -1;
}

template <int DK, int MC, int MF>
constexpr size_t kg_smem_bytes() {
  return 3 * (DK + TK) * LDT * sizeof(float) +
         MC * (1 + 2 * MF) * KG_THREADS * sizeof(double) + sizeof(Spec);
}

// One block: the fp64 slot sums of rows [i0, i0 + 64) against the column
// tiles of split blockIdx.y, into part row blockIdx.y * gridDim.x +
// blockIdx.x (L slots in scalar_layout order). X (n, d) pre-scaled, A and V
// (n, t) row-major fp32.
template <int DK, int MC, int MF>
__global__ void __launch_bounds__(KG_THREADS, KG_BLOCKS)
kgrad_kernel(const float* __restrict__ X, const float* __restrict__ A,
             const float* __restrict__ V, const float* __restrict__ scal,
             const KSpec sp, double* __restrict__ part, int n, int d, int t,
             int L, int tiles_per_split) {
  static_assert(DK % 4 == 0 && DK <= 16, "one feature stage of k8 and k4 steps");
  constexpr int KS = DK / 8, TS = TK / 8;
  constexpr bool K4 = DK % 8 == 4, T4 = TK % 8 == 4;
  constexpr int NS = MC * (1 + 2 * MF);  // slots in registers
  constexpr int XT = DK * LDT, WT = TK * LDT;

  extern __shared__ __align__(16) float smem[];
  float* xi_s = smem;            // [DK][LDT] the block's rows, staged once
  float* a_s = xi_s + XT;        // [TK][LDT] their A columns, per column pass
  float* xj_s = a_s + WT;        // [2][DK][LDT]
  float* v_s = xj_s + 2 * XT;    // [2][TK][LDT]
  double* run = reinterpret_cast<double*>(v_s + 2 * WT);  // [NS][KG_THREADS]
  Spec* spec = reinterpret_cast<Spec*>(run + NS * KG_THREADS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 16 * warp + gid, r1 = r0 + 8;  // this thread's rows
  const int i0 = blockIdx.x * BM;
  const int ntiles = (n + BN - 1) / BN;
  const int jb = min(ntiles, (int)blockIdx.y * tiles_per_split);
  const int nch = min(ntiles, jb + tiles_per_split) - jb;
  const int kw = min(DK, d);

  if (tid == 0) resolve_spec(sp, scal, spec);
  // features [d, DK) are never staged: zero them once in every buffer
  for (int e = tid; e < (DK - kw) * BM; e += KG_THREADS) {
    const int o = (kw + e / BM) * LDT + e % BM;
    xi_s[o] = xj_s[o] = xj_s[XT + o] = 0.0f;
  }
  for (int e = tid; e < NS * KG_THREADS; e += KG_THREADS) run[e] = 0.0;
  stage_features<LDT, KG_THREADS>(xi_s, X, i0, n, 0, kw, d, tid);

  for (int c0 = 0; c0 < t; c0 += TK) {
    const int tw = min(TK, t - c0);
    __syncthreads();  // every thread is done with the last pass's a_s, v_s
    for (int e = tid; e < (TK - tw) * BM; e += KG_THREADS) {
      const int o = (tw + e / BM) * LDT + e % BM;
      a_s[o] = v_s[o] = v_s[WT + o] = 0.0f;
    }
    stage_features<LDT, KG_THREADS>(a_s, A, i0, n, c0, tw, t, tid);
    // chunk s: features and V rows of column tile jb + s into buffer s & 1
    auto issue = [&](int s) {
      const int j0 = (jb + s) * BN;
      stage_features<LDT, KG_THREADS>(xj_s + (s & 1) * XT, X, j0, n, 0, kw, d, tid);
      stage_features<LDT, KG_THREADS>(v_s + (s & 1) * WT, V, j0, n, c0, tw, t, tid);
      cp_async_commit();
    };
    if (nch > 0) issue(0);

    unsigned xh[KS > 0 ? KS : 1][4], xl[KS > 0 ? KS : 1][4], x4h[2], x4l[2];
    unsigned ah[TS > 0 ? TS : 1][4], al[TS > 0 ? TS : 1][4], a4h[2], a4l[2];
    float ni[2];
    for (int s = 0; s < nch; ++s) {
      cp_async_wait_all();
      __syncthreads();  // chunk s is visible; every thread is past chunk s - 1
      if (s + 1 < nch) issue(s + 1);
      if (s == 0) {  // the rows' fragments and norms, once a column pass
        float pn[2], pa[2];
        row_frags<KS, K4>(xi_s, r0, r1, tig, xh, xl, x4h, x4l, pn);
        row_frags<TS, T4>(a_s, r0, r1, tig, ah, al, a4h, a4l, pa);
        ni[0] = sum4(pn[0]);
        ni[1] = sum4(pn[1]);
      }
      const float* xj = xj_s + (s & 1) * XT;
      const float* vj = v_s + (s & 1) * WT;
      const bool diag = jb + s == (int)blockIdx.x;  // the chunk holds the rows' own points
      Slots<MC, MF> acc = {};
#pragma unroll
      for (int h = 0; h < 8; h += 2) {  // n8 tiles h, h + 1: 8 entries a thread
        float g[2][4] = {}, w[2][4] = {}, pc[2] = {0.0f, 0.0f}, pw = 0.0f;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          tile_product<KS, K4>(xj, h + p, gid, tig, xh, xl, x4h, x4l, g[p], pc[p]);
          tile_product<TS, T4>(vj, h + p, gid, tig, ah, al, a4h, a4l, w[p], pw);
        }
        float d2[8], wv[8];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          // the norms of this thread's columns 8 (h + p) + 2 tig and + 1
          const float nj = sum4(pc[p]);
          const float nje = __shfl_sync(0xffffffffu, nj, 8 * tig);
          const float njo = __shfl_sync(0xffffffffu, nj, 8 * tig + 4);
          d2[4 * p + 0] = fmaxf(ni[0] + nje - 2.0f * g[p][0], 0.0f);
          d2[4 * p + 1] = fmaxf(ni[0] + njo - 2.0f * g[p][1], 0.0f);
          d2[4 * p + 2] = fmaxf(ni[1] + nje - 2.0f * g[p][2], 0.0f);
          d2[4 * p + 3] = fmaxf(ni[1] + njo - 2.0f * g[p][3], 0.0f);
          if (diag) {  // a point against itself: d2 = 0 exactly
            const int c = 8 * (h + p) + 2 * tig;
            if (r0 == c) d2[4 * p + 0] = 0.0f;
            if (r0 == c + 1) d2[4 * p + 1] = 0.0f;
            if (r1 == c) d2[4 * p + 2] = 0.0f;
            if (r1 == c + 1) d2[4 * p + 3] = 0.0f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) wv[4 * p + e] = w[p][e];
        }
        grad_epilogue<MC, MF, 8>(*spec, d2, wv, acc);
      }
      // the chunk's partials into the running sums, in fp64
#pragma unroll
      for (int c = 0; c < MC; ++c) {
        double* rc = run + c * (1 + 2 * MF) * KG_THREADS + tid;
        rc[0] += (double)acc.w[c];
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          rc[(1 + i) * KG_THREADS] += (double)acc.q[c][i];
          rc[(1 + MF + i) * KG_THREADS] += (double)acc.a[c][i];
        }
      }
    }
  }
  cp_async_wait_all();  // nothing in flight (the row tile when nch = 0)
  __syncthreads();

  // the block's sums, slot by slot (warp w takes slots w, w + 4, ...): each
  // lane adds four threads' sums in thread order, then a fixed shuffle tree
  double* out = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * L;
  for (int k = warp; k < NS; k += KG_THREADS / 32) {
    const double* rk = run + k * KG_THREADS;
    double v = rk[lane] + rk[lane + 32] + rk[lane + 64] + rk[lane + 96];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int c = k / (1 + 2 * MF), j = k % (1 + 2 * MF);
    const int slot = j == 0 ? layout_slot(sp, c, -1, false)
                            : layout_slot(sp, c, (j - 1) % MF, j > MF);
    if (lane == 0 && slot >= 0) out[slot] = v;
  }
}

// out (2 + L) fp32 = [S0, S1, dq/ds_0 .. dq/ds_L-1] from the blocks' rows of
// part (nblk, L) fp64, summed in block order per lane, then by a fixed tree.
__global__ void __launch_bounds__(KG_RED)
kgrad_reduce(const double* __restrict__ part, int nblk, int L,
             const float* __restrict__ scal, const KSpec sp,
             float* __restrict__ out) {
  __shared__ double red[KG_RED / 32];
  __shared__ double raw[KG_MAX_SLOTS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int k = 0; k < L; ++k) {
    double v = 0.0;
    for (int b = tid; b < nblk; b += KG_RED) v += part[(size_t)b * L + k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (tid == 0) {
      double s = red[0];
      for (int w = 1; w < KG_RED / 32; ++w) s += red[w];
      raw[k] = s;
    }
    __syncthreads();
  }
  if (tid == 0) {
    double s0 = 0.0, s1 = 0.0;
    int slot = 0;
#pragma unroll
    for (int c = 0; c < MAX_COMP; ++c) {
      if (c < sp.ncomp) {
        const double w = scal[slot];
        s0 += w * raw[slot];
        out[2 + slot] = (float)raw[slot];
        ++slot;
#pragma unroll
        for (int f = 0; f < MAX_FAC; ++f) {
          if (f < sp.nfac[c]) {
            const double q = scal[slot];
            s1 += w * raw[slot];
            out[2 + slot] = (float)(w * raw[slot] / q);
            ++slot;
            if (sp.kind[c][f] == RQ) {
              out[2 + slot] = (float)(w * raw[slot]);
              ++slot;
            }
          }
        }
      }
    }
    out[0] = (float)s0;
    out[1] = (float)s1;
  }
}

template <int DK, int MC, int MF>
int launch_kgrad(const float* X, const float* A, const float* V, const float* scal,
                 const KSpec& sp, double* part, int n, int d, int t, int L,
                 int nsplit, int tiles_per_split, cudaStream_t stream) {
  const size_t smem = kg_smem_bytes<DK, MC, MF>();
  cudaError_t err = cudaFuncSetAttribute(kgrad_kernel<DK, MC, MF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BM - 1) / BM, nsplit);
  kgrad_kernel<DK, MC, MF><<<grid, KG_THREADS, smem, stream>>>(
      X, A, V, scal, sp, part, n, d, t, L, tiles_per_split);
  return (int)cudaGetLastError();
}

// the feature stage of d: 12 or 16
template <int MC, int MF>
int dispatch_kgrad(const float* X, const float* A, const float* V, const float* scal,
                   const KSpec& sp, double* part, int n, int d, int t, int L,
                   int nsplit, int tiles_per_split, cudaStream_t s) {
  if (d <= 12)
    return launch_kgrad<12, MC, MF>(X, A, V, scal, sp, part, n, d, t, L, nsplit,
                                    tiles_per_split, s);
  return launch_kgrad<16, MC, MF>(X, A, V, scal, sp, part, n, d, t, L, nsplit,
                                  tiles_per_split, s);
}

}  // namespace

extern "C" {

// X (n, d) pre-scaled, A and V (n, t), scal (L): fp32 device pointers; spec
// as kmvm_fwd's, at most 2 components of at most 2 factors; part: (nsplit *
// ceil(n / 64), L) fp64 scratch; out: (2 + L) fp32. d <= 16; any n, t >= 1.
// Launches kgrad_kernel and kgrad_reduce on `stream`; returns
// cudaGetLastError() (0 = launched).
int kgrad_fwd(const float* X, const float* A, const float* V, const float* scal,
              const int* spec, int L, double* part, float* out, int n, int d,
              int t, int nsplit, int tiles_per_split, void* stream) {
  const KSpec sp = unpack_spec(spec);
  int maxf = 0;
  for (int c = 0; c < sp.ncomp; ++c) maxf = sp.nfac[c] > maxf ? sp.nfac[c] : maxf;
  if (d < 1 || d > 16 || t < 1 || n < 1 || sp.ncomp > 2 || maxf > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = sp.ncomp == 1 && maxf == 1
      ? dispatch_kgrad<1, 1>(X, A, V, scal, sp, part, n, d, t, L, nsplit,
                             tiles_per_split, s)
      : dispatch_kgrad<2, 2>(X, A, V, scal, sp, part, n, d, t, L, nsplit,
                             tiles_per_split, s);
  if (err != 0) return err;
  kgrad_reduce<<<1, KG_RED, 0, s>>>(part, nsplit * ((n + BM - 1) / BM), L, scal,
                                    sp, out);
  return (int)cudaGetLastError();
}

const char* kgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
