// The pieces shared by the fused kernel-MVM kernels (kmvm.cu: B1, B2, B3),
// the block-sparse kernel (kmvm_sparse.cu: B4) and the Eq. 2 backward's
// kernel (kgrad.cu: B5), for NVIDIA Hopper (sm_90a): the spec resolved per
// block and the fp32 epilogue, the cp.async staging of features and RHS rows,
// B4's tile body `row_tile`, and the 3xTF32 `mma.sync` steps of B1-B3 and B5
// (at the end of the file). The
// counterpart of `_kernel_tile` (src/repro/kernels/kmvm.py:81) and of the
// same arithmetic in `_bs_kernel` (src/repro/sparse/kmvm_sparse.py:44):
//   d2 = max(|xi|^2 + |xj|^2 - 2 xi.xj, 0)             (fp32, norms from the
//                                                        operand-dtype values)
//   K  = sum_c w_c prod_f phi_cf(q_cf * d2)             (fp32 epilogue)
//   out[i, :] += K[i, j] * V[j, :]                      (fp32 accumulation)
//
// The epilogue is the same code in every kernel: the spec is resolved once
// per block (`resolve_spec`: the kinds, the factor counts, the scalars in
// `scalar_layout` order and sqrt(q_cf) go into shared memory), and
// `epilogue<N>` runs component -> factor -> N entries, so a factor's kind
// is branched on once per pass (a block-uniform branch), the N exp/sqrt
// chains are independent and interleave, and r = sqrt(d2) is taken once per
// entry when any factor needs it (r_cf = sqrt(q_cf) r in place of
// sqrt(q_cf d2): a change of rounding only). IEEE expf/sqrtf/log1pf.
//
// B4's body (`row_tile`, below; B1-B3 have their own tensor-core body in
// kmvm.cu). One thread block (256 threads) owns BM = 64 output rows and
// walks the active BN = 64-column chunks of its row's sparsity pattern in an
// in-block loop, so the output tile stays in registers for the whole
// reduction and the kernel slab never reaches device memory. Each thread
// owns a 4x4 micro-tile of the 64x64 chunk (rows 4 ty + p, columns 4 tx + q).
//
// What bounds it. Per entry the work is the cross term (2d operations), the
// epilogue (an exp, and a sqrt for the Matern and Wendland kinds, per
// factor) and K @ V (2t), on fp32 CUDA cores; the bytes are negligible. The
// cost is instruction issue and latency, so the design keeps every
// instruction that is not arithmetic out of the entry loop:
//
// - Features and RHS rows are double-buffered in shared memory with
//   cp.async (fp32 operands; bf16 operands are staged by plain loads): the
//   next chunk's loads are in flight while the current chunk runs. The
//   tiles are stored transposed ([feature][row], 16-byte rows) so a thread
//   reads its 4 rows and its 4 columns of one feature with two 16-byte
//   loads, and each thread sums the norms of its own rows and columns in
//   the same loop (no norm pass, no barrier for it). The feature loop is
//   unrolled to DK = 16, or DK = 4 for d <= 4 (a template parameter), and
//   predicated at d.
// - At t = 1 (CG, Lanczos) K @ V stays in registers: each thread folds its
//   micro-tile into 4 row sums, and the 16 threads of a row group combine
//   them once, at the end of the walk, by a fixed shuffle tree. One barrier
//   per chunk. At t > 1 the K tile goes through shared memory to the
//   t-chunk layout (TCH = 16 or 128 output columns per pass), where each
//   thread owns its outputs and folds the columns in ascending order: two
//   barriers per chunk.
// - Occupancy: the t = 1 instances are held to 80 registers for three
//   blocks (24 warps) per SM and evaluate the epilogue in two passes of 8
//   entries, each folded into K @ V at once; at t > 1, two blocks with
//   16-entry passes.
//
// Ragged rows, columns and d are masked in the kernel; nothing is padded in
// device memory. Operands are fp32 or bf16 (template parameter T); all math
// and accumulation is fp32, and on the bf16 path each K entry is rounded to
// bf16 before the K @ V product, as the reference's bf16 matmul operand is.
// No atomics: every output row is written by exactly one block, and its sum
// runs in an order fixed by the columns alone (not by m), so a launch gives
// the same result on every run and a row the same bits in any launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;    // output rows per block
constexpr int BN = 64;    // columns of K per step of the in-block loop
constexpr int NT = 256;   // threads per block
constexpr int LDP = 68;   // row stride of the transposed shared tiles (16-byte rows)
constexpr int MAX_COMP = 4;
constexpr int MAX_FAC = 4;

struct KSpec {
  int ncomp;
  int nfac[MAX_COMP];
  int kind[MAX_COMP][MAX_FAC];
};

// kind codes, the order of repro_torch.kernels.kmvm.KIND_CODES
enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3, RQ = 4,
            WENDLAND2 = 5, WENDLAND4 = 6 };

// the spec resolved for one block, in shared memory
struct Spec {
  int ncomp, need_r;
  int fend[MAX_COMP];                 // one past the component's last factor
  float w[MAX_COMP];
  int kind[MAX_COMP * MAX_FAC];
  float q[MAX_COMP * MAX_FAC], sq[MAX_COMP * MAX_FAC], alpha[MAX_COMP * MAX_FAC];
};

// the K tile as the K @ V operand: unchanged for fp32, rounded for bf16
template <typename T>
__device__ __forceinline__ float as_operand(float x) { return x; }
template <>
__device__ __forceinline__ float as_operand<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One thread: scal in scalar_layout order (per component w_c, then per
// factor q_cf, + alpha_cf for rq). The loops are unrolled to the static
// bounds so the by-value KSpec is only ever indexed by constants.
__device__ __forceinline__ void resolve_spec(const KSpec& sp,
                                             const float* __restrict__ scal,
                                             Spec* s) {
  int slot = 0, f = 0, need_r = 0;
#pragma unroll
  for (int c = 0; c < MAX_COMP; ++c) {
    if (c < sp.ncomp) {
      s->w[c] = scal[slot++];
#pragma unroll
      for (int i = 0; i < MAX_FAC; ++i) {
        if (i < sp.nfac[c]) {
          const int kind = sp.kind[c][i];
          const float q = scal[slot++];
          s->kind[f] = kind;
          s->q[f] = q;
          s->sq[f] = sqrtf(q);
          s->alpha[f] = kind == RQ ? scal[slot++] : 0.0f;
          need_r |= kind != RBF && kind != RQ;
          ++f;
        }
      }
      s->fend[c] = f;
    }
  }
  s->ncomp = sp.ncomp;
  s->need_r = need_r;
}

// k[e] = sum_c w_c prod_f phi_cf(q_cf d2[e]) for N entries: the kind is
// branched on once per factor, the N entries of each factor are
// independent. r[e] = sqrt(d2[e]) when a factor needs it.
template <int N>
__device__ __forceinline__ void epilogue(const Spec& s, const float (&d2)[N],
                                         float (&k)[N]) {
  float r[N];
  if (s.need_r) {
#pragma unroll
    for (int e = 0; e < N; ++e) r[e] = sqrtf(d2[e]);
  }
#pragma unroll
  for (int e = 0; e < N; ++e) k[e] = 0.0f;
  int f = 0;
  for (int c = 0; c < s.ncomp; ++c) {
    float term[N];
#pragma unroll
    for (int e = 0; e < N; ++e) term[e] = 1.0f;
    for (; f < s.fend[c]; ++f) {
      const float q = s.q[f], sq = s.sq[f];
      switch (s.kind[f]) {
        case RBF:
#pragma unroll
          for (int e = 0; e < N; ++e) term[e] *= expf(-0.5f * (q * d2[e]));
          break;
        case RQ: {
          const float al = s.alpha[f];
#pragma unroll
          for (int e = 0; e < N; ++e)
            term[e] *= expf(-al * log1pf((q * d2[e]) / (2.0f * al)));
          break;
        }
        case MATERN12:
#pragma unroll
          for (int e = 0; e < N; ++e) term[e] *= expf(-(sq * r[e]));
          break;
        case MATERN32:
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float a = 1.7320508075688772f * (sq * r[e]);
            term[e] *= (1.0f + a) * expf(-a);
          }
          break;
        case MATERN52:
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float a = 2.23606797749979f * (sq * r[e]);
            term[e] *= (1.0f + a + (a * a) / 3.0f) * expf(-a);
          }
          break;
        case WENDLAND2:
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float rr = sq * r[e];
            const float b = fmaxf(1.0f - rr, 0.0f);
            const float b2 = b * b;
            term[e] *= b2 * b2 * (4.0f * rr + 1.0f);
          }
          break;
        case WENDLAND4:
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float rr = sq * r[e];
            const float b = fmaxf(1.0f - rr, 0.0f);
            const float b3 = b * b * b;
            term[e] *= b3 * b3 * ((35.0f * rr * rr + 18.0f * rr + 3.0f) / 3.0f);
          }
          break;
      }
    }
    const float w = s.w[c];
#pragma unroll
    for (int e = 0; e < N; ++e) k[e] += w * term[e];
  }
}

// ---- staging: global -> shared, asynchronous for fp32 ------------------

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// dst = ok ? *src : 0. fp32: a 4-byte cp.async (zero-filled when !ok; src
// is then any valid address); bf16: a plain load, converted.
__device__ __forceinline__ void stage(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.0f;
}

// features [k0, k0 + kw) of rows [r0, r0 + 64) of X (row-major, d columns)
// into dst[k * LD + r], by NTH threads; rows at or past rlim read as zero
template <int LD = LDP, int NTH = NT, typename T>
__device__ __forceinline__ void stage_features(float* dst, const T* __restrict__ X,
                                               int r0, int rlim, int k0, int kw,
                                               int d, int tid) {
  for (int e = tid; e < 64 * kw; e += NTH) {
    const int k = e >> 6, r = e & 63;
    const bool ok = r0 + r < rlim;
    stage(dst + k * LD + r, X + (ok ? (size_t)(r0 + r) * d + k0 + k : 0), ok);
  }
}

// RHS columns [c0, c0 + tcw) of rows [j0, j0 + 64) of V (row-major, t
// columns) into dst[c * LD + j] (dst[j] when TCH = 1), by NTH threads; rows
// at or past jlim read as zero
template <int TCH, int LD = LDP, int NTH = NT, typename T>
__device__ __forceinline__ void stage_rhs(float* dst, const T* __restrict__ V,
                                          int j0, int jlim, int c0, int tcw,
                                          int t, int tid) {
  for (int e = tid; e < 64 * tcw; e += NTH) {
    const int c = e >> 6, j = e & 63;
    const bool ok = j0 + j < jlim;
    stage(dst + (TCH == 1 ? j : c * LD + j),
          V + (ok ? (size_t)(j0 + j) * t + c0 + c : 0), ok);
  }
}

// Thread layout of the shared-memory K @ V pass for TCH > 1 output
// columns: CL column lanes x RT row threads, each thread owning RPT rows x
// CPT columns (cl + CL q) of the (BM, TCH) output tile.
template <int TCH> struct Layout;
template <> struct Layout<16> {
  static constexpr int CL = 16, CPT = 1, RT = 16, RPT = 4;
};
template <> struct Layout<128> {
  static constexpr int CL = 32, CPT = 4, RT = 8, RPT = 8;
};

template <int TCH>
__host__ __device__ constexpr int rhs_floats() { return TCH == 1 ? BN : TCH * LDP; }

// Blocks per SM the kernels are compiled for (__launch_bounds__): at t = 1
// three (at most 80 registers; the epilogue in two passes of 8 entries),
// above two (128 registers; 16 entries per pass at TCH = 16, 8 at 128).
template <int TCH>
__host__ __device__ constexpr int min_blocks() { return TCH == 1 ? 3 : 2; }

template <int TCH, int DK>
__host__ __device__ constexpr size_t smem_bytes() {
  return (4 * DK * LDP + 2 * rhs_floats<TCH>() + (TCH > 1 ? BM * LDP : 0)) *
             sizeof(float) + sizeof(Spec);
}

// The cross term of one feature chunk for a thread's micro-tile, plus the
// squared norms of its 4 columns (and of its 4 rows when NI).
template <int DK, bool NI>
__device__ __forceinline__ void cross_term(const float* xi, const float* xj,
                                           int kw, int ty, int tx,
                                           float (&g)[4][4], float (&nj)[4],
                                           float (&ni)[4]) {
#pragma unroll
  for (int k = 0; k < DK; ++k) {
    if (k < kw) {
      const float4 a4 = *reinterpret_cast<const float4*>(xi + k * LDP + 4 * ty);
      const float4 b4 = *reinterpret_cast<const float4*>(xj + k * LDP + 4 * tx);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) g[p][q] = fmaf(a[p], b[q], g[p][q]);
#pragma unroll
      for (int q = 0; q < 4; ++q) nj[q] = fmaf(b[q], b[q], nj[q]);
      if (NI) {
#pragma unroll
        for (int p = 0; p < 4; ++p) ni[p] = fmaf(a[p], a[p], ni[p]);
      }
    }
  }
}

// One block of B4: out rows [i0, min(i0 + BM, mlim)) = K(Xi rows,
// Xj[walked columns]) @ V[walked columns] on fp32 CUDA cores. DK: features
// per pipeline stage (4 or 16); d > DK walks (column chunk, feature chunk)
// stages and reloads the Xi feature chunk with each.
template <typename T, int TCH, int DK, class Cols>
__device__ __forceinline__ void row_tile(
    const T* __restrict__ Xi, const T* __restrict__ Xj, const T* __restrict__ V,
    const float* __restrict__ scal, const KSpec& sp, float* __restrict__ out,
    int i0, int mlim, int d, int t, const Cols& cols) {
  static_assert(BM == 64 && BN == 64, "the staging and the 4x4 micro-tile assume 64");
  constexpr int VS = rhs_floats<TCH>();
  constexpr int EH = TCH == 16 ? 16 : 8;  // entries per epilogue pass

  extern __shared__ __align__(16) float smem[];
  float* xi_s = smem;                  // [2][DK][LDP]
  float* xj_s = xi_s + 2 * DK * LDP;   // [2][DK][LDP]
  float* v_s = xj_s + 2 * DK * LDP;    // [2][VS]
  float* k_s = v_s + 2 * VS;           // [BM][LDP] when TCH > 1
  Spec* spec = reinterpret_cast<Spec*>(k_s + (TCH > 1 ? BM * LDP : 0));

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // micro-tile rows 4ty+p, cols 4tx+q
  const int nkc = (d + DK - 1) / DK;
  const int nst = cols.count() * nkc;      // pipeline stages
  const int kw0 = min(DK, d);

  if (tid == 0) resolve_spec(sp, scal, spec);
  if (nkc == 1) stage_features(xi_s, Xi, i0, mlim, 0, kw0, d, tid);

  // the shared-memory K @ V layout (TCH > 1)
  constexpr int CL = TCH > 1 ? Layout<(TCH > 1 ? TCH : 16)>::CL : 1;
  constexpr int CPT = TCH > 1 ? Layout<(TCH > 1 ? TCH : 16)>::CPT : 1;
  constexpr int RT = TCH > 1 ? Layout<(TCH > 1 ? TCH : 16)>::RT : 1;
  constexpr int RPT = TCH > 1 ? Layout<(TCH > 1 ? TCH : 16)>::RPT : 4;
  const int cl = tid % CL;
  const int rt = (tid / CL) % RT;

  // stage s: features of chunk s / nkc (and of Xi when nkc > 1) into buffer
  // s & 1; the RHS rows of the chunk into buffer (s / nkc) & 1 at its first
  // feature chunk
  auto issue = [&](int s, int j0, int jlim, int c0, int tcw) {
    const int kch = s / nkc, kc = s - kch * nkc;
    const int k0 = kc * DK, kw = min(DK, d - k0);
    stage_features(xj_s + (s & 1) * DK * LDP, Xj, j0, jlim, k0, kw, d, tid);
    if (nkc > 1) stage_features(xi_s + (s & 1) * DK * LDP, Xi, i0, mlim, k0, kw, d, tid);
    if (kc == 0) stage_rhs<TCH>(v_s + (kch & 1) * VS, V, j0, jlim, c0, tcw, t, tid);
    cp_async_commit();
  };

  float ni[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < t; c0 += TCH) {
    const int tcw = min(TCH, t - c0);
    float acc[RPT][CPT];
#pragma unroll
    for (int p = 0; p < RPT; ++p)
#pragma unroll
      for (int q = 0; q < CPT; ++q) acc[p][q] = 0.0f;

    int j0 = 0, jlim = 0;
    if (nst > 0) {
      cols.chunk(0, j0, jlim);
      issue(0, j0, jlim, c0, tcw);
    }
    float g[4][4], nj[4];
    for (int s = 0; s < nst; ++s) {
      const int kch = s / nkc, kc = s - kch * nkc;
      int nj0 = j0, njlim = jlim;  // the next stage's columns, read early
      if (s + 1 < nst && kc + 1 == nkc) cols.chunk(kch + 1, nj0, njlim);
      cp_async_wait_all();
      __syncthreads();  // stage s is visible; every thread is past stage s - 1
      if (s + 1 < nst) issue(s + 1, nj0, njlim, c0, tcw);

      if (kc == 0) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          nj[p] = 0.0f;
#pragma unroll
          for (int q = 0; q < 4; ++q) g[p][q] = 0.0f;
        }
      }
      const int kw = min(DK, d - kc * DK);
      const float* xi = xi_s + (nkc > 1 ? (s & 1) * DK * LDP : 0);
      const float* xj = xj_s + (s & 1) * DK * LDP;
      if (nkc > 1 || s == 0) {  // the rows' norms: once, or per feature chunk
        if (kc == 0) {
#pragma unroll
          for (int p = 0; p < 4; ++p) ni[p] = 0.0f;
        }
        cross_term<DK, true>(xi, xj, kw, ty, tx, g, nj, ni);
      } else {
        cross_term<DK, false>(xi, xj, kw, ty, tx, g, nj, ni);
      }

      if (kc + 1 == nkc) {  // the chunk's epilogue and K @ V
        // columns of this thread's micro-tile past the chunk's end (a
        // ragged last chunk) get K = 0
        const int nvalid = jlim - j0 - 4 * tx;
        const float* vb = v_s + (kch & 1) * VS;
        float v[4];
        if constexpr (TCH == 1) {
          const float4 v4 = *reinterpret_cast<const float4*>(vb + 4 * tx);
          v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
        }
        // EH entries (EH / 4 rows of the micro-tile) at a time: d2, the
        // epilogue, then straight into K @ V (t = 1) or the K tile
#pragma unroll
        for (int h = 0; h < 16 / EH; ++h) {
          float d2[EH], kv[EH];
#pragma unroll
          for (int e = 0; e < EH; ++e) {
            const int p = (h * EH + e) / 4, q = e % 4;
            d2[e] = fmaxf(ni[p] + nj[q] - 2.0f * g[p][q], 0.0f);
          }
          epilogue<EH>(*spec, d2, kv);
#pragma unroll
          for (int e = 0; e < EH; ++e) {
            kv[e] = as_operand<T>(kv[e]);
            if (nvalid < 4 && e % 4 >= nvalid) kv[e] = 0.0f;
          }
#pragma unroll
          for (int pr = 0; pr < EH / 4; ++pr) {
            const int p = h * (EH / 4) + pr;
            if constexpr (TCH == 1) {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[p][0] = fmaf(kv[4 * pr + q], v[q], acc[p][0]);
            } else {
              *reinterpret_cast<float4*>(k_s + (4 * ty + p) * LDP + 4 * tx) =
                  make_float4(kv[4 * pr], kv[4 * pr + 1], kv[4 * pr + 2],
                              kv[4 * pr + 3]);
            }
          }
        }
        if constexpr (TCH > 1) {
          __syncthreads();
#pragma unroll 2
          for (int j = 0; j < BN; j += 4) {
            float4 kr[RPT], vr[CPT];
#pragma unroll
            for (int p = 0; p < RPT; ++p)
              kr[p] = *reinterpret_cast<const float4*>(k_s + (rt * RPT + p) * LDP + j);
#pragma unroll
            for (int q = 0; q < CPT; ++q)
              vr[q] = *reinterpret_cast<const float4*>(vb + (cl + CL * q) * LDP + j);
#pragma unroll
            for (int p = 0; p < RPT; ++p)
#pragma unroll
              for (int q = 0; q < CPT; ++q) {
                acc[p][q] = fmaf(kr[p].x, vr[q].x, acc[p][q]);
                acc[p][q] = fmaf(kr[p].y, vr[q].y, acc[p][q]);
                acc[p][q] = fmaf(kr[p].z, vr[q].z, acc[p][q]);
                acc[p][q] = fmaf(kr[p].w, vr[q].w, acc[p][q]);
              }
          }
        }
      }
      j0 = nj0;
      jlim = njlim;
    }
    cp_async_wait_all();  // nothing in flight (the Xi tile when nst = 0)
    __syncthreads();      // every thread is done with v_s and k_s

    if constexpr (TCH == 1) {
      // the 16 threads of a row group (lanes tx of a half-warp) combine
      // their 4 row sums by a fixed tree: xor 8 halves the rows, xor 4
      // halves them again, xor 2 and 1 add the rest
      const unsigned full = 0xffffffffu;
      const bool h8 = tx & 8, h4 = tx & 4;
      float k0 = h8 ? acc[2][0] : acc[0][0], k1 = h8 ? acc[3][0] : acc[1][0];
      const float s0 = h8 ? acc[0][0] : acc[2][0], s1 = h8 ? acc[1][0] : acc[3][0];
      k0 += __shfl_xor_sync(full, s0, 8);
      k1 += __shfl_xor_sync(full, s1, 8);
      float v = h4 ? k1 : k0;
      v += __shfl_xor_sync(full, h4 ? k0 : k1, 4);
      v += __shfl_xor_sync(full, v, 2);
      v += __shfl_xor_sync(full, v, 1);
      const int r = 4 * ty + (h8 ? 2 : 0) + (h4 ? 1 : 0);
      if ((tx & 3) == 0 && i0 + r < mlim) out[(size_t)(i0 + r) * t + c0] = v;
    } else {
#pragma unroll
      for (int p = 0; p < RPT; ++p) {
        const int r = rt * RPT + p;
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const int c = cl + CL * q;
          if (i0 + r < mlim && c < tcw) out[(size_t)(i0 + r) * t + c0 + c] = acc[p][q];
        }
      }
    }
  }
}

// ---- TF32 tensor-core products (kmvm.cu, kgrad.cu) -----------------------

constexpr int LDT = 72;     // row stride of their shared tiles, 8 mod 32

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (x - hi is exact in fp32); with !SPLIT (bf16
// operands, exact in TF32) hi = x and lo is unused
template <bool SPLIT>
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  if constexpr (SPLIT) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over one k8 step: small*big, big*small, then big*big (3xTF32),
// or the one exact product of bf16 operands
template <bool SPLIT>
__device__ __forceinline__ void mma_step(float (&c)[4], const unsigned (&ah)[4],
                                         const unsigned (&al)[4], float b0,
                                         float b1) {
  unsigned bh0, bl0, bh1, bl1;
  split<SPLIT>(b0, bh0, bl0);
  split<SPLIT>(b1, bh1, bl1);
  if constexpr (SPLIT) {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void mma_tf32_k4(float (&c)[4], unsigned a0,
                                            unsigned a1, unsigned b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// the same over one k4 step (m16n8k4: half the depth, half the work)
template <bool SPLIT>
__device__ __forceinline__ void mma_step_k4(float (&c)[4], const unsigned (&ah)[2],
                                            const unsigned (&al)[2], float b) {
  unsigned bh, bl;
  split<SPLIT>(b, bh, bl);
  if constexpr (SPLIT) {
    mma_tf32_k4(c, al[0], al[1], bh);
    mma_tf32_k4(c, ah[0], ah[1], bl);
  }
  mma_tf32_k4(c, ah[0], ah[1], bh);
}

__device__ __forceinline__ float sum4(float x) {  // over the lanes of a quad
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

KSpec unpack_spec(const int* spec) {
  KSpec sp;
  sp.ncomp = spec[0];
  for (int c = 0; c < MAX_COMP; ++c) {
    sp.nfac[c] = spec[1 + c];
    for (int f = 0; f < MAX_FAC; ++f)
      sp.kind[c][f] = spec[1 + MAX_COMP + c * MAX_FAC + f];
  }
  return sp;
}

// `return CALL(TCH, DK);` for the t-chunk of t (1, 16 or 128 RHS columns
// per pass) and the feature stage of d (4 for d <= 4, else 16)
#define BY_SHAPE(d, t, CALL)              \
  if ((d) <= 4) {                         \
    if ((t) == 1) return CALL(1, 4);      \
    if ((t) <= 16) return CALL(16, 4);    \
    return CALL(128, 4);                  \
  }                                       \
  if ((t) == 1) return CALL(1, 16);       \
  if ((t) <= 16) return CALL(16, 16);     \
  return CALL(128, 16);

}  // namespace
