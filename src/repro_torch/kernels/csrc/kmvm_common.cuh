// The tile body shared by the fused kernel-MVM kernels (kmvm.cu: B1, B2, B3)
// and the block-sparse kernel (kmvm_sparse.cu: B4), for NVIDIA Hopper
// (sm_90a). The counterpart of `_kernel_tile` (src/repro/kernels/kmvm.py:81)
// and of the same arithmetic in `_bs_kernel` (src/repro/sparse/kmvm_sparse.py:44):
//   d2 = max(|xi|^2 + |xj|^2 - 2 xi.xj, 0)             (fp32, norms from the
//                                                        operand-dtype values)
//   K  = sum_c w_c prod_f phi_cf(q_cf * d2)             (fp32 epilogue)
//   out[i, :] += K[i, j] * V[j, :]                      (fp32 accumulation)
//
// One thread block (256 threads) owns BM = 64 output rows and walks a
// sequence of BN = 64-column chunks of Xj and V in an in-block loop (the
// chunks come from a column walker: every column tile for B1/B2, the active
// column tiles of the row's sparsity pattern for B4), so the output tile
// stays in registers for the whole reduction and the kernel slab never
// reaches device memory. Per chunk: the Xi/Xj feature chunks (DK = 16
// features at a time, any d) and the V chunk go through shared memory; each
// thread accumulates a 4x4 micro-tile of the cross term, applies the
// component epilogue and writes the K tile to shared memory; then each
// thread accumulates its share of K @ V. The RHS count t is covered in
// chunks of TCH = 1, 16 or 128 columns (a template parameter picked from t),
// so t = 1 (CG, Lanczos), t = 9 (training: y + 8 probes) and t = 128
// (prediction) each get a thread layout that keeps all 256 threads busy.
// Ragged rows, columns and d are masked in the kernel; nothing is padded in
// device memory. Operands are fp32 or bf16 (template parameter T); all math
// and accumulation is fp32, and on the bf16 path each K entry is rounded to
// bf16 before the K @ V product, as the reference's bf16 matmul operand is.
// No atomics: every output row is written by exactly one block, in a fixed
// order, so a launch gives the same result on every run. With ACC (B3) the
// output tile is the running accumulator: the block seeds its registers
// from `out` and writes the tile back in place, so a walk over column
// chunks continues the same register sum a single launch would form.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;    // output rows per block
constexpr int BN = 64;    // columns of K per step of the in-block loop
constexpr int DK = 16;    // features per chunk
constexpr int NT = 256;   // threads per block
constexpr int MAX_COMP = 4;
constexpr int MAX_FAC = 4;
constexpr int SCAL_SLOTS = 64;  // >= MAX_COMP * (1 + 2 * MAX_FAC)

struct KSpec {
  int ncomp;
  int nfac[MAX_COMP];
  int kind[MAX_COMP][MAX_FAC];
};

// kind codes, the order of repro_torch.kernels.kmvm.KIND_CODES
enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3, RQ = 4,
            WENDLAND2 = 5, WENDLAND4 = 6 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the K tile as the K @ V operand: unchanged for fp32, rounded for bf16
template <typename T>
__device__ __forceinline__ float as_operand(float x) { return x; }
template <>
__device__ __forceinline__ float as_operand<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float phi(int kind, float d2, float alpha) {
  if (kind == RBF) return expf(-0.5f * d2);
  if (kind == RQ) return expf(-alpha * log1pf(d2 / (2.0f * alpha)));
  const float r = d2 > 0.0f ? sqrtf(d2) : 0.0f;
  switch (kind) {
    case MATERN12:
      return expf(-r);
    case MATERN32: {
      const float a = 1.7320508075688772f * r;
      return (1.0f + a) * expf(-a);
    }
    case MATERN52: {
      const float a = 2.23606797749979f * r;
      return (1.0f + a + (a * a) / 3.0f) * expf(-a);
    }
    case WENDLAND2: {
      const float b = fmaxf(1.0f - r, 0.0f);
      const float b2 = b * b;
      return b2 * b2 * (4.0f * r + 1.0f);
    }
    case WENDLAND4: {
      const float b = fmaxf(1.0f - r, 0.0f);
      const float b3 = b * b * b;
      return b3 * b3 * ((35.0f * r * r + 18.0f * r + 3.0f) / 3.0f);
    }
  }
  return 0.0f;
}

// sum_c w_c prod_f phi_cf(q_cf d2), scalars in scalar_layout order:
// per component w_c, then per factor q_cf (+ alpha_cf for rq)
__device__ __forceinline__ float epilogue(const KSpec& sp, const float* sc,
                                          float d2) {
  float k = 0.0f;
  int s = 0;
  for (int c = 0; c < sp.ncomp; ++c) {
    const float w = sc[s++];
    float term = 1.0f;
    for (int f = 0; f < sp.nfac[c]; ++f) {
      const int kind = sp.kind[c][f];
      const float q = sc[s++];
      float alpha = 0.0f;
      if (kind == RQ) alpha = sc[s++];
      term *= phi(kind, q * d2, alpha);
    }
    k += w * term;
  }
  return k;
}

// Thread layout of the K @ V step for a chunk of TCH output columns:
// CL column lanes x RT row threads x JS splits of the BN columns of K,
// each thread owning RPT rows x CPT columns of the (BM, TCH) output tile.
template <int TCH> struct Layout;
template <> struct Layout<1> {
  static constexpr int CL = 1, CPT = 1, RT = 64, RPT = 1, JS = 4;
};
template <> struct Layout<16> {
  static constexpr int CL = 16, CPT = 1, RT = 16, RPT = 4, JS = 1;
};
template <> struct Layout<128> {
  static constexpr int CL = 32, CPT = 4, RT = 8, RPT = 8, JS = 1;
};

template <int TCH>
constexpr size_t smem_floats() {
  return BM * (DK + 1) + BN * (DK + 1) + BM * (BN + 1) + BN * TCH + BM + BN +
         SCAL_SLOTS;
}

// rows [r0, r0 + 64) x features [k0, k0 + DK) of X into shared memory;
// rows at or past `rows` and features at or past d read as zero
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* __restrict__ X,
                                           int r0, int rows, int k0, int d,
                                           int tid) {
  for (int e = tid; e < 64 * DK; e += NT) {
    const int r = e / DK, k = e % DK;
    float v = 0.0f;
    if (r0 + r < rows && k0 + k < d) v = to_f32(X[(size_t)(r0 + r) * d + k0 + k]);
    dst[r * (DK + 1) + k] = v;
  }
}

// Column walker of the dense kernels: chunks [(begin + k) BN, + BN) of the
// Xj column tiles [begin, end), masked at n.
struct DenseCols {
  int begin, end, n;
  __device__ __forceinline__ int count() const { return end - begin; }
  __device__ __forceinline__ void chunk(int k, int& j0, int& jlim) const {
    j0 = (begin + k) * BN;
    jlim = n;
  }
};

// One block: out rows [i0, min(i0 + BM, mlim)) = K(Xi rows, Xj[walked
// columns]) @ V[walked columns]; with DOTS, also the row tile's CG partials
// [<Kv,v>, <r,v>, <r,r>, <v,v>] per column into dots[0..4t); with ACC,
// out rows += that product instead (the first column split's registers
// start from out, the others from zero, so the in-block split sum adds in
// the same order).
template <typename T, int TCH, bool DOTS, class Cols, bool ACC = false>
__device__ __forceinline__ void row_tile(
    const T* __restrict__ Xi, const T* __restrict__ Xj, const T* __restrict__ V,
    const float* __restrict__ Vrow, const float* __restrict__ R,
    const float* __restrict__ scal, const KSpec& sp, float* __restrict__ out,
    float* __restrict__ dots, int i0, int mlim, int d, int t, int L,
    const Cols& cols) {
  static_assert(BM == 64 && BN == 64, "load_chunk and the 4x4 micro-tile assume 64");
  using C = Layout<TCH>;
  constexpr int JW = BN / C::JS;

  extern __shared__ float smem[];
  float* xi_s = smem;
  float* xj_s = xi_s + BM * (DK + 1);
  float* k_s = xj_s + BN * (DK + 1);
  float* v_s = k_s + BM * (BN + 1);
  float* ni_s = v_s + BN * TCH;
  float* nj_s = ni_s + BM;
  float* sc_s = nj_s + BN;

  const int tid = threadIdx.x;
  const int nkc = (d + DK - 1) / DK;
  const int nchunks = cols.count();

  if (tid < L) sc_s[tid] = scal[tid];
  if (tid < BM) {
    float s = 0.0f;
    if (i0 + tid < mlim) {
      const T* row = Xi + (size_t)(i0 + tid) * d;
      for (int k = 0; k < d; ++k) {
        const float x = to_f32(row[k]);
        s += x * x;
      }
    }
    ni_s[tid] = s;
  }
  if (nkc == 1) load_chunk(xi_s, Xi, i0, mlim, 0, d, tid);

  // cross-term micro-tile: rows ty + 16p, columns tx + 16q
  const int ty = tid / 16, tx = tid % 16;
  // K @ V layout
  const int cl = tid % C::CL;
  const int rt = (tid / C::CL) % C::RT;
  const int js = tid / (C::CL * C::RT);

  for (int c0 = 0; c0 < t; c0 += TCH) {
    const int tcw = min(TCH, t - c0);
    float acc[C::RPT][C::CPT];
#pragma unroll
    for (int p = 0; p < C::RPT; ++p)
#pragma unroll
      for (int q = 0; q < C::CPT; ++q) {
        float a0 = 0.0f;
        if (ACC && js == 0) {
          const int r = rt * C::RPT + p, c = cl + C::CL * q;
          if (i0 + r < mlim && c < tcw) a0 = out[(size_t)(i0 + r) * t + c0 + c];
        }
        acc[p][q] = a0;
      }

    for (int kch = 0; kch < nchunks; ++kch) {
      int j0, jlim;
      cols.chunk(kch, j0, jlim);
      float g[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) g[p][q] = 0.0f;
      float njp = 0.0f;

      for (int kc = 0; kc < nkc; ++kc) {
        const int k0 = kc * DK;
        if (nkc > 1) load_chunk(xi_s, Xi, i0, mlim, k0, d, tid);
        load_chunk(xj_s, Xj, j0, jlim, k0, d, tid);
        if (kc == 0) {
          for (int e = tid; e < BN * TCH; e += NT) {
            const int j = e / TCH, c = e % TCH;
            float v = 0.0f;
            if (j0 + j < jlim && c < tcw) v = to_f32(V[(size_t)(j0 + j) * t + c0 + c]);
            v_s[e] = v;
          }
        }
        __syncthreads();
        const int kmax = min(DK, d - k0);
#pragma unroll
        for (int k = 0; k < DK; ++k) {
          if (k < kmax) {
            float a[4], b[4];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              a[p] = xi_s[(ty + 16 * p) * (DK + 1) + k];
              b[p] = xj_s[(tx + 16 * p) * (DK + 1) + k];
            }
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
              for (int q = 0; q < 4; ++q) g[p][q] += a[p] * b[q];
          }
        }
        if (tid < BN) {
          for (int k = 0; k < kmax; ++k) {
            const float x = xj_s[tid * (DK + 1) + k];
            njp += x * x;
          }
        }
        __syncthreads();
      }
      if (tid < BN) nj_s[tid] = njp;
      __syncthreads();

#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int r = ty + 16 * p;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = tx + 16 * q;
          const float d2 = fmaxf(ni_s[r] + nj_s[j] - 2.0f * g[p][q], 0.0f);
          k_s[r * (BN + 1) + j] =
              (j0 + j < jlim) ? as_operand<T>(epilogue(sp, sc_s, d2)) : 0.0f;
        }
      }
      __syncthreads();

      for (int jj = 0; jj < JW; ++jj) {
        const int j = js * JW + jj;
        float vv[C::CPT];
#pragma unroll
        for (int q = 0; q < C::CPT; ++q) vv[q] = v_s[j * TCH + cl + C::CL * q];
#pragma unroll
        for (int p = 0; p < C::RPT; ++p) {
          const float kv = k_s[(rt * C::RPT + p) * (BN + 1) + j];
#pragma unroll
          for (int q = 0; q < C::CPT; ++q) acc[p][q] += kv * vv[q];
        }
      }
      __syncthreads();
    }

    if (C::JS > 1) {  // sum the column splits, in split order, through k_s
#pragma unroll
      for (int p = 0; p < C::RPT; ++p)
#pragma unroll
        for (int q = 0; q < C::CPT; ++q)
          k_s[(js * BM + rt * C::RPT + p) * TCH + cl + C::CL * q] = acc[p][q];
      __syncthreads();
      if (js == 0) {
#pragma unroll
        for (int p = 0; p < C::RPT; ++p)
#pragma unroll
          for (int q = 0; q < C::CPT; ++q) {
            float s = 0.0f;
            for (int sp_i = 0; sp_i < C::JS; ++sp_i)
              s += k_s[(sp_i * BM + rt * C::RPT + p) * TCH + cl + C::CL * q];
            acc[p][q] = s;
          }
      }
    }

    if (js == 0) {
#pragma unroll
      for (int p = 0; p < C::RPT; ++p) {
        const int r = rt * C::RPT + p;
#pragma unroll
        for (int q = 0; q < C::CPT; ++q) {
          const int c = cl + C::CL * q;
          if (i0 + r < mlim && c < tcw) out[(size_t)(i0 + r) * t + c0 + c] = acc[p][q];
          if (DOTS) v_s[r * TCH + c] = acc[p][q];  // the finished tile, for the dots
        }
      }
    }

    if (DOTS) {
      __syncthreads();
      if (tid < tcw) {
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        const int rows = min(BM, mlim - i0);
        for (int r = 0; r < rows; ++r) {
          const size_t idx = (size_t)(i0 + r) * t + c0 + tid;
          const float kv = v_s[r * TCH + tid];
          const float vr = Vrow[idx];
          const float rr = R[idx];
          s0 += kv * vr;
          s1 += rr * vr;
          s2 += rr * rr;
          s3 += vr * vr;
        }
        float* dp = dots + c0 + tid;
        dp[0] = s0;
        dp[(size_t)t] = s1;
        dp[2 * (size_t)t] = s2;
        dp[3 * (size_t)t] = s3;
      }
    }
    __syncthreads();  // before the next column chunk reuses k_s and v_s
  }
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

}  // namespace
