// Fused distance -> kernel-sum -> K @ V for NVIDIA Hopper (sm_90a), with
// both products on the tensor cores.
//
// Replaces the three dense Pallas TPU kernels:
//   kmvm_kernel      <- src/repro/kernels/kmvm.py::kmvm_pallas       (_kmvm_kernel)
//   kmvm_kernel + kmvm_split_sum
//                    <- src/repro/kernels/kmvm.py::kmvm_pallas_dots  (_kmvm_dots_kernel)
//   kmvm_acc_kernel  <- src/repro/kernels/kmvm.py::kmvm_pallas_chunk (_kmvm_acc_kernel)
// All share the tile body of `_kernel_tile` (kmvm.py:81):
//   d2 = max(|xi|^2 + |xj|^2 - 2 xi.xj, 0)             (fp32 norms from the
//                                                        operand-dtype values)
//   K  = sum_c w_c prod_f phi_cf(q_cf * d2)             (IEEE fp32 epilogue)
//   out[i, :] += K[i, j] * V[j, :]                      (fp32 accumulation)
// B1 and B2 launch kmvm_kernel split over the columns, then kmvm_split_sum,
// which sums the splits in split order (so B2's out is B1's, bit for bit)
// and, for B2 (the fused CG step), writes the per-column partials
// [<Kv,v>, <r,v>, <r,r>, <v,v>] of each 64-row tile to a
// (num_row_tiles, 4, t) buffer that the caller sums: no atomics, the same
// result on every run.
// kmvm_acc_kernel is one chunk step of the distributed engine's ring
// contraction: acc += K(Xi, Xj_chunk) @ V_chunk, the (m, t) fp32
// accumulator updated in place.
//
// What bounds it. Per (i, j) entry: 2d operations for the cross term, 2t
// for K @ V, and the epilogue (for matern32 about 15 fp32 operations and
// two MUFU operations, an exp and a sqrt); the bytes, (m + n) d + n t + m t
// operands, are negligible. On fp32 CUDA cores the two products were 28%
// (the cross term at d = 9) and 36% (K @ V at t = 9) of an entry, so both
// go to the tensor cores. What is left bounds it: the epilogue's issue and
// latency (the MUFU floor, 16 per SM per clock, is a fifth of the time),
// so occupancy matters as much as the instruction count.
//
// Design. One block owns a BM = 64 row tile and walks the column tiles of
// Xj and V (BN = 64) in an in-block loop, the TPU's sequential grid axis,
// so the output stays in registers for the whole walk and the (m, n)
// kernel slab never reaches device memory. At t > 1 the block is four
// warps, warp w owning rows 16w..16w+15 against all 64 columns of each
// chunk; at t = 1 it is eight, two warps per 16 rows, each taking half of
// every chunk's columns (a 64-row served batch is one row tile per column
// split, so the block's own latency is the launch's). A warp works in
// groups of two n8 tiles (16 columns: 8 entries per thread):
//
// - The cross term G = Xi Xj^T of a group is m16n8k8 TF32 `mma.sync`
//   products, one per k8 step of the features, plus an m16n8k4 step when d
//   leaves 4 (DK = 4, 12 or 16 features per stage, zero-padded in shared
//   memory: d = 9 is a k8 and a k4 step). An fp32 operand is split
//   a = big + small with cvt.rna (big = tf32(a), small = tf32(a - big)) and
//   each product is small*big + big*small + big*big into the fp32
//   accumulator (3xTF32, about fp32's accuracy); bf16 operands are exact in
//   TF32, one product. The Xi fragments are split once per walk.
// - The tensor cores truncate what they add into a large accumulator: one
//   accumulator over a 2^17-column walk drifted 7.7e-4 of max|out| from the
//   plain version. So a stage's G and a chunk's K @ V start from zero and
//   are added to the running sums in fp32.
// - The squared norms come from the same fragment loads in fp32 (each
//   lane's features, then a two-step shuffle tree over the four lanes of a
//   row or column, and two shuffles for a lane's two columns): no norm pass
//   and no barrier for it.
// - The epilogue (`epilogue<8>` of kmvm_common.cuh) runs on the
//   accumulator fragments: rows gid and gid + 8, columns 2 tig and
//   2 tig + 1 of each n8 tile.
// - K @ V at t > 1 is a second 3xTF32 mma with the K fragments as its A
//   operand, straight from the epilogue's registers. The C fragment of an
//   n8 tile (columns 2 tig, 2 tig + 1) is the A fragment of one k8 step
//   (k slots tig, tig + 4) when the chunk's columns are taken in the order
//   0, 2, 4, 6, 1, 3, 5, 7 within each group of eight; V's rows are read in
//   the same order (one 8-byte load of rows 2 tig, 2 tig + 1), and a
//   permutation applied to both sides of a sum over the columns changes
//   only the order. The K tile never goes through shared memory: one
//   barrier per chunk. At t = 9 the chunk's K @ V runs as two chains (even
//   and odd k8 steps) for the mma latency.
// - K @ V at t = 1 (CG, Lanczos) stays as fp32 row sums in registers (an
//   n8 mma would waste 7 of its 8 columns); at the end of the walk the four
//   lanes of a row combine them by a fixed shuffle tree, and the warp of
//   the first column half adds the second half's sum.
// - Features and RHS rows are double-buffered with cp.async (fp32; bf16 is
//   staged by plain loads), the next chunk's loads in flight while the
//   current chunk runs; the shared tiles have a row stride of 72 floats
//   (8 mod 32), so each fragment load of a warp hits 32 distinct banks.
// - Occupancy: 24 warps (80 registers) per SM at t = 1, four blocks at
//   t <= 16, two at t = 128; 20 or 12 warps at t = 1, or 16-entry passes,
//   were slower on an H100.
// - B2's wave tail: unsplit, B2 ran 1024 blocks in 1.3 waves at 2^16 rows.
//   It now launches B1's column split, which fills the card, and
//   kmvm_split_sum, memory-bound and a few microseconds; that kernel also
//   replaces B1's host-side loop of split additions. In it each thread
//   takes its rows, a shuffle tree sums a warp at t = 1, and one thread
//   per column adds the eight warps' partials in warp order.
//
// Bits. At t > 1 an output element is one accumulator register of one
// thread for the whole walk (no two warps share a row), summed over the
// chunks in column order. With ACC (B3) the block seeds that register from
// acc and writes it back, so a walk over whole 64-column chunks continues
// the sum one B1 launch forms over the same columns, bit for bit; at t = 1
// the final trees regroup a multi-chunk walk, and a single chunk gives
// B1's bits. B1 therefore runs this body at every t, and B3 never splits
// its columns. A row's result depends on its columns only, never on m.
// kmvm_kernel splits the column range over gridDim.y (each split writes its
// own partial output, which the caller sums in split order), so a short
// row range such as a 1024-row prediction chunk still fills the card.

#include "kmvm_common.cuh"

namespace {

// per t-chunk: threads per block (four warps of 16 rows; at t = 1 two warps
// per 16 rows, each taking half of a chunk's columns) and the blocks per SM
// the kernels are compiled for
template <int TCH> struct TcShape;
template <> struct TcShape<1> { static constexpr int THREADS = 256, BLOCKS = 3; };
template <> struct TcShape<16> { static constexpr int THREADS = 128, BLOCKS = 4; };
template <> struct TcShape<128> { static constexpr int THREADS = 128, BLOCKS = 2; };
constexpr int PASS = 2;  // n8 tiles of K per epilogue pass (8 entries)

// G of PASS n8 tiles (C fragments) and the |xj|^2 partials of their columns
struct Group {
  float g[PASS][4];
  float pc[PASS];
};

template <int TCH>
__host__ __device__ constexpr int tc_rhs_floats() {
  return TCH == 1 ? BN : TCH * LDT;
}

template <int TCH, int DK>
constexpr size_t tc_smem_bytes() {
  return (4 * DK * LDT + 2 * tc_rhs_floats<TCH>()) * sizeof(float) + sizeof(Spec);
}

// Column walker: chunks [(begin + k) BN, + BN) of the Xj column tiles
// [begin, end), masked at n.
struct DenseCols {
  int begin, end, n;
  __device__ __forceinline__ int count() const { return end - begin; }
  __device__ __forceinline__ void chunk(int k, int& j0, int& jlim) const {
    j0 = (begin + k) * BN;
    jlim = n;
  }
};

// One block: out rows [i0, min(i0 + BM, mlim)) = K(Xi rows, Xj[walked
// columns]) @ V[walked columns]; with ACC, out rows += that product
// instead. DK: features per pipeline stage (4, 12 or 16: k8 steps and a k4
// step); MULTI (d > DK) walks (column chunk, feature chunk) stages and
// reloads the Xi feature chunk with each.
template <typename T, int TCH, int DK, bool MULTI, bool ACC>
__device__ __forceinline__ void row_tile_tc(
    const T* __restrict__ Xi, const T* __restrict__ Xj, const T* __restrict__ V,
    const float* __restrict__ scal, const KSpec& sp, float* __restrict__ out,
    int i0, int mlim, int d, int t, const DenseCols& cols) {
  static_assert(BM == 64 && BN == 64 && DK % 4 == 0, "16-row warps, k4 steps");
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int VS = tc_rhs_floats<TCH>();
  constexpr int KS = DK / 8;                  // k8 steps per stage
  constexpr bool K4 = DK % 8 == 4;            // and a k4 step after them
  constexpr int NTH = TcShape<TCH>::THREADS;
  constexpr int HALVES = NTH / 128;           // warps that share 16 rows
  constexpr int NTILE = 8 / HALVES;           // n8 tiles of a chunk per warp
  constexpr int NO = TCH == 1 ? 1 : TCH / 8;  // n8 tiles of the output
  constexpr int NP = NO < 4 ? 2 : 1;          // K @ V chains per output tile
  constexpr int TILE = DK * LDT;

  extern __shared__ __align__(16) float smem[];
  float* xi_s = smem;              // [2][DK][LDT]
  float* xj_s = xi_s + 2 * TILE;   // [2][DK][LDT]
  float* v_s = xj_s + 2 * TILE;    // [2][VS]
  Spec* spec = reinterpret_cast<Spec*>(v_s + 2 * VS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 16 * (warp % 4) + gid, r1 = r0 + 8;  // this thread's rows
  const int half = HALVES > 1 ? warp / 4 : 0;  // the warp's share of the columns
  const int nn0 = NTILE * half;                // and its first n8 tile
  const int nkc = MULTI ? (d + DK - 1) / DK : 1;
  const int nst = cols.count() * nkc;  // pipeline stages
  const int kw0 = min(DK, d);

  if (tid == 0) resolve_spec(sp, scal, spec);
  // the mma's depth padding: with nkc = 1 features [kw0, DK) of every
  // buffer are zeroed once and never staged; with nkc > 1 each stage
  // zeroes its own
  for (int e = tid; e < (DK - kw0) * BM; e += NTH) {
    const int o = (kw0 + e / BM) * LDT + e % BM;
    xi_s[o] = xi_s[TILE + o] = xj_s[o] = xj_s[TILE + o] = 0.0f;
  }
  if (!MULTI) stage_features<LDT, NTH>(xi_s, Xi, i0, mlim, 0, kw0, d, tid);

  // stage s: features of chunk s / nkc (and of Xi when nkc > 1) into buffer
  // s & 1; the RHS rows of the chunk into buffer (s / nkc) & 1 at its first
  // feature chunk
  auto issue = [&](int s, int j0, int jlim, int c0, int tcw) {
    const int kch = s / nkc, kc = s - kch * nkc;
    const int k0 = kc * DK, kw = min(DK, d - k0);
    float* xj = xj_s + (s & 1) * TILE;
    stage_features<LDT, NTH>(xj, Xj, j0, jlim, k0, kw, d, tid);
    if constexpr (MULTI) {
      float* xi = xi_s + (s & 1) * TILE;
      stage_features<LDT, NTH>(xi, Xi, i0, mlim, k0, kw, d, tid);
      for (int e = tid; e < (DK - kw) * BM; e += NTH) {  // zero-filled
        const int o = (kw + e / BM) * LDT + e % BM;
        stage(xi + o, Xi, false);
        stage(xj + o, Xj, false);
      }
    }
    if (kc == 0)
      stage_rhs<TCH, LDT, NTH>(v_s + (kch & 1) * VS, V, j0, jlim, c0, tcw, t, tid);
    cp_async_commit();
  };

  for (int c0 = 0; c0 < t; c0 += TCH) {
    const int tcw = min(TCH, t - c0);
    // the output: at t = 1 the row sums of rows r0, r1 in acc[0][0..1]; at
    // t > 1 the C fragments of NO n8 tiles (rows r0, r1 x columns 8o +
    // 2tig, + 1). With ACC the thread that owns an element seeds it.
    float acc[NO][4] = {};
    if constexpr (ACC && TCH == 1) {
      if (half == 0 && tig == 0 && i0 + r0 < mlim) acc[0][0] = out[(size_t)(i0 + r0) * t + c0];
      if (half == 0 && tig == 0 && i0 + r1 < mlim) acc[0][1] = out[(size_t)(i0 + r1) * t + c0];
    } else if constexpr (ACC) {
#pragma unroll
      for (int o = 0; o < NO; ++o)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r0 : r1, c = 8 * o + 2 * tig + (e & 1);
          if (i0 + r < mlim && c < tcw) acc[o][e] = out[(size_t)(i0 + r) * t + c0 + c];
        }
    }

    int j0 = 0, jlim = 0;
    if (nst > 0) {
      cols.chunk(0, j0, jlim);
      issue(0, j0, jlim, c0, tcw);
    }
    Group gm[MULTI ? NTILE / PASS : 1];  // MULTI: the chunk's G across its stages
    float pn[2], ni[2];  // |xi|^2 of rows r0, r1: partials, then whole
    unsigned ah[KS > 0 ? KS : 1][4], al[KS > 0 ? KS : 1][4];  // the Xi fragments, split
    unsigned a4h[2], a4l[2];  // and of the k4 step
    for (int s = 0; s < nst; ++s) {
      const int kch = s / nkc, kc = s - kch * nkc;
      int nj0 = j0, njlim = jlim;  // the next stage's columns, read early
      if (s + 1 < nst && kc + 1 == nkc) cols.chunk(kch + 1, nj0, njlim);
      cp_async_wait_all();
      __syncthreads();  // stage s is visible; every thread is past stage s - 1
      if (s + 1 < nst) issue(s + 1, nj0, njlim, c0, tcw);

      const float* xi = xi_s + (MULTI ? (s & 1) * TILE : 0);
      const float* xj = xj_s + (s & 1) * TILE;
      if (MULTI || s == 0) {  // the Xi fragments: once, or per feature chunk
        if (kc == 0) pn[0] = pn[1] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const float* xk = xi + (8 * ks + tig) * LDT;
          const float a[4] = {xk[r0], xk[r1], xk[4 * LDT + r0], xk[4 * LDT + r1]};
          pn[0] = fmaf(a[2], a[2], fmaf(a[0], a[0], pn[0]));
          pn[1] = fmaf(a[3], a[3], fmaf(a[1], a[1], pn[1]));
#pragma unroll
          for (int e = 0; e < 4; ++e) split<SPLIT>(a[e], ah[ks][e], al[ks][e]);
        }
        if constexpr (K4) {
          const float* xk = xi + (8 * KS + tig) * LDT;
          const float a[2] = {xk[r0], xk[r1]};
          pn[0] = fmaf(a[0], a[0], pn[0]);
          pn[1] = fmaf(a[1], a[1], pn[1]);
          split<SPLIT>(a[0], a4h[0], a4l[0]);
          split<SPLIT>(a[1], a4h[1], a4l[1]);
        }
        if (kc + 1 == nkc) {
          ni[0] = sum4(pn[0]);
          ni[1] = sum4(pn[1]);
        }
      }
      // G of n8 tile nn over this stage's features into c, and the |xj|^2
      // partials of its column 8nn + gid into pc
      auto cross = [&](int nn, float (&c)[4], float& pc) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const float* xk = xj + (8 * ks + tig) * LDT + 8 * nn + gid;
          const float b0 = xk[0], b1 = xk[4 * LDT];
          pc = fmaf(b1, b1, fmaf(b0, b0, pc));
          mma_step<SPLIT>(c, ah[ks], al[ks], b0, b1);
        }
        if constexpr (K4) {
          const float b = xj[(8 * KS + tig) * LDT + 8 * nn + gid];
          pc = fmaf(b, b, pc);
          mma_step_k4<SPLIT>(c, a4h, a4l, b);
        }
      };
      if constexpr (MULTI) {
        // a later feature chunk's G starts from zero in the accumulator and
        // is added in fp32: the tensor cores truncate what they add into a
        // large accumulator
#pragma unroll
        for (int nn = 0; nn < NTILE; ++nn) {
          Group& gp = gm[nn / PASS];
          const int p = nn % PASS;
          if (kc == 0) {
            gp.g[p][0] = gp.g[p][1] = gp.g[p][2] = gp.g[p][3] = gp.pc[p] = 0.0f;
            cross(nn0 + nn, gp.g[p], gp.pc[p]);
          } else {
            float gs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            cross(nn0 + nn, gs, gp.pc[p]);
#pragma unroll
            for (int e = 0; e < 4; ++e) gp.g[p][e] += gs[e];
          }
        }
      }

      if (kc + 1 == nkc) {  // the chunk's epilogue and K @ V
        // columns past the chunk's end (a ragged last chunk) get K = 0
        const int nvalid = jlim - j0;
        const float* vb = v_s + (kch & 1) * VS;
        // at t > 1 the chunk's K @ V starts from zero in the accumulator
        // (two chains by k8 step parity when the output has few tiles) and
        // is added to acc in fp32
        float part[NP][NO][4] = {};
#pragma unroll
        for (int hh = 0; hh < NTILE; hh += PASS) {
          // G of tiles h .. h + PASS - 1: from the stages, or here
          const int h = nn0 + hh;
          Group gr;
          if constexpr (MULTI) {
            gr = gm[hh / PASS];
          } else {
#pragma unroll
            for (int p = 0; p < PASS; ++p) {
              gr.g[p][0] = gr.g[p][1] = gr.g[p][2] = gr.g[p][3] = gr.pc[p] = 0.0f;
              cross(h + p, gr.g[p], gr.pc[p]);
            }
          }
          float d2[4 * PASS], kv[4 * PASS];
#pragma unroll
          for (int p = 0; p < PASS; ++p) {
            // the norms of this thread's columns 8nn + 2tig and + 1
            const float nj = sum4(gr.pc[p]);
            const float nje = __shfl_sync(0xffffffffu, nj, 8 * tig);
            const float njo = __shfl_sync(0xffffffffu, nj, 8 * tig + 4);
            const float* gg = gr.g[p];
            d2[4 * p + 0] = fmaxf(ni[0] + nje - 2.0f * gg[0], 0.0f);
            d2[4 * p + 1] = fmaxf(ni[0] + njo - 2.0f * gg[1], 0.0f);
            d2[4 * p + 2] = fmaxf(ni[1] + nje - 2.0f * gg[2], 0.0f);
            d2[4 * p + 3] = fmaxf(ni[1] + njo - 2.0f * gg[3], 0.0f);
          }
          epilogue<4 * PASS>(*spec, d2, kv);
#pragma unroll
          for (int e = 0; e < 4 * PASS; ++e) {
            kv[e] = as_operand<T>(kv[e]);
            if (nvalid < BN && 8 * (h + e / 4) + 2 * tig + (e & 1) >= nvalid)
              kv[e] = 0.0f;
          }
#pragma unroll
          for (int p = 0; p < PASS; ++p) {
            const int nn = h + p;
            const float* k = kv + 4 * p;
            if constexpr (TCH == 1) {
              const float2 v2 = *reinterpret_cast<const float2*>(vb + 8 * nn + 2 * tig);
              acc[0][0] = fmaf(k[1], v2.y, fmaf(k[0], v2.x, acc[0][0]));
              acc[0][1] = fmaf(k[3], v2.y, fmaf(k[2], v2.x, acc[0][1]));
            } else {
              // A of k8 step nn: slots tig, tig + 4 = columns 2tig, 2tig + 1
              unsigned kh[4], kl[4];
              split<SPLIT>(k[0], kh[0], kl[0]);
              split<SPLIT>(k[2], kh[1], kl[1]);
              split<SPLIT>(k[1], kh[2], kl[2]);
              split<SPLIT>(k[3], kh[3], kl[3]);
#pragma unroll
              for (int o = 0; o < NO; ++o) {
                const float2 v2 = *reinterpret_cast<const float2*>(
                    vb + (8 * o + gid) * LDT + 8 * nn + 2 * tig);
                mma_step<SPLIT>(part[(hh + p) % NP][o], kh, kl, v2.x, v2.y);
              }
            }
          }
        }
        if constexpr (TCH > 1) {
#pragma unroll
          for (int o = 0; o < NO; ++o)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[o][e] += NP == 2 ? part[0][o][e] + part[1][o][e] : part[0][o][e];
        }
      }
      j0 = nj0;
      jlim = njlim;
    }
    cp_async_wait_all();  // nothing in flight (the Xi tile when nst = 0)
    __syncthreads();      // every thread is done with v_s

    if constexpr (TCH == 1) {
      // the four lanes of a row add their sums by a fixed tree, then the
      // warp of the first column half adds the second's (lanes tig 0 and 1
      // own rows r0 and r1)
      const float s0 = sum4(acc[0][0]), s1 = sum4(acc[0][1]);
      const int r = tig == 0 ? r0 : r1;
      const float v = tig == 0 ? s0 : s1;
      float* other = v_s;  // free after the barrier above
      if (half == 1 && tig < 2) other[r] = v;
      __syncthreads();
      if (half == 0 && tig < 2 && i0 + r < mlim)
        out[(size_t)(i0 + r) * t + c0] = v + other[r];
    } else {
#pragma unroll
      for (int o = 0; o < NO; ++o)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r0 : r1, c = 8 * o + 2 * tig + (e & 1);
          if (i0 + r < mlim && c < tcw) out[(size_t)(i0 + r) * t + c0 + c] = acc[o][e];
        }
    }
  }
}

template <typename T, int TCH, int DK, bool MULTI>
__global__ void __launch_bounds__(TcShape<TCH>::THREADS, TcShape<TCH>::BLOCKS)
kmvm_kernel(const T* __restrict__ Xi, const T* __restrict__ Xj,
            const T* __restrict__ V, const float* __restrict__ scal,
            const KSpec sp, float* __restrict__ out, int m, int n, int d,
            int t, int tiles_per_split) {
  const int ntiles = (n + BN - 1) / BN;
  const int b = min(ntiles, (int)blockIdx.y * tiles_per_split);
  const int e = min(ntiles, b + tiles_per_split);
  row_tile_tc<T, TCH, DK, MULTI, false>(
      Xi, Xj, V, scal, sp, out + (size_t)blockIdx.y * m * t, blockIdx.x * BM,
      m, d, t, DenseCols{b, e, n});
}

template <typename T, int TCH, int DK, bool MULTI>
__global__ void __launch_bounds__(TcShape<TCH>::THREADS, TcShape<TCH>::BLOCKS)
kmvm_acc_kernel(const T* __restrict__ Xi, const T* __restrict__ Xj,
                const T* __restrict__ V, const float* __restrict__ scal,
                const KSpec sp, float* __restrict__ acc, int m, int nc, int d,
                int t) {
  row_tile_tc<T, TCH, DK, MULTI, true>(
      Xi, Xj, V, scal, sp, acc, blockIdx.x * BM, m, d, t,
      DenseCols{0, (nc + BN - 1) / BN, nc});
}

// The splits' sum, one block per 64-row tile: out = the nsplit partial
// outputs of kmvm_kernel summed in split order (part may be out when
// nsplit = 1), and with DOTS (B2) the tile's CG partials [<Kv,v>, <r,v>,
// <r,r>, <v,v>] per column into dots[(4 tile + q) t + c]. Each thread takes
// its (row, column) elements of a 32-column chunk (at t = 1 one row each),
// rows in ascending order; at t = 1 a shuffle tree adds a warp's rows;
// then one thread per column adds the eight warps' partials in warp order.
// No atomics.
constexpr int SUM_NT = 256;
template <bool DOTS>
__global__ void __launch_bounds__(SUM_NT)
kmvm_split_sum(const float* part, int nsplit, const float* __restrict__ Vrow,
               const float* __restrict__ R, float* out,
               float* __restrict__ dots, int m, int t) {
  __shared__ float red[4][SUM_NT / 32][32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.x * BM;
  const int cw_max = t == 1 ? 1 : 32;  // columns per chunk
  const int rstep = SUM_NT / cw_max;   // rows apart of a thread's rows
  const size_t plane = (size_t)m * t;
  for (int c0 = 0; c0 < t; c0 += cw_max) {
    const int cw = min(cw_max, t - c0);
    const int c = tid % cw_max;
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (c < cw) {
      for (int r = tid / cw_max; r < BM && i0 + r < m; r += rstep) {
        const size_t idx = (size_t)(i0 + r) * t + c0 + c;
        float o = part[idx];
        for (int sp = 1; sp < nsplit; ++sp) o += part[sp * plane + idx];
        out[idx] = o;
        if constexpr (DOTS) {
          const float vr = Vrow[idx], rr = R[idx];
          q[0] = fmaf(o, vr, q[0]);
          q[1] = fmaf(rr, vr, q[1]);
          q[2] = fmaf(rr, rr, q[2]);
          q[3] = fmaf(vr, vr, q[3]);
        }
      }
    }
    if constexpr (DOTS) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (cw_max == 1) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            q[k] += __shfl_xor_sync(0xffffffffu, q[k], off);
        }
        if (lane < cw_max) red[k][warp][lane] = q[k];
      }
      __syncthreads();
      if (tid < 4 * cw) {
        const int k = tid / cw, cc = tid - k * cw;
        float sum = red[k][0][cc];
        for (int w = 1; w < SUM_NT / 32; ++w) sum += red[k][w][cc];
        dots[((size_t)blockIdx.x * 4 + k) * t + c0 + cc] = sum;
      }
      __syncthreads();  // before the next chunk rewrites red
    }
  }
}

// Every launch: the t-chunk (1, 16 or 128 columns of the RHS per pass) from
// t and the feature stages from d, then the kernel's shared memory.
template <typename T, int TCH, int DK, bool MULTI>
int launch_kmvm(const void* Xi, const void* Xj, const void* V,
                const float* scal, const KSpec& sp, float* out, int m, int n,
                int d, int t, int nsplit, int tiles_per_split,
                cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<TCH, DK>();
  cudaError_t err = cudaFuncSetAttribute(
      kmvm_kernel<T, TCH, DK, MULTI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + BM - 1) / BM, nsplit);
  constexpr int nth = TcShape<TCH>::THREADS;
  kmvm_kernel<T, TCH, DK, MULTI><<<grid, nth, smem, stream>>>(
      static_cast<const T*>(Xi), static_cast<const T*>(Xj),
      static_cast<const T*>(V), scal, sp, out, m, n, d, t, tiles_per_split);
  return (int)cudaGetLastError();
}

template <typename T, int TCH, int DK, bool MULTI>
int launch_kmvm_acc(const void* Xi, const void* Xj, const void* V,
                    const float* scal, const KSpec& sp, float* acc, int m,
                    int nc, int d, int t, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<TCH, DK>();
  cudaError_t err = cudaFuncSetAttribute(
      kmvm_acc_kernel<T, TCH, DK, MULTI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + BM - 1) / BM);
  constexpr int nth = TcShape<TCH>::THREADS;
  kmvm_acc_kernel<T, TCH, DK, MULTI><<<grid, nth, smem, stream>>>(
      static_cast<const T*>(Xi), static_cast<const T*>(Xj),
      static_cast<const T*>(V), scal, sp, acc, m, nc, d, t);
  return (int)cudaGetLastError();
}

// `return CALL(TCH, DK, MULTI);` for the t-chunk of t (1, 16 or 128 RHS
// columns per pass) and the feature stages of d: one stage of 4 (d <= 4:
// a k4 step), 12 (d <= 12: a k8 and a k4 step) or 16 (d <= 16: two k8
// steps) features, else stages of 16 (MULTI)
#define BY_T(DK, MULTI, CALL)                          \
  {                                                    \
    if ((t) == 1) return CALL(1, DK, MULTI);           \
    if ((t) <= 16) return CALL(16, DK, MULTI);         \
    return CALL(128, DK, MULTI);                       \
  }
#define BY_SHAPE_TC(d, t, CALL)         \
  if ((d) <= 4) BY_T(4, false, CALL)    \
  if ((d) <= 12) BY_T(12, false, CALL)  \
  if ((d) <= 16) BY_T(16, false, CALL)  \
  BY_T(16, true, CALL)

template <typename T>
int dispatch_kmvm(const void* Xi, const void* Xj, const void* V,
                  const float* scal, const KSpec& sp, float* out, int m, int n,
                  int d, int t, int nsplit, int tiles_per_split,
                  cudaStream_t s) {
#define CALL(TCH, DK, MULTI) launch_kmvm<T, TCH, DK, MULTI>(Xi, Xj, V, scal, sp, out, m, n, d, \
                                              t, nsplit, tiles_per_split, s)
  BY_SHAPE_TC(d, t, CALL)
#undef CALL
}

template <typename T>
int dispatch_kmvm_acc(const void* Xi, const void* Xj, const void* V,
                      const float* scal, const KSpec& sp, float* acc, int m,
                      int nc, int d, int t, cudaStream_t s) {
#define CALL(TCH, DK, MULTI) launch_kmvm_acc<T, TCH, DK, MULTI>(Xi, Xj, V, scal, sp, acc, m, nc, \
                                                  d, t, s)
  BY_SHAPE_TC(d, t, CALL)
#undef CALL
}

}  // namespace

extern "C" {

// dtype: 0 = float32 operands, 1 = bfloat16 operands. spec: host array of
// 1 + MAX_COMP + MAX_COMP * MAX_FAC ints (ncomp, factors per component,
// kind codes); scal: the L device scalars in scalar_layout order (L is
// checked by the wrapper; each block reads the scalars the spec names).
// Returns cudaGetLastError() of the launch (0 = launched).
// B1: with nsplit = 1 the kernel writes out; above, its splits go to part
// (nsplit, m, t) fp32 scratch and kmvm_split_sum sums them into out.
int kmvm_fwd(int dtype, const void* Xi, const void* Xj, const void* V,
             const float* scal, const int* spec, int L, float* part,
             float* out, int m, int n, int d, int t, int nsplit,
             int tiles_per_split, void* stream) {
  const KSpec sp = unpack_spec(spec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = nsplit > 1 ? part : out;
  const int err =
      dtype == 1 ? dispatch_kmvm<__nv_bfloat16>(Xi, Xj, V, scal, sp, dst, m, n,
                                                d, t, nsplit, tiles_per_split, s)
                 : dispatch_kmvm<float>(Xi, Xj, V, scal, sp, dst, m, n, d, t,
                                        nsplit, tiles_per_split, s);
  if (err != 0 || nsplit == 1) return err;
  kmvm_split_sum<false><<<(m + BM - 1) / BM, SUM_NT, 0, s>>>(
      part, nsplit, nullptr, nullptr, out, nullptr, m, t);
  return (int)cudaGetLastError();
}

// B2: B1's launch (part as kmvm_fwd's), then out (m, t) and dots
// (num_row_tiles, 4, t) fp32 from kmvm_split_sum.
int kmvm_dots_fwd(int dtype, const void* Xi, const void* Xj, const void* V,
                  const float* Vrow, const float* R, const float* scal,
                  const int* spec, int L, float* part, float* out, float* dots,
                  int m, int n, int d, int t, int nsplit, int tiles_per_split,
                  void* stream) {
  const KSpec sp = unpack_spec(spec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = nsplit > 1 ? part : out;
  const int err =
      dtype == 1 ? dispatch_kmvm<__nv_bfloat16>(Xi, Xj, V, scal, sp, dst, m, n,
                                                d, t, nsplit, tiles_per_split, s)
                 : dispatch_kmvm<float>(Xi, Xj, V, scal, sp, dst, m, n, d, t,
                                        nsplit, tiles_per_split, s);
  if (err != 0) return err;
  kmvm_split_sum<true><<<(m + BM - 1) / BM, SUM_NT, 0, s>>>(
      dst, nsplit, Vrow, R, out, dots, m, t);
  return (int)cudaGetLastError();
}

// acc (m, t) fp32 is read and written in place: acc += K(Xi, Xj) @ V over
// the nc columns of one chunk.
int kmvm_acc_fwd(int dtype, const void* Xi, const void* Xj, const void* V,
                 const float* scal, const int* spec, int L, float* acc, int m,
                 int nc, int d, int t, void* stream) {
  const KSpec sp = unpack_spec(spec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_kmvm_acc<__nv_bfloat16>(Xi, Xj, V, scal, sp, acc, m, nc, d,
                                            t, s);
  return dispatch_kmvm_acc<float>(Xi, Xj, V, scal, sp, acc, m, nc, d, t, s);
}

const char* kmvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
