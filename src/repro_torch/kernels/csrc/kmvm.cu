// Fused distance -> kernel-sum -> K @ V for NVIDIA Hopper (sm_90a).
//
// Replaces the three dense Pallas TPU kernels:
//   kmvm_kernel      <- src/repro/kernels/kmvm.py::kmvm_pallas       (_kmvm_kernel)
//   kmvm_dots_kernel <- src/repro/kernels/kmvm.py::kmvm_pallas_dots  (_kmvm_dots_kernel)
//   kmvm_acc_kernel  <- src/repro/kernels/kmvm.py::kmvm_pallas_chunk (_kmvm_acc_kernel)
// All share the tile body of `_kernel_tile` (kmvm.py:81):
//   d2 = max(|xi|^2 + |xj|^2 - 2 xi.xj, 0)             (fp32, norms from the
//                                                        operand-dtype values)
//   K  = sum_c w_c prod_f phi_cf(q_cf * d2)             (fp32 epilogue)
//   out[i, :] += K[i, j] * V[j, :]                      (fp32 accumulation)
// and kmvm_dots_kernel adds, once a block's row tile of K @ V is complete,
// the per-column partials [<Kv,v>, <r,v>, <r,r>, <v,v>] of that row tile,
// written to a (num_row_tiles, 4, t) buffer that the caller sums: no
// atomics, the same result on every run. kmvm_acc_kernel is one chunk step
// of the distributed engine's ring contraction: acc += K(Xi, Xj_chunk) @
// V_chunk with the (m, t) fp32 accumulator updated in place. One block owns
// one 64-row tile of acc, seeds its registers from it, walks every column
// tile of the chunk and writes the tile back, so no two blocks touch the
// same rows; it never splits the columns (a split would need partial
// buffers and would change the summation order). A walk over chunks of
// whole 64-column tiles therefore repeats, step for step, the register sum
// of one unsplit kmvm_kernel launch over the same columns, and gives its
// bits (at t > 1; at t = 1 the final 16-thread tree of each row regroups
// a walk of several chunks, and a single chunk gives the bits).
//
// Design. One thread block (256 threads) owns a BM = 64 row tile of the
// output and walks every column tile of Xj and V (BN = 64) in an in-block
// loop: this loop takes the place of the TPU's sequential `j` grid axis, so
// the output tile stays in registers for the whole reduction and the (m, n)
// kernel slab never reaches device memory. The tile body (the cp.async
// double buffer, the 4x4 micro-tile, the spec resolved per block and
// applied factor by factor, K @ V in registers at t = 1 and through the
// t-chunk layouts 16 / 128 above, fp32 or bf16 operands with fp32 math) is
// `row_tile` in kmvm_common.cuh, shared with the block-sparse kernel of
// kmvm_sparse.cu; its note says what bounds it and what the design does
// about that. kmvm_kernel may also split the column
// range over gridDim.y (each split writes its own partial output, which the
// caller sums), so that a short row range such as a 1024-row prediction
// chunk still fills the card.
//
// What bounds it. Per (i, j) pair the kernel does 2d operations for the
// cross term, the epilogue (a sqrt and an exp for the Matern kinds), and 2t
// for K @ V, against 67 TFLOP/s of fp32 outside the tensor cores; the bytes
// it must move, (m + n) d + n t + m t operands, are negligible next to
// that, so it is bound by operations (in practice by instruction issue).
// It runs on CUDA cores in IEEE fp32 (no TF32); a 3xTF32 wgmma tiling of
// the two products is left to a later change.

#include "kmvm_common.cuh"

namespace {

template <typename T, int TCH, int DK>
__global__ void __launch_bounds__(NT, min_blocks<TCH>())
kmvm_kernel(const T* __restrict__ Xi, const T* __restrict__ Xj,
            const T* __restrict__ V, const float* __restrict__ scal,
            const KSpec sp, float* __restrict__ out, int m, int n, int d,
            int t, int tiles_per_split) {
  const int ntiles = (n + BN - 1) / BN;
  const int b = min(ntiles, (int)blockIdx.y * tiles_per_split);
  const int e = min(ntiles, b + tiles_per_split);
  row_tile<T, TCH, DK, false>(Xi, Xj, V, nullptr, nullptr, scal, sp,
                              out + (size_t)blockIdx.y * m * t, nullptr,
                              blockIdx.x * BM, m, d, t, DenseCols{b, e, n});
}

template <typename T, int TCH, int DK>
__global__ void __launch_bounds__(NT, min_blocks<TCH>())
kmvm_dots_kernel(const T* __restrict__ Xi, const T* __restrict__ Xj,
                 const T* __restrict__ V, const float* __restrict__ Vrow,
                 const float* __restrict__ R, const float* __restrict__ scal,
                 const KSpec sp, float* __restrict__ out,
                 float* __restrict__ dots, int m, int n, int d, int t) {
  row_tile<T, TCH, DK, true>(Xi, Xj, V, Vrow, R, scal, sp, out,
                             dots + (size_t)blockIdx.x * 4 * t, blockIdx.x * BM,
                             m, d, t, DenseCols{0, (n + BN - 1) / BN, n});
}

template <typename T, int TCH, int DK>
__global__ void __launch_bounds__(NT, min_blocks<TCH>())
kmvm_acc_kernel(const T* __restrict__ Xi, const T* __restrict__ Xj,
                const T* __restrict__ V, const float* __restrict__ scal,
                const KSpec sp, float* __restrict__ acc, int m, int nc, int d,
                int t) {
  row_tile<T, TCH, DK, false, DenseCols, true>(
      Xi, Xj, V, nullptr, nullptr, scal, sp, acc, nullptr, blockIdx.x * BM, m,
      d, t, DenseCols{0, (nc + BN - 1) / BN, nc});
}

// Every launch: the t-chunk (1, 16 or 128 columns of the RHS per pass) from
// t and the feature stage (4 or 16) from d, then the kernel's shared memory.
template <typename T, int TCH, int DK>
int launch_kmvm(const void* Xi, const void* Xj, const void* V,
                const float* scal, const KSpec& sp, float* out, int m, int n,
                int d, int t, int nsplit, int tiles_per_split,
                cudaStream_t stream) {
  const size_t smem = smem_bytes<TCH, DK>();
  cudaError_t err = cudaFuncSetAttribute(
      kmvm_kernel<T, TCH, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + BM - 1) / BM, nsplit);
  kmvm_kernel<T, TCH, DK><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(Xi), static_cast<const T*>(Xj),
      static_cast<const T*>(V), scal, sp, out, m, n, d, t, tiles_per_split);
  return (int)cudaGetLastError();
}

template <typename T, int TCH, int DK>
int launch_kmvm_dots(const void* Xi, const void* Xj, const void* V,
                     const float* Vrow, const float* R, const float* scal,
                     const KSpec& sp, float* out, float* dots, int m, int n,
                     int d, int t, cudaStream_t stream) {
  const size_t smem = smem_bytes<TCH, DK>();
  cudaError_t err = cudaFuncSetAttribute(
      kmvm_dots_kernel<T, TCH, DK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + BM - 1) / BM);
  kmvm_dots_kernel<T, TCH, DK><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(Xi), static_cast<const T*>(Xj),
      static_cast<const T*>(V), Vrow, R, scal, sp, out, dots, m, n, d, t);
  return (int)cudaGetLastError();
}

template <typename T, int TCH, int DK>
int launch_kmvm_acc(const void* Xi, const void* Xj, const void* V,
                    const float* scal, const KSpec& sp, float* acc, int m,
                    int nc, int d, int t, cudaStream_t stream) {
  const size_t smem = smem_bytes<TCH, DK>();
  cudaError_t err = cudaFuncSetAttribute(
      kmvm_acc_kernel<T, TCH, DK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + BM - 1) / BM);
  kmvm_acc_kernel<T, TCH, DK><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(Xi), static_cast<const T*>(Xj),
      static_cast<const T*>(V), scal, sp, acc, m, nc, d, t);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_kmvm(const void* Xi, const void* Xj, const void* V,
                  const float* scal, const KSpec& sp, float* out, int m, int n,
                  int d, int t, int nsplit, int tiles_per_split,
                  cudaStream_t s) {
#define CALL(TCH, DK) launch_kmvm<T, TCH, DK>(Xi, Xj, V, scal, sp, out, m, n, d, \
                                              t, nsplit, tiles_per_split, s)
  BY_SHAPE(d, t, CALL)
#undef CALL
}

template <typename T>
int dispatch_kmvm_dots(const void* Xi, const void* Xj, const void* V,
                       const float* Vrow, const float* R, const float* scal,
                       const KSpec& sp, float* out, float* dots, int m, int n,
                       int d, int t, cudaStream_t s) {
#define CALL(TCH, DK) launch_kmvm_dots<T, TCH, DK>(Xi, Xj, V, Vrow, R, scal, sp, \
                                                   out, dots, m, n, d, t, s)
  BY_SHAPE(d, t, CALL)
#undef CALL
}

template <typename T>
int dispatch_kmvm_acc(const void* Xi, const void* Xj, const void* V,
                      const float* scal, const KSpec& sp, float* acc, int m,
                      int nc, int d, int t, cudaStream_t s) {
#define CALL(TCH, DK) launch_kmvm_acc<T, TCH, DK>(Xi, Xj, V, scal, sp, acc, m, nc, \
                                                  d, t, s)
  BY_SHAPE(d, t, CALL)
#undef CALL
}

}  // namespace

extern "C" {

// dtype: 0 = float32 operands, 1 = bfloat16 operands. spec: host array of
// 1 + MAX_COMP + MAX_COMP * MAX_FAC ints (ncomp, factors per component,
// kind codes); scal: the L device scalars in scalar_layout order (L is
// checked by the wrapper; each block reads the scalars the spec names).
// Returns cudaGetLastError() of the launch (0 = launched).
int kmvm_fwd(int dtype, const void* Xi, const void* Xj, const void* V,
             const float* scal, const int* spec, int L, float* out, int m,
             int n, int d, int t, int nsplit, int tiles_per_split,
             void* stream) {
  const KSpec sp = unpack_spec(spec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_kmvm<__nv_bfloat16>(Xi, Xj, V, scal, sp, out, m, n, d, t,
                                        nsplit, tiles_per_split, s);
  return dispatch_kmvm<float>(Xi, Xj, V, scal, sp, out, m, n, d, t, nsplit,
                              tiles_per_split, s);
}

int kmvm_dots_fwd(int dtype, const void* Xi, const void* Xj, const void* V,
                  const float* Vrow, const float* R, const float* scal,
                  const int* spec, int L, float* out, float* dots, int m,
                  int n, int d, int t, void* stream) {
  const KSpec sp = unpack_spec(spec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_kmvm_dots<__nv_bfloat16>(Xi, Xj, V, Vrow, R, scal, sp,
                                             out, dots, m, n, d, t, s);
  return dispatch_kmvm_dots<float>(Xi, Xj, V, Vrow, R, scal, sp, out, dots, m,
                                   n, d, t, s);
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
