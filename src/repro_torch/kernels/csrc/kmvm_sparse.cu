// Block-sparse fused distance -> kernel-sum -> K @ V for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of the sparse backend:
//   kmvm_bs_kernel <- src/repro/sparse/kmvm_sparse.py::kmvm_blocksparse_pallas
//                     (_bs_kernel)
// It computes, over a sparsity plan of `tile`-row tiles of Morton-sorted
// points (repro_torch.sparse.plan):
//   out[rows of tile r] = sum_{(r, c) active} K_fused(Xs_r, Xs_c) @ Vs_c
// with the fused kernel sum and the fp32/bf16 policy of the dense kernels
// (the tile body `row_tile` of kmvm_common.cuh, so the seven kinds and the
// epilogue live in one place).
//
// Design. The TPU kernel's grid is the sorted active-pair list: one grid
// step per pair, the output tile resident in VMEM across the consecutive
// steps of its row. On Hopper the blocks run in no order, so the pair list
// is turned into CSR row offsets (row_ptr) and one block owns a (row tile,
// 64-row sub-tile): it walks its row's active column tiles in ascending
// order, 64 columns at a time, in the in-block loop of `row_tile`, keeping
// the output in registers, and writes its rows once. No atomics and no
// cross-block sums: the same result on every run, and a column tile whose
// entries are all zero adds exactly nothing, so a row's result does not
// depend on how many such tiles its list holds. Rows and columns may be
// different point sets with different tile sizes (Xi in rtile-row tiles, Xj
// in ctile-row tiles): the training MVM passes the sorted points twice with
// the plan's tile; the prediction-time cross-covariance passes a query
// chunk in 64-row tiles against the training tiles its bounding box
// reaches. Any tile size works (a tile that is not a multiple of 64 masks
// the ragged sub-tile and column chunk), any m and n (last tiles may be
// ragged; nothing is padded in device memory), any t >= 1 (t-chunk layouts
// 1, 16 and 128; t is not padded to 128 lanes).
//
// Schedule. Row tiles differ in degree (at n = 2^18 the spatial plan's
// rows hold 144 pairs on average and 614 at most), and the blocks of the
// dense clusters, which have the longest rows, would otherwise launch in
// Morton order, some of them in the last wave. The wrapper passes the row
// tiles in descending degree (stable), computed once per plan, and block
// b takes row tile order[b / subtiles]: the long rows start first and the
// short ones fill the tail. Each block's work and summation order are
// those of the identity schedule, so the order changes no bits. A long row
// is still one block's loop (not split across blocks).

// What bounds it. Per active (i, j) entry: 2d operations for the cross
// term, the epilogue, and 2t for K @ V on fp32 CUDA cores; the bytes (each
// point's features and RHS row once, the output once) are negligible next
// to that, so it is bound by operations, as the dense kernels are. The
// work is the plan's active entries (pairs x tile^2), not n^2.

#include "kmvm_common.cuh"

namespace {

// Column walker over the active column tiles [p0, p0 + npairs) of `cols`:
// chunk k is sub-chunk k % cpt of pair k / cpt, masked at the tile's end
// and at n.
struct PairCols {
  const int* __restrict__ cols;
  int p0, npairs, tile, cpt, n;
  __device__ __forceinline__ int count() const { return npairs * cpt; }
  __device__ __forceinline__ void chunk(int k, int& j0, int& jlim) const {
    const int p = k / cpt;
    const int c0 = cols[p0 + p] * tile;
    j0 = c0 + (k - p * cpt) * BN;
    jlim = min(c0 + tile, n);
  }
};

template <typename T, int TCH, int DK>
__global__ void __launch_bounds__(NT, min_blocks<TCH>())
kmvm_bs_kernel(const T* __restrict__ Xi, const T* __restrict__ Xj,
               const T* __restrict__ V, const float* __restrict__ scal,
               const KSpec sp, const int* __restrict__ row_ptr,
               const int* __restrict__ cols, const int* __restrict__ order,
               float* __restrict__ out, int m, int n, int d, int t, int rtile,
               int ctile, int subtiles) {
  const int slot = blockIdx.x / subtiles;
  const int r = order != nullptr ? order[slot] : slot;
  const int i0 = r * rtile + (blockIdx.x - slot * subtiles) * BM;
  const int mlim = min(r * rtile + rtile, m);
  if (i0 >= mlim) return;  // the ragged last tile has fewer sub-tiles
  const int p0 = row_ptr[r];
  const PairCols pc{cols, p0, row_ptr[r + 1] - p0, ctile,
                    (ctile + BN - 1) / BN, n};
  row_tile<T, TCH, DK>(Xi, Xj, V, scal, sp, out, i0, mlim, d, t, pc);
}

template <typename T, int TCH, int DK>
int launch_bs(const void* Xi, const void* Xj, const void* V,
              const float* scal, const KSpec& sp, const int* row_ptr,
              const int* cols, const int* order, float* out, int num_row_tiles,
              int m, int n, int d, int t, int rtile, int ctile,
              cudaStream_t stream) {
  const size_t smem = smem_bytes<TCH, DK>();
  cudaError_t err = cudaFuncSetAttribute(
      kmvm_bs_kernel<T, TCH, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int subtiles = (rtile + BM - 1) / BM;
  const dim3 grid((unsigned)num_row_tiles * subtiles);
  kmvm_bs_kernel<T, TCH, DK><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(Xi), static_cast<const T*>(Xj),
      static_cast<const T*>(V), scal, sp, row_ptr, cols, order, out, m, n, d,
      t, rtile, ctile, subtiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bs(const void* Xi, const void* Xj, const void* V,
                const float* scal, const KSpec& sp, const int* row_ptr,
                const int* cols, const int* order, float* out,
                int num_row_tiles, int m, int n, int d, int t, int rtile,
                int ctile, cudaStream_t s) {
#define CALL(TCH, DK) launch_bs<T, TCH, DK>(Xi, Xj, V, scal, sp, row_ptr, cols, \
                                            order, out, num_row_tiles, m, n, d, \
                                            t, rtile, ctile, s)
  BY_SHAPE(d, t, CALL)
#undef CALL
}

}  // namespace

extern "C" {

// dtype: 0 = float32 operands, 1 = bfloat16. spec: host array of
// 1 + MAX_COMP + MAX_COMP * MAX_FAC ints (as kmvm_fwd). Rows Xi (m, d) in
// num_row_tiles tiles of rtile rows; columns Xj (n, d) and V (n, t) in
// tiles of ctile rows. row_ptr: device (num_row_tiles + 1) int32 CSR offsets
// into cols, the active column tiles of each row tile in ascending order.
// order: device (num_row_tiles,) int32, the row tiles in launch order (the
// longest rows first), or null for the plan's order. out (m, t) fp32.
// Everything row-major on the device. Returns cudaGetLastError() of the
// launch (0 = launched).
int kmvm_bs_fwd(int dtype, const void* Xi, const void* Xj, const void* V,
                const float* scal, const int* spec, int L, const int* row_ptr,
                const int* cols, const int* order, float* out,
                int num_row_tiles, int m, int n, int d, int t, int rtile,
                int ctile, void* stream) {
  const KSpec sp = unpack_spec(spec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_bs<__nv_bfloat16>(Xi, Xj, V, scal, sp, row_ptr, cols,
                                      order, out, num_row_tiles, m, n, d, t,
                                      rtile, ctile, s);
  return dispatch_bs<float>(Xi, Xj, V, scal, sp, row_ptr, cols, order, out,
                            num_row_tiles, m, n, d, t, rtile, ctile, s);
}

const char* kmvm_bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
