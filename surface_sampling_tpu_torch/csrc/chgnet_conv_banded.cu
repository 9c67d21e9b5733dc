// The CHGNet atom conv of a supercell (row 11 of PERF.md's kernel table),
// batched over chains C: rows in the routing band's sorted order, aj2
// extended by the band's halo (C, n_pad + halo, 2F), nbr carrying sorted
// ranks. Forward only, as on the TPU (the rigid MC path).
//
// Replaces: surface_sampling_tpu/ops/pallas_chgnet.py,
// chgnet_conv_fused_banded (kernel _conv_kernel_banded). The TPU kernel
// shrinks its one-hot routing products from n_pad to W columns; here rows
// are loaded by index, so the band is addressing only: for sorted centre
// i, s = win_start[i / n_blk], and the neighbour of rank r is row
// s + ((r - s) mod n_pad) of the extended table, or zeros outside
// [s, s + W) (painn_band.cuh). The math, the bound and the design are in
// chgnet_conv.cuh, whose forward row 10 shares.

#include "chgnet_conv.cuh"

namespace {

__device__ int work[2];   // the work list's counters (chgconv::WorkList)
using chgconv::FWD_BLOCKS_PER_SM;
using chgconv::FWD_WARPS;

template <int MAXM>
__global__ void __launch_bounds__(FWD_WARPS * 32, FWD_BLOCKS_PER_SM)
conv_banded_kernel(const float* __restrict__ ai2, const float* __restrict__ aj2_ext,
                   const float* __restrict__ be, const float* __restrict__ bw,
                   const float* __restrict__ maskf, const int* __restrict__ nbr,
                   chgconv::Weights W, const int* __restrict__ win_start,
                   float* __restrict__ agg, int C, int n_pad, int n_ext, int M, int n_blk,
                   int window) {
  chgconv::forward<MAXM>(ai2, aj2_ext, n_ext, be, bw, maskf, nbr, W, agg, n_pad, M, work,
                         C * n_pad, chgconv::BandRowsOf{win_start, n_blk, n_pad, window});
}

template <int MAXM>
cudaError_t launch(const float* ai2, const float* aj2_ext, const float* be, const float* bw,
                   const float* maskf, const int* nbr, const chgconv::Weights& W,
                   const int* win_start, float* agg, int C, int n_pad, int n_ext, int M,
                   int n_sm, int n_blk, int window, cudaStream_t stream) {
  const size_t smem = chgconv::forward_smem_bytes<MAXM>(M);
  const cudaError_t err = cudaFuncSetAttribute(
      conv_banded_kernel<MAXM>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int grid = chgconv::grid_blocks(n_sm, FWD_BLOCKS_PER_SM, (long long)C * n_pad);
  conv_banded_kernel<MAXM><<<grid, FWD_WARPS * 32, smem, stream>>>(
      ai2, aj2_ext, be, bw, maskf, nbr, W, win_start, agg, C, n_pad, n_ext, M, n_blk, window);
  return cudaGetLastError();
}

template <int MAXM>
int blocks_per_sm(int M) {
  const int smem = int(chgconv::forward_smem_bytes<MAXM>(M));
  int n = -1;
  cudaError_t err = cudaFuncSetAttribute(conv_banded_kernel<MAXM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_banded_kernel<MAXM>,
                                                        FWD_WARPS * 32, smem);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// n_sm: the card's SMs (the grid is about n_sm x FWD_BLOCKS_PER_SM). M picks
// the instantiation (chgconv::capacity_for).
extern "C" int chgnet_conv_banded(const float* ai2, const float* aj2_ext, const float* be,
                                  const float* bw, const float* maskf, const int* nbr,
                                  const float* w2, const float* wc1, const float* wg1,
                                  const float* bc1, const float* bg1, const float* lnc,
                                  const float* lng, const int* win_start, float* agg, int C,
                                  int n_pad, int n_ext, int M, int F, int n_sm, int n_blk,
                                  int window, cudaStream_t stream) {
  if (F != chgconv::F || n_sm < 1 || n_blk < 1) return int(cudaErrorInvalidValue);
  const chgconv::Weights W{w2, wc1, wg1, bc1, bg1, lnc, lng};
  switch (chgconv::capacity_for(M)) {
    case chgconv::SMALL_M:
      return int(launch<chgconv::SMALL_M>(ai2, aj2_ext, be, bw, maskf, nbr, W, win_start, agg,
                                          C, n_pad, n_ext, M, n_sm, n_blk, window, stream));
    case chgconv::MAX_M:
      return int(launch<chgconv::MAX_M>(ai2, aj2_ext, be, bw, maskf, nbr, W, win_start, agg, C,
                                        n_pad, n_ext, M, n_sm, n_blk, window, stream));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// Blocks of the kernel an SM holds at M slots, as its registers and shared
// memory allow (the grid counts on FWD_BLOCKS_PER_SM); -1 on an error.
extern "C" int chgnet_conv_banded_blocks_per_sm(int M) {
  switch (chgconv::capacity_for(M)) {
    case chgconv::SMALL_M: return blocks_per_sm<chgconv::SMALL_M>(M);
    case chgconv::MAX_M: return blocks_per_sm<chgconv::MAX_M>(M);
    default: return -1;
  }
}
