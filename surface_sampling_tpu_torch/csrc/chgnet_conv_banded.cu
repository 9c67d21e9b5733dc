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
// chgnet_conv.cuh, which row 10 shares.

#include "chgnet_conv.cuh"

namespace {

__global__ void __launch_bounds__(chgconv::NT, 2)
conv_banded_kernel(const float* __restrict__ ai2, const float* __restrict__ aj2_ext,
                   const float* __restrict__ be, const float* __restrict__ bw,
                   const float* __restrict__ maskf, const int* __restrict__ nbr,
                   chgconv::Weights W, const int* __restrict__ win_start,
                   float* __restrict__ agg, int n_pad, int n_ext, int M, int cpb, int n_blk,
                   int window) {
  const float* aj2c = aj2_ext + size_t(blockIdx.y) * n_ext * chgconv::F2;
  chgconv::forward(ai2, aj2c, be, bw, maskf, nbr, W, agg, n_pad, M, cpb,
                   chgconv::BandRowsOf{win_start, n_blk, n_pad, window});
}

}  // namespace

extern "C" int chgnet_conv_banded(const float* ai2, const float* aj2_ext, const float* be,
                                  const float* bw, const float* maskf, const int* nbr,
                                  const float* w2, const float* wc1, const float* wg1,
                                  const float* bc1, const float* bg1, const float* lnc,
                                  const float* lng, const int* win_start, float* agg, int C,
                                  int n_pad, int n_ext, int M, int F, int cpb, int n_blk,
                                  int window, cudaStream_t stream) {
  if (F != chgconv::F || cpb < 1 || n_blk < 1) return int(cudaErrorInvalidValue);
  const size_t smem = chgconv::smem_bytes(false);
  cudaError_t err = cudaFuncSetAttribute(conv_banded_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n_pad + cpb - 1) / cpb, C);
  conv_banded_kernel<<<grid, chgconv::NT, smem, stream>>>(
      ai2, aj2_ext, be, bw, maskf, nbr, chgconv::Weights{w2, wc1, wg1, bc1, bg1, lnc, lng},
      win_start, agg, n_pad, n_ext, M, cpb, n_blk, window);
  return int(cudaGetLastError());
}
