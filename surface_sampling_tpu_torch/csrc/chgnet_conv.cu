// The CHGNet atom conv (row 10 of PERF.md's kernel table), batched over
// chains C: agg (C, n_pad, F) from ai2 / aj2 (C, n_pad, 2F), be / bw
// (C, E, F), maskf (C, E) and nbr (C, E), E = n_pad * M.
//
// Replaces: surface_sampling_tpu/ops/pallas_chgnet.py, chgnet_conv_fused
// -> _conv_pallas (kernel _conv_kernel). The math, the bound and the
// design are in chgnet_conv.cuh; here each edge's neighbour is row nbr[e]
// of the chain's aj2 table.

#include "chgnet_conv.cuh"

namespace {

__global__ void __launch_bounds__(chgconv::NT, 2)
conv_kernel(const float* __restrict__ ai2, const float* __restrict__ aj2,
            const float* __restrict__ be, const float* __restrict__ bw,
            const float* __restrict__ maskf, const int* __restrict__ nbr, chgconv::Weights W,
            float* __restrict__ agg, int n_pad, int M, int cpb) {
  const float* aj2c = aj2 + size_t(blockIdx.y) * n_pad * chgconv::F2;
  chgconv::forward(ai2, aj2c, be, bw, maskf, nbr, W, agg, n_pad, M, cpb,
                   chgconv::DirectRowsOf{});
}

}  // namespace

extern "C" int chgnet_conv(const float* ai2, const float* aj2, const float* be, const float* bw,
                           const float* maskf, const int* nbr, const float* w2, const float* wc1,
                           const float* wg1, const float* bc1, const float* bg1,
                           const float* lnc, const float* lng, float* agg, int C, int n_pad,
                           int M, int F, int cpb, cudaStream_t stream) {
  if (F != chgconv::F || cpb < 1) return int(cudaErrorInvalidValue);
  const size_t smem = chgconv::smem_bytes(false);
  cudaError_t err =
      cudaFuncSetAttribute(conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n_pad + cpb - 1) / cpb, C);
  conv_kernel<<<grid, chgconv::NT, smem, stream>>>(
      ai2, aj2, be, bw, maskf, nbr, chgconv::Weights{w2, wc1, wg1, bc1, bg1, lnc, lng}, agg,
      n_pad, M, cpb);
  return int(cudaGetLastError());
}
