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

__device__ int work[2];   // the work list's counters (chgconv::WorkList)
using chgconv::FWD_BLOCKS_PER_SM;
using chgconv::FWD_WARPS;

template <int MAXM>
__global__ void __launch_bounds__(FWD_WARPS * 32, FWD_BLOCKS_PER_SM)
conv_kernel(const float* __restrict__ ai2, const float* __restrict__ aj2,
            const float* __restrict__ be, const float* __restrict__ bw,
            const float* __restrict__ maskf, const int* __restrict__ nbr, chgconv::Weights W,
            float* __restrict__ agg, int C, int n_pad, int M) {
  chgconv::forward<MAXM>(ai2, aj2, n_pad, be, bw, maskf, nbr, W, agg, n_pad, M, work, C * n_pad,
                         chgconv::DirectRowsOf{});
}

template <int MAXM>
cudaError_t launch(const float* ai2, const float* aj2, const float* be, const float* bw,
                   const float* maskf, const int* nbr, const chgconv::Weights& W, float* agg,
                   int C, int n_pad, int M, int n_sm, cudaStream_t stream) {
  const size_t smem = chgconv::forward_smem_bytes<MAXM>(M);
  const cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<MAXM>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int grid = chgconv::grid_blocks(n_sm, FWD_BLOCKS_PER_SM, (long long)C * n_pad);
  conv_kernel<MAXM><<<grid, FWD_WARPS * 32, smem, stream>>>(ai2, aj2, be, bw, maskf, nbr, W,
                                                             agg, C, n_pad, M);
  return cudaGetLastError();
}

template <int MAXM>
int blocks_per_sm(int M) {
  const int smem = int(chgconv::forward_smem_bytes<MAXM>(M));
  int n = -1;
  cudaError_t err =
      cudaFuncSetAttribute(conv_kernel<MAXM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_kernel<MAXM>, FWD_WARPS * 32,
                                                        smem);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// n_sm: the card's SMs (the grid is about n_sm x FWD_BLOCKS_PER_SM). M picks
// the instantiation (chgconv::capacity_for).
extern "C" int chgnet_conv(const float* ai2, const float* aj2, const float* be, const float* bw,
                           const float* maskf, const int* nbr, const float* w2, const float* wc1,
                           const float* wg1, const float* bc1, const float* bg1,
                           const float* lnc, const float* lng, float* agg, int C, int n_pad,
                           int M, int F, int n_sm, cudaStream_t stream) {
  if (F != chgconv::F || n_sm < 1) return int(cudaErrorInvalidValue);
  const chgconv::Weights W{w2, wc1, wg1, bc1, bg1, lnc, lng};
  switch (chgconv::capacity_for(M)) {
    case chgconv::SMALL_M:
      return int(launch<chgconv::SMALL_M>(ai2, aj2, be, bw, maskf, nbr, W, agg, C, n_pad, M,
                                          n_sm, stream));
    case chgconv::MAX_M:
      return int(launch<chgconv::MAX_M>(ai2, aj2, be, bw, maskf, nbr, W, agg, C, n_pad, M, n_sm,
                                        stream));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// Blocks of the kernel an SM holds at M slots, as its registers and shared
// memory allow (the grid counts on FWD_BLOCKS_PER_SM); -1 on an error.
extern "C" int chgnet_conv_blocks_per_sm(int M) {
  switch (chgconv::capacity_for(M)) {
    case chgconv::SMALL_M: return blocks_per_sm<chgconv::SMALL_M>(M);
    case chgconv::MAX_M: return blocks_per_sm<chgconv::MAX_M>(M);
    default: return -1;
  }
}
