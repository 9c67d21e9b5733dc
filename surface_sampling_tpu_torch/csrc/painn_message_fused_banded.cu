// Banded general PaiNN message (layers 2+ of the supercell rigid trunk,
// every layer of the delta engine's full evaluation), batched over chains
// C and ensemble members K. Its backward, for the forces of a relaxed
// supercell, is painn_message_bwd_banded.cu.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py,
// painn_message_fused_banded -> _message_pallas_banded (kernel
// _msg_kernel_banded). The kernel and its bound are in
// painn_message_banded.cuh: one block per (sorted centre, member, chain)
// over all n_pad centres, all chains sharing the band's window starts.

#include "painn_message_banded.cuh"

extern "C" int painn_message_fused_banded(
    const float* phi_ext, const float* vcat_ext, const float* rbf,
    const float* envm, const int* nbr, const float* unit, const float* dw,
    const float* db, const int* win_start, float* ds, float* dv, int C, int K,
    int n_pad, int n_ext, int M, int R, int F, int n_blk, int W,
    cudaStream_t stream) {
  return banded::message(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db,
                         win_start, ds, dv, C, K, /*n_rows=*/n_pad, n_pad,
                         n_ext, M, R, F, n_blk, W, /*ws_stride=*/0, stream);
}
