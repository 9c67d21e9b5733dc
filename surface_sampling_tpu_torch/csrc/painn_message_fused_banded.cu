// Banded general PaiNN message (layers 2+ of the supercell rigid trunk,
// every layer of the delta engine's full evaluation), batched over chains
// C and ensemble members K. Its backward, for the forces of a relaxed
// supercell, is painn_message_bwd_banded.cu.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py,
// painn_message_fused_banded -> _message_pallas_banded (kernel
// _msg_kernel_banded). The kernel, its design and its bound are in
// painn_message_banded.cuh: one block per (band block of n_blk sorted
// centres, chain) over all n_pad centres, the members inside the block, all
// chains sharing the band's window starts.

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

// Bytes of dynamic shared memory that a block of this launch (and of
// painn_message_subset's) takes at these sizes; 0 for an R it does not take.
extern "C" int painn_message_banded_smem(int R, int M, int n_blk) {
  return int(banded::smem_bytes(R, M, n_blk));
}
