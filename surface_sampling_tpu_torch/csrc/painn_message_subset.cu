// Subset-grid banded PaiNN message: the delta engine's hot op
// (core/incremental.py), batched over chains C and ensemble members K,
// forward only.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py, painn_message_subset
// (kernel _msg_kernel_banded over a grid of NB selected blocks). Each
// chain has moved its own site, so each chain has its own NB blocks: the
// edge geometry arrives gathered in compact block order per chain
// (rbf_sel (C, NB*n_blk*M, R), unit_sel (C, 3, NB*n_blk, M)) with the
// blocks' window starts ws_sel (C, NB), while phi_ext and vcat_ext stay the
// full sorted, halo-extended tables (C, K, n_pad + halo, 3F). Outputs are
// compact, (C, K, NB*n_blk, F) and (C, K, NB*n_blk, 3F). The kernel, its
// design and its bound are in painn_message_banded.cuh: one block per
// (selected block, chain), the members inside the block. A centre gets the
// same bits here as in painn_message_fused_banded.cu: its sums run over its
// own live edges only, in one fixed order.

#include "painn_message_banded.cuh"

extern "C" int painn_message_subset(
    const float* phi_ext, const float* vcat_ext, const float* rbf_sel,
    const float* envm_sel, const int* nbr_sel, const float* unit_sel,
    const float* dw, const float* db, const int* ws_sel, float* ds, float* dv,
    int C, int K, int n_rows, int n_pad, int n_ext, int M, int R, int F,
    int n_blk, int W, cudaStream_t stream) {
  return banded::message(phi_ext, vcat_ext, rbf_sel, envm_sel, nbr_sel,
                         unit_sel, dw, db, ws_sel, ds, dv, C, K, n_rows, n_pad,
                         n_ext, M, R, F, n_blk, W,
                         /*ws_stride=*/n_rows / n_blk, stream);
}
