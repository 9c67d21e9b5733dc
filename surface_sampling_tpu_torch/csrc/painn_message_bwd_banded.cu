// Backward of the banded general PaiNN message block
// (painn_message_fused_banded), batched over chains C and ensemble members K:
// the forces of a relaxed supercell.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py,
// _message_bwd_pallas_banded (kernel _msg_bwd_kernel_banded), the custom-VJP
// backward of painn_message_fused_banded. The TPU kernel recomputes the
// forward over each block's W-wide window through one-hot products and
// accumulates g_phi / g_vcat into window slices of pinned outputs across its
// sequential grid. Here the band is only addressing: the kernels of
// painn_message_bwd.cuh run with the tables extended by the halo
// (n_pad + halo rows), the centre kernel reading the neighbour of rank r
// from row s + ((r - s) mod n_pad) for the window start s = win_start[i /
// n_blk] of its block, and the neighbour kernel gathering each extended
// row's cotangents over a reverse table keyed by extended row
// (ops/banding.banded_reverse_table). The caller folds a halo row's
// cotangents onto its slot (the backward of the concatenation that built the
// halo). No float atomics: results repeat bitwise. A dead edge (envm == 0)
// gets exact zeros in g_rbf, g_envm and g_unit, as in painn_message_bwd.cu.

#include "painn_message_bwd.cuh"

extern "C" int painn_message_bwd_banded(
    const float* phi_ext, const float* vcat_ext, const float* rbf,
    const float* envm, const int* nbr, const float* unit, const float* dw,
    const float* db, const float* gds, const float* gdv, const int* win_start,
    const int* rev, float* g_phi_ext, float* g_vcat_ext, float* g_rbf,
    float* g_envm, float* g_unit, float* gdw_part, int C, int K, int n_pad,
    int n_ext, int M, int R, int F, int D, int n_blk, int W, int want_dw,
    cudaStream_t stream) {
  const msgbwd::Layout L{n_pad, n_ext, M, F, win_start, n_blk, W};
  return msgbwd::backward(phi_ext, vcat_ext, rbf, envm, nbr, unit, dw, db, gds,
                          gdv, rev, g_phi_ext, g_vcat_ext, g_rbf, g_envm, g_unit,
                          gdw_part, C, K, R, L, D, want_dw, stream);
}
