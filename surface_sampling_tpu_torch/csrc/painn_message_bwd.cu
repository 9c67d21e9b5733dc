// Backward of the general PaiNN message block (painn_message_fused), batched
// over chains C and ensemble members K: the cotangents of every input given
// the cotangents g_ds (C, K, n_pad, F) and g_dv (C, K, n_pad, 3F).
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py, _message_bwd_pallas
// (kernel _msg_bwd_kernel), the custom-VJP backward of painn_message_fused.
// The kernels, their design and their bound are in painn_message_bwd.cuh;
// here the neighbour of edge e is row nbr[e] of the (C, K, n_pad, 3F)
// tables, and the reverse table (C, n_pad, D) lists each slot's incoming
// edges. A dead edge (envm == 0) gets exact zeros in g_rbf, g_envm and
// g_unit (the header's dead-edge contract).

#include "painn_message_bwd.cuh"

extern "C" int painn_message_bwd(
    const float* phi, const float* vcat, const float* rbf, const float* envm,
    const int* nbr, const float* unit, const float* dw, const float* db,
    const float* gds, const float* gdv, const int* rev, float* g_phi,
    float* g_vcat, float* g_rbf, float* g_envm, float* g_unit, float* gdw_part,
    int C, int K, int n_pad, int M, int R, int F, int D, int want_dw,
    cudaStream_t stream) {
  const msgbwd::Layout L{n_pad, /*n_tab=*/n_pad, M, F, /*ws=*/nullptr, 0, 0};
  return msgbwd::backward(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv, rev,
                          g_phi, g_vcat, g_rbf, g_envm, g_unit, gdw_part, C, K, R,
                          L, D, want_dw, stream);
}

// Bytes of dynamic shared memory that a centre block (neighbour = 0) or a
// neighbour block of the launch above takes; 0 for an R it does not take.
extern "C" int painn_message_bwd_smem(int R, int M, int D, int want_dw, int neighbour) {
  return int(msgbwd::smem_bytes(R, M, D, want_dw != 0, neighbour != 0));
}
