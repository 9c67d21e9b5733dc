// Variant of row 6 for tools/port_profile.py --variants (l1_edges): the
// banded layer-1 message as the layer-1 form of row 7's body
// (painn_message_banded_l1.cuh in this directory): live edges only, the
// radial filter as 3xTF32 mma.sync tiles per edge, warps owning (member,
// 16-channel) slices. Measured against the species-binned kernel that
// replaced it (csrc/painn_message_l1_banded.cu, PERF.md, PR 12).

#include "painn_message_banded_l1.cuh"

extern "C" int painn_message_l1_banded(
    const int* species_ext, const float* philt, const float* rbf,
    const float* envm, const int* nbr, const float* unit, const float* dw2,
    const float* db2, const int* win_start, float* ds, float* dv, int C, int K,
    int n_pad, int n_ext, int M, int R, int F, int T1, int n_blk, int W,
    cudaStream_t stream) {
  if (F % banded::SL != 0 || n_pad % n_blk != 0) return int(cudaErrorInvalidValue);
  switch (R) {
    case 8: return int(banded::launch_l1<8>(species_ext, philt, rbf, envm, nbr, unit, dw2, db2, win_start, ds, dv, C, K, n_pad, n_ext, M, F, T1, n_blk, W, stream));
    case 16: return int(banded::launch_l1<16>(species_ext, philt, rbf, envm, nbr, unit, dw2, db2, win_start, ds, dv, C, K, n_pad, n_ext, M, F, T1, n_blk, W, stream));
    case 24: return int(banded::launch_l1<24>(species_ext, philt, rbf, envm, nbr, unit, dw2, db2, win_start, ds, dv, C, K, n_pad, n_ext, M, F, T1, n_blk, W, stream));
    default: return int(cudaErrorInvalidValue);
  }
}
