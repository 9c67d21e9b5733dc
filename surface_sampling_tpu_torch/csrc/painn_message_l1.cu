// Layer-1 PaiNN message for the rigid MC path, batched over chains C and
// ensemble members K.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py, painn_message_l1
// (kernel _msg_kernel_l1). The TPU kernel routes the species one-hot of
// every neighbour through one-hot MXU matmuls because TPU gathers
// serialize; here a neighbour's species is read by index.
//
// Per edge e = (i, m), neighbour j = nbr[e], for channel f of F:
//     w_s = (rbf[e] . dw2[:, f]     + db2[f])     * envm[e]
//     w_u = (rbf[e] . dw2[:, F + f] + db2[F + f]) * envm[e]
//     ds[i, f]      += philt[species[j], f]     * w_s
//     dv[i, x*F+f]  += philt[species[j], F + f] * w_u * unit[x, i, m]
//
// This is the banded layer-1 message on an identity band: every window
// starts at row 0 and is n_pad wide, the species table carries no halo, so
// every neighbour index is read as it is. The body is l1binned::message
// (painn_message_l1_binned.cuh, which holds the design and the bound): a
// block per n_blk centres and chain, each centre's live edges (envm != 0;
// a dead edge's rbf, unit vector and neighbour index are never read)
// binned by neighbour species once for all members, then a thread per
// (member, channel) multiplying the bins of the species present, in
// ascending order, by its filter columns. So a centre gets bitwise what
// painn_message_l1_banded gives it on an identity band, and launches
// repeat bitwise.

#include "painn_message_l1_binned.cuh"

namespace {

// Centres a block: 8 (of 16, 8, 4 and 2 at the flagship's 1x1 shape, C =
// 128: 8 and 4 tie, 16 and 2 are slower), halved while it does not divide
// n_pad. A centre's bits do not depend on it.
int centres_a_block(int n_pad) {
  int n_blk = 8;
  while (n_pad % n_blk) n_blk >>= 1;
  return n_blk;
}

}  // namespace

// Launches the kernel for a radial width R of 8, 16 or 24 and at most 32
// species rows, and returns cudaGetLastError() (a refused launch never
// runs).
extern "C" int painn_message_l1(
    const int* species, const float* philt, const float* rbf, const float* envm,
    const int* nbr, const float* unit, const float* dw2, const float* db2,
    float* ds, float* dv, int C, int K, int n_pad, int M, int R, int F, int T1,
    cudaStream_t stream) {
  return l1binned::message(species, philt, rbf, envm, nbr, unit, dw2, db2, /*ws=*/nullptr, ds,
                           dv, C, K, n_pad, /*n_ext=*/n_pad, M, R, F, T1,
                           centres_a_block(n_pad), /*W=*/n_pad, stream);
}

// Centres a block of a launch at n_pad rows, and the bytes of dynamic
// shared memory the block takes, for chip_smoke.py.
extern "C" int painn_message_l1_n_blk(int n_pad) { return centres_a_block(n_pad); }
extern "C" int painn_message_l1_smem(int R, int n_pad, int T1) {
  return int(l1binned::smem_bytes(R, centres_a_block(n_pad), T1));
}
