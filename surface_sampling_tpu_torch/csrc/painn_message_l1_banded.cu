// Banded layer-1 PaiNN message for the supercell rigid trunk, batched over
// chains C and ensemble members K.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py,
// painn_message_l1_banded (kernel _msg_kernel_l1_banded). Slots are in the
// routing band's spatial order; the species table arrives extended by a
// halo (its rows [0, halo) appended after row n_pad - 1) and nbr carries
// each neighbour's sorted rank. For a centre of block b = i / n_blk the
// window starts at s = win_start[b]; the neighbour of rank r is row
// s + ((r - s) mod n_pad) of the extended table when (r - s) mod n_pad < W
// (outside, the TPU kernel's one-hot router reads the zero row T; the host
// builds the band so that every selected edge lies in its window).
// win_start = nullptr with W = n_pad and no halo is the identity band: the
// unbanded layer-1 message.
//
// The body is l1binned::message (painn_message_l1_binned.cuh, which holds
// the design and the bound): a block per band block of n_blk sorted centres
// and chain, each centre's live edges binned by neighbour species in shared
// memory once for all members, then a thread per (member, channel)
// multiplying the bins of the species present by its filter columns, every
// sum in one fixed order.

#include "painn_message_l1_binned.cuh"

// Launches the kernel for a radial width R of 8, 16 or 24 and at most 32
// species rows, and returns cudaGetLastError() (a refused launch never
// runs).
extern "C" int painn_message_l1_banded(
    const int* species_ext, const float* philt, const float* rbf,
    const float* envm, const int* nbr, const float* unit, const float* dw2,
    const float* db2, const int* win_start, float* ds, float* dv, int C, int K,
    int n_pad, int n_ext, int M, int R, int F, int T1, int n_blk, int W,
    cudaStream_t stream) {
  return l1binned::message(species_ext, philt, rbf, envm, nbr, unit, dw2, db2, win_start, ds,
                           dv, C, K, n_pad, n_ext, M, R, F, T1, n_blk, W, stream);
}

// Bytes of dynamic shared memory that a block of the launch takes (for
// chip_smoke.py).
extern "C" int painn_message_l1_banded_smem(int R, int n_blk, int T1) {
  return int(l1binned::smem_bytes(R, n_blk, T1));
}
