// General PaiNN message block (layers 2+) of the rigid MC path, of every
// force call of the relaxed path and of the training force pass, batched
// over chains C and ensemble members K. Its backward is
// painn_message_bwd.cu.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py, painn_message_fused
// -> _message_pallas (kernel _msg_kernel). The TPU kernel routes the
// neighbour rows of phi and vcat through one-hot MXU matmuls (bf16 hi/lo
// splits) because TPU gathers serialize; here each neighbour row is loaded
// by index.
//
// Per edge e = (i, m), neighbour j = nbr[e], for channel f of F:
//     w_t = (rbf[e] . dw[:, tF + f] + db[tF + f]) * envm[e]    t = vv, s, unit
//     c_t = phi[j, tF + f] * w_t
//     ds[i, f]     += c_s
//     dv[i, x*F+f] += c_unit * unit[x, i, m] + c_vv * vcat[j, x*F + f]
//
// This is the banded message on an identity band: every window starts at
// row 0 and is n_pad wide, the tables carry no halo, so every neighbour
// row is read as it is. The body is banded::message
// (painn_message_banded.cuh, which holds the design and the bound): a
// block per n_blk centres and chain with the K members inside, live edges
// only (envm != 0; a dead edge's rbf, unit vector and neighbour index are
// never read), the radial filter as 3xTF32 mma.sync tiles, warps owning
// (member, 16-channel) slices, each centre's sums in one fixed order. So
// a centre gets bitwise what painn_message_fused_banded gives it on an
// identity band, and launches repeat bitwise.

#include "painn_message_banded.cuh"

namespace {

// Centres a block: 4 (of 16, 8, 4, 2 and 1, the fastest at the flagship's
// shapes: more, smaller blocks balance the SMs better, and the members still
// share each block's staged geometry), halved while it does not divide
// n_pad. A centre's bits do not depend on it.
int centres_a_block(int n_pad) {
  int n_blk = 4;
  while (n_pad % n_blk) n_blk >>= 1;
  return n_blk;
}

}  // namespace

extern "C" int painn_message_fused(
    const float* phi, const float* vcat, const float* rbf, const float* envm,
    const int* nbr, const float* unit, const float* dw, const float* db,
    float* ds, float* dv, int C, int K, int n_pad, int M, int R, int F,
    cudaStream_t stream) {
  return banded::message(phi, vcat, rbf, envm, nbr, unit, dw, db, /*ws=*/nullptr, ds, dv,
                         C, K, /*n_rows=*/n_pad, n_pad, /*n_ext=*/n_pad, M, R, F,
                         centres_a_block(n_pad), /*W=*/n_pad, /*ws_stride=*/0, stream);
}

// Centres a block of a launch at n_pad rows, and the bytes of dynamic
// shared memory the block takes (0 for an R the kernel does not take), for
// chip_smoke.py.
extern "C" int painn_message_fused_n_blk(int n_pad) { return centres_a_block(n_pad); }
extern "C" int painn_message_fused_smem(int R, int M, int n_pad) {
  return int(banded::smem_bytes(R, M, centres_a_block(n_pad)));
}
