// The routing band's addressing on the card, shared by the banded message
// kernels (painn_message_banded.cuh, painn_message_l1_banded.cu) and the
// banded message backward (painn_message_bwd.cuh). Slots are in the band's
// sorted order and the tables are extended by a halo (rows [0, halo) of the
// sorted table appended after row n_pad - 1), so that a window that wraps
// past the end stays contiguous (ops/banding.py).

#pragma once

namespace banded {

// Row of the halo-extended table holding neighbour rank r for a centre
// whose window starts at s, or -1 outside [s, s + W) mod n_pad.
__device__ __forceinline__ int window_row(int r, int s, int n_pad, int W) {
  int off = r - s;
  if (off < 0) off += n_pad;
  return off < W ? s + off : -1;
}

}  // namespace banded
