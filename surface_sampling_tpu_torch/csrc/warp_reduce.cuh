// Warp reduce-scatter of 32 per-lane slots, used by the second-order
// message backward (painn_message_bwd2.cu, row 5): after it, lane l holds
// the warp's sum of slot l, added in a fixed order, so the sums repeat
// bitwise.

#pragma once

namespace warp_reduce {

constexpr unsigned FULL = 0xffffffffu;

// One level of the butterfly: lanes that differ in bit S swap halves of
// the live slots v[0..2S) and keep the sum of the half their bit selects.
// S is a template argument so every index is a constant and v stays in
// registers.
template <int S>
__device__ __forceinline__ void reduce_level(float (&v)[32], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const float send = upper ? v[t] : v[t + S];
    const float keep = upper ? v[t + S] : v[t];
    v[t] = keep + __shfl_xor_sync(FULL, send, S);
  }
}

// After the butterfly, lane l holds the warp's sum of slot l (slots are
// v[0..31]); every lane adds in a fixed order, so the sums repeat bitwise.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  reduce_level<16>(v, lane);
  reduce_level<8>(v, lane);
  reduce_level<4>(v, lane);
  reduce_level<2>(v, lane);
  reduce_level<1>(v, lane);
  return v[0];
}

}  // namespace warp_reduce
