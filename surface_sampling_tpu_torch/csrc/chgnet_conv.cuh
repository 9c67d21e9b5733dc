// The CHGNet atom conv on Hopper: the pieces its forward (chgnet_conv.cu,
// chgnet_conv_banded.cu) and its backward (chgnet_conv_bwd.cu) share.
//
// Per edge e = (i, m) of centre i with neighbour row j, channel c of 2F
// (core | gate) and f of F:
//     pre[c]  = ai2[i, c] + aj2[j, c] + sum_k be[e, k] w2[k, c]
//     h0      = silu(pre)
//     hc[f]   = sum_k h0[k] wc1[k, f] + bc1[f]       (core half, k < F)
//     hg[f]   = sum_k h0[F + k] wg1[k, f] + bg1[f]   (gate half)
//     msg[f]  = silu(LN_c(hc))[f] * sigmoid(LN_g(hg))[f] * bw[e, f] * maskf[e]
//     agg[i]  = sum_m msg
//
// The TPU kernels (surface_sampling_tpu/ops/pallas_chgnet.py) route the
// aj2 rows through one-hot MXU matmuls and multiply h0 by zero-extended
// (2F, F) second-layer weights, both TPU layout devices; here a row is
// loaded by index and only the live F x F halves are read.
//
// Bound on an H100: operations. Per live edge the two products be @ w2
// (F x 2F) and h0 @ [wc1 | wg1] (2 x F x F) are 2 * 16,384 flop, ~35k
// with the LayerNorms and gates, against ~0.5 kB of edge inputs (be, bw,
// the mask, the index): ~65 flop a byte, above the f32 balance of ~20. A
// masked edge needs only its mask and index (8 bytes), so the padded and
// masked edges of a mostly empty state do not move the bound.
//
// Design (first version, right and simple: no tensor cores, whose TF32
// would not hold the 1e-4 tolerance, and no TMA). One block of 256 threads
// (8 warps) per group of centres of one chain; the weights are staged once
// per block in shared memory (64 kB, rows padded by one float so that a
// warp reading down a column hits 32 banks). A centre's M edges are worked
// in tiles of 32: the tile's bond embeddings go to shared memory, and both
// products run as register-tiled matrix products in which thread
// (warp w, lane l) owns edges w, w + 8, w + 16, w + 24 of the tile and
// channels l, l + 32, l + 64, l + 96. A warp therefore holds all channels
// of its edges, and the LayerNorm statistics are warp shuffles. The sum
// over m runs in a fixed order (tile by tile, edge by edge), so results
// repeat bitwise; a tile whose edges are all masked is skipped.

#pragma once

#include <cuda_runtime.h>

#include "painn_band.cuh"

namespace chgconv {

constexpr int F = 64;          // atom features (the kernels' only width)
constexpr int F2 = 2 * F;
constexpr int TE = 32;         // edges per tile
constexpr int NT = 256;        // threads per block
constexpr int LDW2 = F2 + 1;   // padded row of w2 in shared memory
constexpr int LDW1 = F + 1;    // padded row of wc1 / wg1
constexpr unsigned FULL = 0xffffffffu;

struct Weights {
  const float *w2, *wc1, *wg1, *bc1, *bg1, *lnc, *lng;
};

// Shared memory of a block, in floats: the weights, the tile buffers and
// the centre's rows. The backward adds the pre-activation tile p and the
// centre's cotangent row g.
struct Smem {
  float* w2;    // F x LDW2
  float* wc;    // F x LDW1
  float* wg;    // F x LDW1
  float* vec;   // bc1 | bg1 | lnc gain | lnc bias | lng gain | lng bias
  float* a;     // TE x F: bond embeddings of the tile, then scratch
  float* h;     // TE x F2: h0 of the tile (the backward then keeps dh here)
  float* p;     // TE x F2: pre of the tile (backward)
  float* ai;    // F2: ai2 of the centre
  float* g;     // F: cotangent of the centre's agg (backward)
  float* mask;  // TE
  int* row;     // TE: neighbour row of each edge of the tile, -1 = none
};

__host__ __device__ constexpr size_t smem_floats(bool backward) {
  return size_t(F) * LDW2 + 2 * size_t(F) * LDW1 + 6 * F + TE * F + TE * F2 + F2 + TE +
         (backward ? TE * F2 + F : 0);
}

__host__ __device__ constexpr size_t smem_bytes(bool backward) {
  return smem_floats(backward) * sizeof(float) + TE * sizeof(int);
}

__device__ inline Smem carve(float* base, bool backward) {
  Smem s;
  s.w2 = base;
  s.wc = s.w2 + F * LDW2;
  s.wg = s.wc + F * LDW1;
  s.vec = s.wg + F * LDW1;
  s.a = s.vec + 6 * F;
  s.h = s.a + TE * F;
  s.ai = s.h + TE * F2;
  s.mask = s.ai + F2;
  float* next = s.mask + TE;
  s.p = backward ? next : nullptr;
  s.g = backward ? next + TE * F2 : nullptr;
  s.row = reinterpret_cast<int*>(backward ? next + TE * F2 + F : next);
  return s;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// LayerNorm statistics of one edge's F values, held two per lane (f = lane
// and lane + 32): the mean and 1 / sqrt(var + 1e-5), in every lane.
__device__ __forceinline__ void ln_stats(float x0, float x1, float& mu, float& inv) {
  mu = warp_sum(x0 + x1) * (1.f / F);
  const float d0 = x0 - mu, d1 = x1 - mu;
  inv = 1.f / sqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / F) + 1e-5f);
}

__device__ inline void load_weights(const Weights& W, const Smem& s) {
  for (int t = threadIdx.x; t < F * F2; t += NT) s.w2[(t / F2) * LDW2 + t % F2] = W.w2[t];
  for (int t = threadIdx.x; t < F * F; t += NT) {
    s.wc[(t / F) * LDW1 + t % F] = W.wc1[t];
    s.wg[(t / F) * LDW1 + t % F] = W.wg1[t];
  }
  for (int t = threadIdx.x; t < F; t += NT) {
    s.vec[t] = W.bc1[t];
    s.vec[F + t] = W.bg1[t];
    s.vec[2 * F + t] = W.lnc[t];
    s.vec[3 * F + t] = W.lnc[F + t];
    s.vec[4 * F + t] = W.lng[t];
    s.vec[5 * F + t] = W.lng[F + t];
  }
}

// Neighbour row of an edge: its index itself (a full table), or, for a
// supercell's band, the row of the halo-extended sorted table inside the
// centre's window (-1 outside it: the TPU router matches nothing there).
struct DirectRows {
  __device__ int operator()(int r) const { return r; }
};

struct BandRows {
  int start, n_pad, window;
  __device__ int operator()(int r) const {
    return banded::window_row(r, start, n_pad, window);
  }
};

// Per-centre row maps: every centre reads the full table; a supercell's
// centre i reads through the window of its block i / n_blk.
struct DirectRowsOf {
  __device__ DirectRows operator()(int) const { return DirectRows{}; }
};

struct BandRowsOf {
  const int* win_start;
  int n_blk, n_pad, window;
  __device__ BandRows operator()(int i) const {
    return BandRows{win_start[i / n_blk], n_pad, window};
  }
};

// Stage edges [m0, m0 + TE) of a centre whose first edge is e0: bond
// embeddings, mask and neighbour rows (zeros past M). Returns, to every
// thread, whether any edge of the tile is live; ends with a barrier.
template <class Rows>
__device__ inline int load_tile(const Smem& s, const float* __restrict__ be,
                                const float* __restrict__ maskf, const int* __restrict__ nbr,
                                size_t e0, int m0, int M, Rows rows) {
  const int t = threadIdx.x;
  int live = 0;
  if (t < TE) {
    const int m = m0 + t;
    float mk = 0.f;
    int r = 0;
    if (m < M) {
      mk = maskf[e0 + m];
      r = rows(nbr[e0 + m]);
    }
    s.mask[t] = mk;
    s.row[t] = r;
    live = mk != 0.f;
  }
  for (int x = t; x < TE * F; x += NT) {
    const int m = m0 + x / F;
    s.a[x] = m < M ? be[(e0 + m) * F + x % F] : 0.f;
  }
  return __syncthreads_or(live);
}

// pre[i][j] of edge warp + 8i and channel lane + 32j of the tile:
// be @ w2 + ai2 + aj2[row], read from the staged tile and the chain's
// (n_tab, 2F) table aj2c.
__device__ inline void tile_pre(const Smem& s, const float* __restrict__ aj2c,
                                float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < F; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = s.a[(warp + 8 * i) * F + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = s.w2[k * LDW2 + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = s.row[warp + 8 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      const float aj = r >= 0 ? aj2c[size_t(r) * F2 + c] : 0.f;
      acc[i][j] += s.ai[c] + aj;
    }
  }
}

// hc / hg [i][q] of edge warp + 8i and channel lane + 32q from the tile's
// h0 in s.h, biases added.
__device__ inline void tile_hidden(const Smem& s, float (&hc)[4][2], float (&hg)[4][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q) hc[i][q] = hg[i][q] = 0.f;
#pragma unroll 4
  for (int k = 0; k < F; ++k) {
    float ac[4], ag[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ac[i] = s.h[(warp + 8 * i) * F2 + k];
      ag[i] = s.h[(warp + 8 * i) * F2 + F + k];
    }
    const float c0 = s.wc[k * LDW1 + lane], c1 = s.wc[k * LDW1 + lane + 32];
    const float g0 = s.wg[k * LDW1 + lane], g1 = s.wg[k * LDW1 + lane + 32];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hc[i][0] = fmaf(ac[i], c0, hc[i][0]);
      hc[i][1] = fmaf(ac[i], c1, hc[i][1]);
      hg[i][0] = fmaf(ag[i], g0, hg[i][0]);
      hg[i][1] = fmaf(ag[i], g1, hg[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      hc[i][q] += s.vec[lane + 32 * q];
      hg[i][q] += s.vec[F + lane + 32 * q];
    }
}

// The forward over one chain's centres [blockIdx.x * cpb, ...): agg rows.
// ``rows_of(i)`` gives centre i's neighbour-row map.
template <class RowsOf>
__device__ inline void forward(const float* __restrict__ ai2, const float* __restrict__ aj2c,
                               const float* __restrict__ be, const float* __restrict__ bw,
                               const float* __restrict__ maskf, const int* __restrict__ nbr,
                               const Weights& W, float* __restrict__ agg, int n_pad, int M,
                               int cpb, RowsOf rows_of) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, false);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c = blockIdx.y;
  load_weights(W, s);
  for (int ii = 0; ii < cpb; ++ii) {
    const int i = blockIdx.x * cpb + ii;
    if (i >= n_pad) break;
    const size_t ci = size_t(c) * n_pad + i;
    const size_t e0 = ci * M;
    __syncthreads();
    if (t < F2) s.ai[t] = ai2[ci * F2 + t];
    float out = 0.f;
    const auto rows = rows_of(i);
    for (int m0 = 0; m0 < M; m0 += TE) {
      if (!load_tile(s, be, maskf, nbr, e0, m0, M, rows)) continue;
      float pre[4][4];
      tile_pre(s, aj2c, pre);
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4)
#pragma unroll
        for (int j = 0; j < 4; ++j) s.h[(warp + 8 * i4) * F2 + lane + 32 * j] = silu(pre[i4][j]);
      __syncthreads();
      float hc[4][2], hg[4][2];
      tile_hidden(s, hc, hg);
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        const int e = warp + 8 * i4, m = m0 + e;
        float mu_c, inv_c, mu_g, inv_g;
        ln_stats(hc[i4][0], hc[i4][1], mu_c, inv_c);
        ln_stats(hg[i4][0], hg[i4][1], mu_g, inv_g);
        const float mk = s.mask[e];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int f = lane + 32 * q;
          const float yc = (hc[i4][q] - mu_c) * inv_c * s.vec[2 * F + f] + s.vec[3 * F + f];
          const float yg = (hg[i4][q] - mu_g) * inv_g * s.vec[4 * F + f] + s.vec[5 * F + f];
          const float bwv = m < M ? bw[(e0 + m) * F + f] : 0.f;
          s.a[e * F + f] = silu(yc) * sigmoid(yg) * bwv * mk;
        }
      }
      __syncthreads();
      if (t < F)
        for (int e = 0; e < TE; ++e) out += s.a[e * F + t];
      __syncthreads();
    }
    if (t < F) agg[ci * F + t] = out;
  }
}

}  // namespace chgconv
