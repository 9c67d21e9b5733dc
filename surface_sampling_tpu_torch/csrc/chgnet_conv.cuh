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
// Bound on an H100, per live edge: the products be . w2 (F x 2F) and
// h0 . [wc1 | wg1] (2 x F x F) are 32,768 flop, ~2k more for the
// LayerNorms and gates, against ~0.5 kB of edge inputs (be, bw, the mask,
// the index). At the f32 rate (67 TFLOP/s) that is operations-bound; with
// the products as three TF32 passes on the tensor cores (3 x 32,768 flop
// over 495 TFLOP/s) and the rest at f32, an edge needs ~0.23 ns of
// tensor-core time against ~0.15 ns of bytes (3.35 TB/s): still
// operations, ~2.5x closer. A masked edge needs only its mask (4 bytes).
//
// The design, by what holds the work back:
//
// - Dead edges. About three quarters of the slots are masked (empty sites,
//   cut-off candidates, padded rows). Warp 0 of the block working on a
//   centre compacts the centre's live slots (maskf != 0) in ascending slot
//   order by warp ballots into the block's lists in shared memory; the
//   live edges are padded to tiles of 16 (the mma rows) and only those are
//   computed. A masked edge's be and bw are never loaded, so whatever they
//   hold reaches no output.
// - The products on the tensor cores at f32 accuracy. pre = be . w2 (16 x
//   64 times 64 x 128), hc = h0_c . wc1 and hg = h0_g . wg1 (16 x 64 times
//   64 x 64 each) run as mma.sync m16n8k8 TF32 with the 3xTF32 split of
//   tf32_mma.cuh; a single TF32 pass is never used. silu(pre) is taken on
//   the accumulator fragment, which is the A operand of the hidden
//   products once their B rows are permuted inside each 8-wide k step
//   (slot t <-> column 2t, slot t + 4 <-> column 2t + 1), so h0 never
//   leaves the registers. The LayerNorm statistics of an edge are quad
//   sums over the 16 channels each lane holds; the gate, core, bw and mask
//   step runs on the fragment. The backward (chgnet_conv_bwd.cu) runs
//   dh . [wc1 | wg1]^T and dpre . w2^T the same way.
// - Channel maps. The k and n indices of every product are permuted so
//   that lane (g, t) = (lane / 4, lane % 4) holds channels 16t .. 16t + 15
//   of each F-wide row it touches (be, bw, hc, hg, agg and each half of
//   pre and aj2): every row is read and written as 16-byte loads.
// - Weights staged once per resident block, in fragment order. The grid is
//   about SMs x resident blocks; each block stages w2, wc1 and wg1 once
//   and its warps then walk the (chain, centre) work list. Block (ks, nt)
//   of a weight holds the B fragments of k step ks and n tile nt, two
//   floats a lane (b0, b1): one conflict-free 8-byte load a lane. The same
//   array serves the transposed products of the backward by index (lane
//   (g, t) reads slots 16t + 8s + g of block (nt', ks')); an XOR swizzle of
//   each block's second half makes those 4-byte loads conflict-free too,
//   so no second, transposed copy is kept. The B fragments are split into
//   TF32 hi | lo as they are loaded.
// - Balance. Live centres hold ~76 live edges each (five tiles) and three
//   quarters of the centres none; dealt out in a fixed order, the busiest
//   SM would get 1.5x-2.3x the mean work at the chip cases' shapes. So the
//   blocks take (chain, centre) rows from a work list (an int counter in
//   device memory, WorkList) as they finish, and a block's warps share the
//   centre's tiles (warp w takes tiles w, w + warps, ...): a centre's five
//   tiles run side by side, and a launch does not end on single warps
//   working through whole centres alone. (A warp a centre, and groups of
//   2-6 centres a block with their tiles pooled, were slower at one path
//   or another: PERF.md §6.)
// - The centre sum. Each tile's sums over its 16 edges (a lane's two rows,
//   then the 8 lanes that share channels by a fixed butterfly) go to shared
//   memory, and the centre's sum adds them in tile order. A centre's result
//   therefore depends only on its own live edges, not on the warp or block
//   that computes it: a launch repeats bitwise and row 11 on an identity
//   band equals row 10. No float atomics.

#pragma once

#include <cuda_runtime.h>

#include "painn_band.cuh"
#include "tf32_mma.cuh"

namespace chgconv {

using namespace tf32mma;

constexpr int F = 64;          // atom features (the kernels' only width)
constexpr int F2 = 2 * F;
constexpr int ET = 16;         // live edges a tile (the mma rows)
constexpr int FWD_WARPS = 6;   // warps a block of the forward (rows 10, 11)
constexpr int FWD_BLOCKS_PER_SM = 2;
// Slots a centre: the slot-list capacity MAXM (a template argument of the
// forward and of row 12's centre kernel) sizes the ballot words, the lists
// and the tile sums. Two instantiations: 128 (every system of the repo,
// M = 96 by default) and 256; the C entries pick the smaller one that
// holds M (capacity_for) and refuse M past the larger.
constexpr int SMALL_M = 128;
constexpr int MAX_M = 256;
constexpr int W2_TILES = F2 / 8;   // n tiles of w2 (k steps: F / 8)
constexpr int W1_TILES = F / 8;    // n tiles (and k steps) of wc1 / wg1

// The instantiation's capacity for M slots, 0 past MAX_M.
inline int capacity_for(int M) {
  return M < 1 ? 0 : M <= SMALL_M ? SMALL_M : M <= MAX_M ? MAX_M : 0;
}

struct Weights {
  const float *w2, *wc1, *wg1, *bc1, *bg1, *lnc, *lng;
};

constexpr int FRAG = 64;   // floats of a fragment block

// Floats of the staged weights (w2 | wc1 | wg1 in fragment order, then
// bc1 | bg1 | lnc gain | lnc bias | lng gain | lng bias).
__host__ __device__ constexpr size_t weight_floats() {
  return size_t(F / 8) * (W2_TILES + 2 * W1_TILES) * FRAG + 6 * F;
}

// Row k of a weight held by fragment slot (k step ks, lane t0, s0) and its
// column held by (n tile nt, lane g0): rows 16 t0 + 2 ks + s0, so that
// lane t's A fragments of be are columns 16t .. 16t + 15; columns
// 64 (nt / 8) + 16 (g0 / 2) + 2 (nt % 8) + g0 % 2, so that lane t's
// accumulator columns 2t, 2t + 1 of the n tiles are channels 16t ..
// 16t + 15 of each 64-wide half.
__host__ __device__ __forceinline__ int wrow(int ks, int t0, int s0) {
  return 16 * t0 + 2 * ks + s0;
}
__host__ __device__ __forceinline__ int wcol(int nt, int g0) {
  return 64 * (nt >> 3) + 16 * (g0 >> 1) + 2 * (nt & 7) + (g0 & 1);
}
// Offset of slot (g0, t0, s0) in a fragment block: 8 g0 + 2 t0 + s0, its
// bit 3 flipped for g0 >= 4 (a swizzle: the transposed loads of lanes t and
// t + 2 then fall on other banks).
__host__ __device__ __forceinline__ int frag_slot(int g0, int t0, int s0) {
  return (8 * g0 + 2 * t0 + s0) ^ (g0 >= 4 ? 8 : 0);
}

struct Staged {
  const float *w2, *wc, *wg, *vec;
};

// Stage the weights of a block in fragment order (every thread; the caller
// ends with a barrier).
template <int NT>
__device__ inline Staged stage_weights(const Weights& W, float* base) {
  constexpr int B = FRAG;
  float* w2 = base;
  float* wc = w2 + (F / 8) * W2_TILES * B;
  float* wg = wc + (F / 8) * W1_TILES * B;
  float* vec = wg + (F / 8) * W1_TILES * B;
  for (int x = threadIdx.x; x < F * F2; x += NT) {
    const int blk = x >> 6, r = x & 63, ks = blk / W2_TILES, nt = blk % W2_TILES;
    const int g0 = r >> 3, t0 = (r >> 1) & 3, s0 = r & 1;
    w2[blk * B + frag_slot(g0, t0, s0)] = W.w2[wrow(ks, t0, s0) * F2 + wcol(nt, g0)];
  }
  for (int x = threadIdx.x; x < F * F; x += NT) {
    const int blk = x >> 6, r = x & 63, ks = blk / W1_TILES, nt = blk % W1_TILES;
    const int g0 = r >> 3, t0 = (r >> 1) & 3, s0 = r & 1;
    const int src = wrow(ks, t0, s0) * F + wcol(nt, g0);
    wc[blk * B + frag_slot(g0, t0, s0)] = W.wc1[src];
    wg[blk * B + frag_slot(g0, t0, s0)] = W.wg1[src];
  }
  for (int t = threadIdx.x; t < F; t += NT) {
    vec[t] = W.bc1[t];
    vec[F + t] = W.bg1[t];
    vec[2 * F + t] = W.lnc[t];
    vec[3 * F + t] = W.lnc[F + t];
    vec[4 * F + t] = W.lng[t];
    vec[5 * F + t] = W.lng[F + t];
  }
  return Staged{w2, wc, wg, vec};
}

__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Forward B fragments of block (ks, nt): b0, b1 of lane (g, t), split.
__device__ __forceinline__ void b_frag(const float* w, int blk, int g, int t, unsigned (&bh)[2],
                                       unsigned (&bl)[2]) {
  const float2 b = *reinterpret_cast<const float2*>(w + blk * FRAG + frag_slot(g, t, 0));
  split(b.x, bh[0], bl[0]);
  split(b.y, bh[1], bl[1]);
}

// B fragments of the transposed product: W^T with k = W's column (the
// accumulator columns 2t, 2t + 1 of the A operand's n tile ks) and n =
// W's row (column g of n tile nt), from block (nt, ks) of W.
__device__ __forceinline__ void bt_frag(const float* w, int blk, int g, int t, unsigned (&bh)[2],
                                        unsigned (&bl)[2]) {
  const float* p = w + blk * FRAG;
  split(p[frag_slot(2 * t, g >> 1, g & 1)], bh[0], bl[0]);
  split(p[frag_slot(2 * t + 1, g >> 1, g & 1)], bh[1], bl[1]);
}

// The accumulator fragment acc (row g | g + 8, columns 2t | 2t + 1) as the
// A operand of a product whose k slots t, t + 4 are those columns.
__device__ __forceinline__ void a_from_acc(const float (&acc)[4], unsigned (&ah)[4],
                                           unsigned (&al)[4]) {
  const float a[4] = {acc[0], acc[2], acc[1], acc[3]};
  split_all(a, ah, al);
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

// A centre's live-edge lists in shared memory (compact fills them).
struct Lists {
  int *slot, *row;
};

// The live slots (maskf != 0) of the centre whose first edge is e0, in
// ascending order, into the lists: slot[k] and its neighbour's row
// (rows(nbr), -1 = zeros). Returns their number to every lane of the warp,
// and in live[u] the ballot of slots 32u .. 32u + 31. Every mask and
// index of the centre is loaded first (MAXM / 32 a lane), so that their
// latencies overlap.
template <int MAXM>
__host__ __device__ constexpr int slot_words() { return MAXM / 32; }

template <int MAXM, class Rows>
__device__ inline int compact(const float* __restrict__ maskf, const int* __restrict__ nbr,
                              size_t e0, int M, Rows rows, const Lists& l,
                              unsigned (&live)[slot_words<MAXM>()]) {
  constexpr int SLOT_WORDS = slot_words<MAXM>();
  const int lane = threadIdx.x & 31;
  float mk[SLOT_WORDS];
  int nb[SLOT_WORDS];
#pragma unroll
  for (int u = 0; u < SLOT_WORDS; ++u) {
    const int m = 32 * u + lane;
    mk[u] = m < M ? maskf[e0 + m] : 0.f;
    nb[u] = m < M ? nbr[e0 + m] : 0;
  }
  __syncwarp();   // every lane's loads issued before the lists change
  int n = 0;
#pragma unroll
  for (int u = 0; u < SLOT_WORDS; ++u) {
    live[u] = __ballot_sync(FULL, mk[u] != 0.f);
    if (mk[u] != 0.f) {
      const int k = n + __popc(live[u] & ((1u << lane) - 1u));
      l.slot[k] = 32 * u + lane;
      l.row[k] = rows(nb[u]);
    }
    n += __popc(live[u]);
  }
  __syncwarp();
  return n;
}

// One tile's edge rows g and g + 8 (hr = 0, 1): slot (-1 = padding),
// neighbour row (-1 = zeros) and mask (0 for padding).
struct TileRows {
  int m[2], row[2];
  float mk[2];
};

__device__ __forceinline__ TileRows tile_rows(const Lists& l, int base, int n,
                                              const float* __restrict__ maskf, size_t e0) {
  const int g = (threadIdx.x & 31) >> 2;
  TileRows r;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int k = base + g + 8 * hr;
    r.m[hr] = k < n ? l.slot[k] : -1;
    r.row[hr] = k < n ? l.row[k] : -1;
    r.mk[hr] = k < n ? maskf[e0 + r.m[hr]] : 0.f;
  }
  return r;
}

// pre of a tile (16 edges x 2F): ai2 + aj2[row] + be . w2, in the
// accumulator layout: p[nt][2 hr + s] is edge row g + 8 hr, channel
// 64 (nt / 8) + 16 t + 2 (nt % 8) + s. ``ai`` is the centre's ai2 row,
// ``aj2c`` the chain's table; a padding row reads zeros.
__device__ __forceinline__ void tile_pre(const Staged& s, const float* __restrict__ ai,
                                         const float* __restrict__ aj2c,
                                         const float* __restrict__ be, size_t e0,
                                         const TileRows& r, float (&p)[16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = 64 * h + 16 * t + 4 * j;
      const float4 a = ld4(ai + ch);
      const float4 lo = r.row[0] >= 0 ? ld4(aj2c + size_t(r.row[0]) * F2 + ch) : z4;
      const float4 hi = r.row[1] >= 0 ? ld4(aj2c + size_t(r.row[1]) * F2 + ch) : z4;
      const int n0 = 8 * h + 2 * j;
      p[n0][0] = a.x + lo.x;
      p[n0][1] = a.y + lo.y;
      p[n0][2] = a.x + hi.x;
      p[n0][3] = a.y + hi.y;
      p[n0 + 1][0] = a.z + lo.z;
      p[n0 + 1][1] = a.w + lo.w;
      p[n0 + 1][2] = a.z + hi.z;
      p[n0 + 1][3] = a.w + hi.w;
    }
  // be rows g, g + 8: columns 16t .. 16t + 15 (k slots t, t + 4 of step ks
  // are columns 16t + 2ks, 16t + 2ks + 1)
  float bx[2][16];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = r.m[hr] >= 0 ? ld4(be + (e0 + r.m[hr]) * F + 16 * t + 4 * j) : z4;
      bx[hr][4 * j] = v.x;
      bx[hr][4 * j + 1] = v.y;
      bx[hr][4 * j + 2] = v.z;
      bx[hr][4 * j + 3] = v.w;
    }
#pragma unroll
  for (int ks = 0; ks < F / 8; ++ks) {
    const float a[4] = {bx[0][2 * ks], bx[1][2 * ks], bx[0][2 * ks + 1], bx[1][2 * ks + 1]};
    unsigned ah[4], al[4];
    split_all(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < W2_TILES; ++nt) {
      unsigned bh[2], bl[2];
      b_frag(s.w2, ks * W2_TILES + nt, g, t, bh, bl);
      mma3(p[nt], ah, al, bh, bl);
    }
  }
}

// One hidden product of a tile: out[nt][2 hr + s] (edge row g + 8 hr,
// channel 16t + 2nt + s) = bias + silu(p[H8 + ks]) . w (H8 = 0: the core
// half with wc1, 8: the gate half with wg1).
template <int H8>
__device__ __forceinline__ void tile_hidden(const float* w, const float* bias,
                                            const float (&p)[16][4], float (&out)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < W1_TILES; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 16 * t + 2 * nt);
    out[nt][0] = out[nt][2] = b.x;
    out[nt][1] = out[nt][3] = b.y;
  }
#pragma unroll
  for (int ks = 0; ks < W1_TILES; ++ks) {
    const float h[4] = {silu(p[H8 + ks][0]), silu(p[H8 + ks][1]), silu(p[H8 + ks][2]),
                        silu(p[H8 + ks][3])};
    unsigned ah[4], al[4];
    a_from_acc(h, ah, al);
#pragma unroll
    for (int nt = 0; nt < W1_TILES; ++nt) {
      unsigned bh[2], bl[2];
      b_frag(w, ks * W1_TILES + nt, g, t, bh, bl);
      mma3(out[nt], ah, al, bh, bl);
    }
  }
}

// LayerNorm statistics of edge row g + 8 hr over its F channels (16 a
// lane, the quad's four lanes together): the mean and 1 / sqrt(var + 1e-5).
__device__ __forceinline__ void ln_stats(const float (&h)[8][4], int hr, float& mu, float& inv) {
  float sum = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) sum += h[nt][2 * hr] + h[nt][2 * hr + 1];
  mu = quad_sum(sum) * (1.f / F);
  float var = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float d0 = h[nt][2 * hr] - mu, d1 = h[nt][2 * hr + 1] - mu;
    var += d0 * d0 + d1 * d1;
  }
  inv = 1.f / sqrtf(quad_sum(var) * (1.f / F) + 1e-5f);
}

// 16 floats of a row at channels 16t .. 16t + 15 (zeros for a null row).
__device__ __forceinline__ void load16(const float* row, int t, float (&v)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 x = row ? ld4(row + 16 * t + 4 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[4 * j] = x.x;
    v[4 * j + 1] = x.y;
    v[4 * j + 2] = x.z;
    v[4 * j + 3] = x.w;
  }
}

// The work list: blocks take (chain, centre) rows from an int counter in
// device memory (``work[0]``), one at a time, thread 0 asking for the next
// while the current one runs and posting it in shared memory before the
// block's last barrier of the item. The last block to find the list empty
// (counted in ``work[1]``) resets both for the next launch; launches on
// one stream run in order. Which block takes a centre, and which of its
// warps a tile, changes nothing in the centre's result (the tile sums
// below).
struct WorkList {
  int* work;
  int n_items;
  int* s_item;   // the block's next item, in shared memory

  __device__ __forceinline__ int ask() const {
    return threadIdx.x == 0 ? atomicAdd(work, 1) : 0;
  }
  __device__ __forceinline__ int first() const {
    if (threadIdx.x == 0) *s_item = atomicAdd(work, 1);
    __syncthreads();
    return *s_item;
  }
  // thread 0 posts the item it asked for; read it after a barrier
  __device__ __forceinline__ void post(int next) const {
    if (threadIdx.x == 0) *s_item = next;
  }
  __device__ __forceinline__ void leave() const {
    if (threadIdx.x == 0 && atomicAdd(work + 1, 1) == int(gridDim.x) - 1) {
      atomicExch(work, 0);
      atomicExch(work + 1, 0);
    }
  }
};

// The grid: the SMs times the blocks an SM holds, fewer for a short list.
inline int grid_blocks(int n_sm, int per_sm, long long n_items) {
  const long long full = (long long)n_sm * per_sm;
  return int(n_items < full ? n_items : full);
}

// Sum over the 8 lanes that share channels (lanes t, t + 4, ..., t + 28),
// by a fixed butterfly: every lane ends with the same total.
__device__ __forceinline__ float g_sum(float v) {
#pragma unroll
  for (int x = 4; x < 32; x <<= 1) v += __shfl_xor_sync(FULL, v, x);
  return v;
}

// Tiles of a centre with M slots (the most it can have), and of one with n
// live edges.
__host__ __device__ constexpr int max_tiles(int M) { return (M + ET - 1) / ET; }
__device__ __forceinline__ int tiles(int n) { return (n + ET - 1) / ET; }

// Shared memory past the weights: the centre's tile sums (max_tiles(M) x
// width floats); its item, live-edge count and live-slot ballots (4 +
// MAXM / 32 words); its live-edge lists (2M words).
template <int MAXM>
__host__ __device__ constexpr size_t tail_bytes(int M, int width) {
  return (size_t(max_tiles(M)) * width + 4 + slot_words<MAXM>() + 2 * size_t(M)) *
         sizeof(float);
}

template <int MAXM>
__host__ __device__ constexpr size_t forward_smem_bytes(int M) {
  return weight_floats() * sizeof(float) + tail_bytes<MAXM>(M, F);
}

// The block's centre: its item and live-edge count, and its lists (in
// shared memory past the tile sums), filled by warp 0.
struct Centre {
  int* s_item;
  int* s_n;
  unsigned* s_live;
  Lists lists;
};

template <int MAXM>
__device__ inline Centre carve_centre(float* s_sum, int M, int width) {
  int* words = reinterpret_cast<int*>(s_sum + max_tiles(M) * width);
  int* l = words + 4 + slot_words<MAXM>();
  return Centre{words, words + 1, reinterpret_cast<unsigned*>(words + 4), Lists{l, l + M}};
}

// Warp 0: the centre's live slots into the block's lists, their count and
// ballots into shared memory (the caller ends with a barrier).
template <int MAXM, class Rows>
__device__ inline void compact_centre(const Centre& cs, const float* __restrict__ maskf,
                                      const int* __restrict__ nbr, size_t e0, int M, Rows rows) {
  if (threadIdx.x >= 32) return;
  unsigned live[slot_words<MAXM>()];
  const int n = compact<MAXM>(maskf, nbr, e0, M, rows, cs.lists, live);
  if (threadIdx.x == 0) {
    *cs.s_n = n;
#pragma unroll
    for (int u = 0; u < slot_words<MAXM>(); ++u) cs.s_live[u] = live[u];
  }
}

// The forward: agg of every (chain, centre) row, a block of NW = FWD_WARPS
// warps a centre at a time. ``aj2`` has n_tab rows a chain; ``rows_of(i)``
// gives centre i's neighbour-row map. Warp 0 compacts the centre; warp w
// then takes tiles w, w + NW, ...; each tile's sums over its 16 edges go to
// shared memory, and the centre's agg is their sum in tile order. M is at
// most MAXM.
template <int MAXM, class RowsOf>
__device__ inline void forward(const float* __restrict__ ai2, const float* __restrict__ aj2,
                               int n_tab, const float* __restrict__ be,
                               const float* __restrict__ bw, const float* __restrict__ maskf,
                               const int* __restrict__ nbr, const Weights& W,
                               float* __restrict__ agg, int n_pad, int M, int* work,
                               int n_items, RowsOf rows_of) {
  constexpr int NW = FWD_WARPS;
  extern __shared__ __align__(16) float smem[];
  const Staged s = stage_weights<NW * 32>(W, smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float* s_sum = smem + weight_floats();             // [max_tiles(M)][F]
  const Centre cs = carve_centre<MAXM>(s_sum, M, F);
  const WorkList list{work, n_items, cs.s_item};
  __syncthreads();

  for (int item = list.first(); item < n_items;) {
    const int next = list.ask();
    const int c = item / n_pad;
    const size_t e0 = size_t(item) * M;
    compact_centre<MAXM>(cs, maskf, nbr, e0, M, rows_of(item - c * n_pad));
    __syncthreads();
    const int n = *cs.s_n;
    const float* ai = ai2 + size_t(item) * F2;
    const float* aj2c = aj2 + size_t(c) * n_tab * F2;

    for (int k = warp; k < tiles(n); k += NW) {
      const TileRows r = tile_rows(cs.lists, k * ET, n, maskf, e0);
      float p[16][4];
      tile_pre(s, ai, aj2c, be, e0, r, p);
      float hc[8][4], hg[8][4];
      tile_hidden<0>(s.wc, s.vec, p, hc);
      tile_hidden<8>(s.wg, s.vec + F, p, hg);
      float out[16];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mu_c, inv_c, mu_g, inv_g;
        ln_stats(hc, hr, mu_c, inv_c);
        ln_stats(hg, hr, mu_g, inv_g);
        const float mk = r.mk[hr];
        float wv[16];
        load16(r.m[hr] >= 0 ? bw + (e0 + r.m[hr]) * F : nullptr, t, wv);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int f = 16 * t + q, nt = q >> 1, x = 2 * hr + (q & 1);
          const float yc = (hc[nt][x] - mu_c) * inv_c * s.vec[2 * F + f] + s.vec[3 * F + f];
          const float yg = (hg[nt][x] - mu_g) * inv_g * s.vec[4 * F + f] + s.vec[5 * F + f];
          const float msg = silu(yc) * sigmoid(yg) * wv[q] * mk;
          out[q] = hr ? out[q] + msg : msg;
        }
      }
      // the tile's sums: the 8 lanes of each channel quadruple
#pragma unroll
      for (int q = 0; q < 16; ++q) out[q] = g_sum(out[q]);
      if (g == 0) {
        float* dst = s_sum + k * F + 16 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(dst + 4 * j) =
              make_float4(out[4 * j], out[4 * j + 1], out[4 * j + 2], out[4 * j + 3]);
      }
    }
    list.post(next);
    __syncthreads();
    const int following = *list.s_item;
    // agg: the tile sums in tile order
    if (threadIdx.x < F) {
      float v = 0.f;
      for (int k = 0; k < tiles(n); ++k) v += s_sum[k * F + threadIdx.x];
      agg[size_t(item) * F + threadIdx.x] = v;
    }
    item = following;
  }
  list.leave();
}

}  // namespace chgconv
