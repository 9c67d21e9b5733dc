// Backward of the CHGNet atom conv (row 12 of PERF.md's kernel table),
// batched over chains C: the cotangents of ai2, aj2 (C, n_pad, 2F), be, bw
// (C, E, F) and, on request, of the seven weights, given gagg
// (C, n_pad, F).
//
// Replaces: surface_sampling_tpu/ops/pallas_chgnet.py, _conv_bwd_pallas
// (kernel _conv_bwd_kernel), the custom-VJP backward of chgnet_conv_fused.
// The TPU kernel scatters the neighbour cotangents through a transposed
// one-hot matmul and accumulates the weight cotangents in output blocks
// pinned across its sequential grid; neither exists here, so the work is
// split by who owns each output:
//
//   centre_kernel    the forward's layout (chgnet_conv.cuh): a warp per
//                    (chain, centre) item of the work list, its live edges
//                    compacted into tiles of 16, the forward recomputed on
//                    the tensor cores, then per live edge
//                        g_bw  = gagg * core * gate * maskf
//                        dy_c  = gagg * gate * bw * maskf * silu'(y_c)
//                        dy_g  = gagg * core * bw * maskf * gate (1 - gate)
//                        dh    = both LayerNorm backwards (quad sums)
//                        dpre  = [dh_c . wc1^T | dh_g . wg1^T] * silu'(pre)
//                        g_be  = dpre . w2^T
//                    (both products 3xTF32 mma.sync tiles, B read by index
//                    from the staged forward weights) and g_ai2[i] = sum_m
//                    dpre in a fixed order. g_be and g_bw are written
//                    exactly 0 at masked slots in the same pass; dpre
//                    (C, E, 2F) goes to device memory for the live edges
//                    only. On request it also writes h0 and dh per live
//                    edge and each centre's LayerNorm cotangent partials.
//   neighbour_kernel one block per (row j, chain c), one thread per channel:
//                    g_aj2[j] = sum of dpre over the live edges that read
//                    row j, walked in the reverse table (ascending edge id);
//                    an edge with maskf == 0 is skipped, so a table that
//                    also lists masked edges gives the same sum. A gather
//                    in a fixed order: no float atomics, so relaxed
//                    positions repeat bitwise.
//   wgrad_kernel     on request only (training; the forces path never
//                    asks): per chunk of edges the partial sums
//                    g_w2 = be^T dpre, g_wc1 = h0_c^T dh_c, g_wg1 =
//                    h0_g^T dh_g, g_bc1 = sum dh_c, g_bg1 = sum dh_g over
//                    the live edges; the caller adds the chunks' partials
//                    in a fixed order.
//
// Bound on an H100: operations, as the forward's (chgnet_conv.cuh). The
// centre kernel recomputes the forward's two products and adds
// dh . [wc1 | wg1]^T and dpre . w2^T: ~70k flop per live edge, two thirds
// of it in products that run as three TF32 passes; the weight pass adds
// ~33k more. The dense g_be and g_bw (masked slots included) are the
// bytes.

#include "chgnet_conv.cuh"

namespace {

using namespace chgconv;


__device__ int work[2];  // the centre kernel's work list (chgconv::WorkList)
constexpr int BWD_WARPS = 4;   // warps a block of the centre kernel
constexpr int BWD_BLOCKS_PER_SM = 2;

// Shared memory of the centre kernel: the weights, the centre's tile sums
// of dpre (g_ai2), its item, live-edge count, ballots and lists; each
// warp's silu'(pre) of its tile ([value][lane], 64 values a lane; kept
// here, not in registers, so that the kernel does not spill); on request
// each warp's LayerNorm cotangent partials of its tile (64 a lane) and the
// centre's tile sums of them (4F a tile).
template <int MAXM>
__host__ __device__ constexpr size_t centre_smem_bytes(int M, bool want_w) {
  return weight_floats() * sizeof(float) + tail_bytes<MAXM>(M, F2) +
         (size_t(BWD_WARPS) * (64 * 32 + (want_w ? 64 * 32 : 0)) +
          (want_w ? size_t(max_tiles(M)) * 4 * F : 0)) * sizeof(float);
}

// dpre of one half of a tile: p[H8 + nt] = (dh . w^T)[nt] * silu'(pre),
// dh in the hidden accumulator layout, silu'(pre) of p[nt][x] at
// s_dsp[(4 nt + x) 32 + lane]. The 8 output n tiles in two groups of 4 (A
// split again for the second): fewer live accumulators.
template <int H8>
__device__ __forceinline__ void tile_dpre(const float* w, const float (&dh)[8][4],
                                          const float* s_dsp, float (&p)[16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int o = 0; o < W1_TILES; o += 4) {
    float d[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) d[n][x] = 0.f;
#pragma unroll
    for (int ks = 0; ks < W1_TILES; ++ks) {
      unsigned ah[4], al[4];
      a_from_acc(dh[ks], ah, al);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        unsigned bh[2], bl[2];
        bt_frag(w, (o + n) * W1_TILES + ks, g, t, bh, bl);
        mma3(d[n], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        p[H8 + o + n][x] = d[n][x] * s_dsp[(4 * (H8 + o + n) + x) * 32 + lane];
  }
}

// A tile's rows of a 2F-wide per-edge output in the pre layout (v[nt][2 hr
// + s]: channel 64 (nt / 8) + 16t + 2 (nt % 8) + s), live rows only;
// ``act`` maps each value (silu for h0, identity for dpre).
template <class Act>
__device__ __forceinline__ void store_pre_rows(float* __restrict__ out, size_t e0,
                                               const TileRows& r, const float (&v)[16][4],
                                               Act act) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (r.m[hr] < 0) continue;
    float* dst = out + (e0 + r.m[hr]) * F2 + 16 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n0 = 8 * h + 2 * j;
        st4(dst + 64 * h + 4 * j, act(v[n0][2 * hr]), act(v[n0][2 * hr + 1]),
            act(v[n0 + 1][2 * hr]), act(v[n0 + 1][2 * hr + 1]));
      }
  }
}

struct Identity {
  __device__ float operator()(float x) const { return x; }
};
struct Silu {
  __device__ float operator()(float x) const { return silu(x); }
};

// M is at most MAXM, the slot-list capacity (chgconv::capacity_for).
template <int MAXM, bool WANT_W>
__global__ void __launch_bounds__(BWD_WARPS * 32, BWD_BLOCKS_PER_SM)
centre_kernel(const float* __restrict__ ai2, const float* __restrict__ aj2,
              const float* __restrict__ be, const float* __restrict__ bw,
              const float* __restrict__ maskf, const int* __restrict__ nbr, Weights W,
              const float* __restrict__ gagg, float* __restrict__ g_ai2,
              float* __restrict__ g_be, float* __restrict__ g_bw, float* __restrict__ dpre_out,
              float* __restrict__ h0_out, float* __restrict__ dh_out,
              float* __restrict__ lnpart, int C, int n_pad, int M) {
  constexpr int NW = BWD_WARPS;
  extern __shared__ __align__(16) float smem[];
  const Staged s = stage_weights<NW * 32>(W, smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float* s_sum = smem + weight_floats();                      // [max_tiles(M)][F2]
  const Centre cs = carve_centre<MAXM>(s_sum, M, F2);
  float* s_dsp = s_sum + tail_bytes<MAXM>(M, F2) / sizeof(float) + warp * 64 * 32;
  float* s_ln = s_dsp + NW * 64 * 32;                         // [NW][64][32], this warp's
  float* s_lnt = s_ln - warp * 64 * 32 + NW * 64 * 32;        // [max_tiles(M)][4F]
  const int n_items = C * n_pad;
  const WorkList list{work, n_items, cs.s_item};
  __syncthreads();

  for (int item = list.first(); item < n_items;) {
    const int next = list.ask();
    const int c = item / n_pad;
    const size_t e0 = size_t(item) * M;
    compact_centre<MAXM>(cs, maskf, nbr, e0, M, DirectRows{});
    __syncthreads();
    const int n = *cs.s_n;
    // masked slots: exact zeros in g_be and g_bw (16 threads a slot, 16
    // bytes each)
    for (int x = threadIdx.x; x < M * 16; x += NW * 32) {
      const int m = x >> 4;
      if ((cs.s_live[m >> 5] >> (m & 31)) & 1u) continue;
      st4(g_be + (e0 + m) * F + 4 * (x & 15), 0.f, 0.f, 0.f, 0.f);
      st4(g_bw + (e0 + m) * F + 4 * (x & 15), 0.f, 0.f, 0.f, 0.f);
    }
    const float* ai = ai2 + size_t(item) * F2;
    const float* aj2c = aj2 + size_t(c) * n_pad * F2;
    const float* gi = gagg + size_t(item) * F;

    for (int k = warp; k < tiles(n); k += NW) {
      if (WANT_W) {
#pragma unroll 4
        for (int q = 0; q < 64; ++q) s_ln[q * 32 + lane] = 0.f;
      }
      const TileRows r = tile_rows(cs.lists, k * ET, n, maskf, e0);
      float p[16][4];
      tile_pre(s, ai, aj2c, be, e0, r, p);
      if (WANT_W) store_pre_rows(h0_out, e0, r, p, Silu{});
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float pv = p[nt][x], sp = sigmoid(pv);
          s_dsp[(4 * nt + x) * 32 + lane] = sp * (1.f + pv * (1.f - sp));
        }
      float hc[8][4], hg[8][4];
      tile_hidden<0>(s.wc, s.vec, p, hc);
      tile_hidden<8>(s.wg, s.vec + F, p, hg);
      // per edge row: g_bw, then both LayerNorm backwards, dh in place of hc / hg
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mu_c, inv_c, mu_g, inv_g;
        ln_stats(hc, hr, mu_c, inv_c);
        ln_stats(hg, hr, mu_g, inv_g);
        const bool live = r.m[hr] >= 0;
        const size_t e = e0 + (live ? r.m[hr] : 0);
        const float mk = r.mk[hr];
        float dxc[16], dxg[16];
        float s1c = 0.f, s2c = 0.f, s1g = 0.f, s2g = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 g4 = ld4(gi + 16 * t + 4 * j);
          const float4 w4 =
              live ? ld4(bw + e * F + 16 * t + 4 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
          const float gm[4] = {g4.x, g4.y, g4.z, g4.w}, bwv[4] = {w4.x, w4.y, w4.z, w4.w};
          float gbw[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int q = 4 * j + u, f = 16 * t + q, nt = q >> 1, x = 2 * hr + (q & 1);
            const float xc = (hc[nt][x] - mu_c) * inv_c, xg = (hg[nt][x] - mu_g) * inv_g;
            const float yc = xc * s.vec[2 * F + f] + s.vec[3 * F + f];
            const float yg = xg * s.vec[4 * F + f] + s.vec[5 * F + f];
            const float sc = sigmoid(yc), core = yc * sc, gate = sigmoid(yg);
            gbw[u] = gm[u] * core * gate * mk;
            const float scale = bwv[u] * mk;
            const float dyc = gm[u] * gate * scale * (sc * (1.f + yc * (1.f - sc)));
            const float dyg = gm[u] * core * scale * (gate * (1.f - gate));
            if (WANT_W) {
              s_ln[q * 32 + lane] += dyc * xc;
              s_ln[(16 + q) * 32 + lane] += dyc;
              s_ln[(32 + q) * 32 + lane] += dyg * xg;
              s_ln[(48 + q) * 32 + lane] += dyg;
            }
            dxc[q] = dyc * s.vec[2 * F + f];
            dxg[q] = dyg * s.vec[4 * F + f];
            s1c += dxc[q];
            s2c += dxc[q] * xc;
            s1g += dxg[q];
            s2g += dxg[q] * xg;
            hc[nt][x] = xc;
            hg[nt][x] = xg;
          }
          if (live) st4(g_bw + e * F + 16 * t + 4 * j, gbw[0], gbw[1], gbw[2], gbw[3]);
        }
        const float m1c = quad_sum(s1c) * (1.f / F), m2c = quad_sum(s2c) * (1.f / F);
        const float m1g = quad_sum(s1g) * (1.f / F), m2g = quad_sum(s2g) * (1.f / F);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int nt = q >> 1, x = 2 * hr + (q & 1);
          hc[nt][x] = inv_c * (dxc[q] - m1c - hc[nt][x] * m2c);
          hg[nt][x] = inv_g * (dxg[q] - m1g - hg[nt][x] * m2g);
        }
        if (WANT_W && live) {
          float* dst = dh_out + e * F2 + 16 * t;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n0 = 2 * j, x = 2 * hr;
            st4(dst + 4 * j, hc[n0][x], hc[n0][x + 1], hc[n0 + 1][x], hc[n0 + 1][x + 1]);
            st4(dst + F + 4 * j, hg[n0][x], hg[n0][x + 1], hg[n0 + 1][x], hg[n0 + 1][x + 1]);
          }
        }
      }

      tile_dpre<0>(s.wc, hc, s_dsp, p);
      tile_dpre<8>(s.wg, hg, s_dsp, p);
      store_pre_rows(dpre_out, e0, r, p, Identity{});
      // the tile's sums of dpre (g_ai2): value 16h + j of lane t is channel
      // 64h + 16t + j
      {
        float v[32];
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
          for (int x = 0; x < 2; ++x) v[2 * nt + x] = g_sum(p[nt][x] + p[nt][2 + x]);
        if (g == 0) {
          float* dst = s_sum + k * F2 + 16 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              *reinterpret_cast<float4*>(dst + 64 * h + 4 * j) =
                  make_float4(v[16 * h + 4 * j], v[16 * h + 4 * j + 1], v[16 * h + 4 * j + 2],
                              v[16 * h + 4 * j + 3]);
        }
      }

      // g_be = dpre . w2^T: lane t holds features 16t .. 16t + 15
      float gb[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) gb[nt][x] = 0.f;
#pragma unroll
      for (int ks = 0; ks < W2_TILES; ++ks) {
        unsigned ah[4], al[4];
        a_from_acc(p[ks], ah, al);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          unsigned bh[2], bl[2];
          bt_frag(s.w2, nt * W2_TILES + ks, g, t, bh, bl);
          mma3(gb[nt], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (r.m[hr] < 0) continue;
        float* dst = g_be + (e0 + r.m[hr]) * F + 16 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          st4(dst + 4 * j, gb[2 * j][2 * hr], gb[2 * j][2 * hr + 1], gb[2 * j + 1][2 * hr],
              gb[2 * j + 1][2 * hr + 1]);
      }
      if (WANT_W) {
        // the tile's LayerNorm cotangent sums, [r][f]: lnc gain, lnc bias,
        // lng gain, lng bias
#pragma unroll 4
        for (int rq = 0; rq < 64; ++rq) {
          const float v = g_sum(s_ln[rq * 32 + lane]);
          if (g == 0) s_lnt[k * 4 * F + (rq >> 4) * F + 16 * t + (rq & 15)] = v;
        }
      }
    }

    list.post(next);
    __syncthreads();
    const int following = *list.s_item;
    // g_ai2 (and the LayerNorm partials): the tile sums in tile order
    if (threadIdx.x < F2) {
      float v = 0.f;
      for (int k = 0; k < tiles(n); ++k) v += s_sum[k * F2 + threadIdx.x];
      g_ai2[size_t(item) * F2 + threadIdx.x] = v;
    }
    if (WANT_W) {
      for (int x = threadIdx.x; x < 4 * F; x += NW * 32) {
        float v = 0.f;
        for (int k = 0; k < tiles(n); ++k) v += s_lnt[k * 4 * F + x];
        lnpart[size_t(item) * 4 * F + x] = v;
      }
    }
    item = following;
  }
  list.leave();
}

__global__ void neighbour_kernel(const float* __restrict__ dpre, const float* __restrict__ maskf,
                                 const int* __restrict__ rev, float* __restrict__ g_aj2,
                                 int n_pad, int M, int D) {
  const int j = blockIdx.x, c = blockIdx.y, ch = threadIdx.x;
  const int* rj = rev + (size_t(c) * n_pad + j) * D;
  const float* dp = dpre + size_t(c) * n_pad * M * F2;
  const float* mk = maskf + size_t(c) * n_pad * M;
  // four entries at a time, their loads in flight together; added in the
  // table's order, a masked edge (dpre is written for live edges only)
  // skipped
  float acc = 0.f;
  for (int d0 = 0; d0 < D; d0 += 4) {
    int e[4];
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) e[u] = d0 + u < D ? rj[d0 + u] : -1;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = e[u] >= 0 && mk[e[u]] != 0.f ? dp[size_t(e[u]) * F2 + ch] : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e[u] >= 0 && mk[e[u]] != 0.f) acc += v[u];
    if (e[3] < 0) break;
  }
  g_aj2[(size_t(c) * n_pad + j) * F2 + ch] = acc;
}

constexpr int WPART = F * F2 + 2 * F * F + F2;   // g_w2 | g_wc1 | g_wg1 | g_bc1 g_bg1

constexpr int WG_TE = 32;    // edges a tile of the weight pass
constexpr int WG_NT = 256;   // its threads: (row k, quarter q) of F x 4

__host__ __device__ constexpr size_t wgrad_smem_bytes() {
  return (size_t(WG_TE) * F + 3 * size_t(WG_TE) * F2 + WG_TE) * sizeof(float);
}

__global__ void __launch_bounds__(WG_NT)
wgrad_kernel(const float* __restrict__ be, const float* __restrict__ maskf,
             const float* __restrict__ h0, const float* __restrict__ dh,
             const float* __restrict__ dpre, float* __restrict__ wpart, long long n_edges,
             int chunk) {
  extern __shared__ float smem[];
  float* sb = smem;                 // WG_TE x F
  float* sh = sb + WG_TE * F;          // WG_TE x F2
  float* sd = sh + WG_TE * F2;         // WG_TE x F2
  float* sp = sd + WG_TE * F2;         // WG_TE x F2
  float* sm = sp + WG_TE * F2;         // WG_TE
  const int t = threadIdx.x, k = t >> 2, q = t & 3;
  float gw2[32], gwc[16], gwg[16], gbias = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) gw2[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) gwc[j] = gwg[j] = 0.f;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < n_edges ? begin + chunk : n_edges;
  for (long long e_t = begin; e_t < end; e_t += WG_TE) {
    const int n = end - e_t < WG_TE ? int(end - e_t) : WG_TE;
    __syncthreads();
    if (t < WG_TE) sm[t] = t < n ? maskf[e_t + t] : 0.f;
    for (int x = t; x < n * F; x += WG_NT) sb[x] = be[e_t * F + x];
    for (int x = t; x < n * F2; x += WG_NT) {
      sh[x] = h0[e_t * F2 + x];
      sd[x] = dh[e_t * F2 + x];
      sp[x] = dpre[e_t * F2 + x];
    }
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      if (sm[e] == 0.f) continue;   // a masked edge's cotangents are 0 (not written)
      const float bk = sb[e * F + k], hck = sh[e * F2 + k], hgk = sh[e * F2 + F + k];
#pragma unroll
      for (int j = 0; j < 32; ++j) gw2[j] = fmaf(bk, sp[e * F2 + q + 4 * j], gw2[j]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        gwc[j] = fmaf(hck, sd[e * F2 + q + 4 * j], gwc[j]);
        gwg[j] = fmaf(hgk, sd[e * F2 + F + q + 4 * j], gwg[j]);
      }
      if (t < F2) gbias += sd[e * F2 + t];
    }
  }
  float* out = wpart + size_t(blockIdx.x) * WPART;
#pragma unroll
  for (int j = 0; j < 32; ++j) out[k * F2 + q + 4 * j] = gw2[j];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    out[F * F2 + k * F + q + 4 * j] = gwc[j];
    out[F * F2 + F * F + k * F + q + 4 * j] = gwg[j];
  }
  if (t < F2) out[F * F2 + 2 * F * F + t] = gbias;
}

template <int MAXM, bool WANT_W, class... Args>
cudaError_t launch_centre(int grid, int M, cudaStream_t stream, Args... args) {
  const size_t smem = centre_smem_bytes<MAXM>(M, WANT_W);
  const cudaError_t err = cudaFuncSetAttribute(
      centre_kernel<MAXM, WANT_W>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  centre_kernel<MAXM, WANT_W><<<grid, BWD_WARPS * 32, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The instantiation of the centre kernel for M slots and want_w.
template <class... Args>
cudaError_t launch_centre_for(int grid, int M, bool want_w, cudaStream_t stream,
                              Args... args) {
  switch (capacity_for(M)) {
    case SMALL_M:
      return want_w ? launch_centre<SMALL_M, true>(grid, M, stream, args...)
                    : launch_centre<SMALL_M, false>(grid, M, stream, args...);
    case MAX_M:
      return want_w ? launch_centre<MAX_M, true>(grid, M, stream, args...)
                    : launch_centre<MAX_M, false>(grid, M, stream, args...);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int MAXM, bool WANT_W>
cudaError_t centre_occupancy(int* n, int M) {
  const int smem = int(centre_smem_bytes<MAXM>(M, WANT_W));
  const cudaError_t err = cudaFuncSetAttribute(
      centre_kernel<MAXM, WANT_W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, centre_kernel<MAXM, WANT_W>,
                                                       BWD_WARPS * 32, smem);
}

}  // namespace

extern "C" int chgnet_conv_bwd(const float* ai2, const float* aj2, const float* be,
                               const float* bw, const float* maskf, const int* nbr,
                               const float* w2, const float* wc1, const float* wg1,
                               const float* bc1, const float* bg1, const float* lnc,
                               const float* lng, const float* gagg, const int* rev,
                               float* g_ai2, float* g_aj2, float* g_be, float* g_bw, float* dpre,
                               float* h0, float* dh, float* lnpart, float* wpart, int C,
                               int n_pad, int M, int F_, int D, int want_w, int n_sm,
                               int chunk, cudaStream_t stream) {
  if (F_ != F || n_sm < 1 || chunk < 1 || D < 1 || capacity_for(M) == 0)
    return int(cudaErrorInvalidValue);
  const Weights W{w2, wc1, wg1, bc1, bg1, lnc, lng};
  const int grid = grid_blocks(n_sm, BWD_BLOCKS_PER_SM, (long long)C * n_pad);
  cudaError_t err = launch_centre_for(grid, M, want_w != 0, stream, ai2, aj2, be, bw, maskf,
                                      nbr, W, gagg, g_ai2, g_be, g_bw, dpre, h0, dh, lnpart, C,
                                      n_pad, M);
  if (err != cudaSuccess) return int(err);
  neighbour_kernel<<<dim3(n_pad, C), F2, 0, stream>>>(dpre, maskf, rev, g_aj2, n_pad, M, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  if (want_w) {
    const long long n_edges = (long long)C * n_pad * M;
    const size_t wsmem = wgrad_smem_bytes();
    err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(wsmem));
    if (err != cudaSuccess) return int(err);
    wgrad_kernel<<<unsigned((n_edges + chunk - 1) / chunk), WG_NT, wsmem, stream>>>(
        be, maskf, h0, dh, dpre, wpart, n_edges, chunk);
  }
  return int(cudaGetLastError());
}

// Blocks of the centre kernel an SM holds at M slots, as its registers and
// shared memory allow (the grid counts on BWD_BLOCKS_PER_SM); -1 on an
// error.
extern "C" int chgnet_conv_bwd_blocks_per_sm(int M, int want_w) {
  int n = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (capacity_for(M)) {
    case SMALL_M:
      err = want_w ? centre_occupancy<SMALL_M, true>(&n, M)
                   : centre_occupancy<SMALL_M, false>(&n, M);
      break;
    case MAX_M:
      err = want_w ? centre_occupancy<MAX_M, true>(&n, M)
                   : centre_occupancy<MAX_M, false>(&n, M);
      break;
  }
  return err == cudaSuccess ? n : -1;
}
