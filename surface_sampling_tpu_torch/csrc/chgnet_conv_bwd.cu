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
//   centre_kernel    one block per group of centres of a chain (the
//                    forward's layout, chgnet_conv.cuh). Recomputes the
//                    forward of each tile of 32 edges, then per edge
//                        g_bw  = gagg * core * gate * maskf
//                        dy_c  = gagg * gate * bw * maskf * silu'(y_c)
//                        dy_g  = gagg * core * bw * maskf * gate (1 - gate)
//                        dh    = both LayerNorm backwards (warp shuffles)
//                        dpre  = [dh_c @ wc1^T | dh_g @ wg1^T] * silu'(pre)
//                        g_be  = dpre @ w2^T
//                    and g_ai2[i] = sum_m dpre in a fixed order. dpre
//                    (C, E, 2F) goes to device memory for the neighbour
//                    side. On request it also writes h0 and dh per edge and
//                    the block's partial LayerNorm cotangents.
//   neighbour_kernel one block per (row j, chain c), one thread per channel:
//                    g_aj2[j] = sum of dpre over the edges that read row j,
//                    walked in the reverse table (ascending edge id; a
//                    masked edge's dpre is exactly 0, so a table that
//                    also lists masked edges gives the same sum).
//                    A gather in a fixed order: no float atomics, so relaxed
//                    positions repeat bitwise.
//   wgrad_kernel     on request only (training; the forces path never
//                    asks): per chunk of edges the partial sums
//                    g_w2 = be^T dpre, g_wc1 = h0_c^T dh_c, g_wg1 =
//                    h0_g^T dh_g, g_bc1 = sum dh_c, g_bg1 = sum dh_g; the
//                    caller adds the chunks' partials in a fixed order.
//
// Bound on an H100: operations, as the forward's (chgnet_conv.cuh). The
// centre kernel recomputes the forward's two products and adds
// dh @ [wc1 | wg1]^T and dpre @ w2^T: ~70k flop per live edge; the weight
// pass adds ~33k more.

#include "chgnet_conv.cuh"

namespace {

using namespace chgconv;

__global__ void __launch_bounds__(NT, 2)
centre_kernel(const float* __restrict__ ai2, const float* __restrict__ aj2,
              const float* __restrict__ be, const float* __restrict__ bw,
              const float* __restrict__ maskf, const int* __restrict__ nbr, Weights W,
              const float* __restrict__ gagg, float* __restrict__ g_ai2,
              float* __restrict__ g_be, float* __restrict__ g_bw, float* __restrict__ dpre_out,
              float* __restrict__ h0_out, float* __restrict__ dh_out,
              float* __restrict__ lnpart, int n_pad, int M, int cpb, int want_w) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, true);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c = blockIdx.y;
  const float* aj2c = aj2 + size_t(c) * n_pad * F2;
  load_weights(W, s);
  // LayerNorm cotangent partials of this thread's channels lane + 32q:
  // [4q + 0] lnc gain, [4q + 1] lnc bias, [4q + 2] lng gain, [4q + 3] lng bias
  float lnacc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) lnacc[k] = 0.f;

  for (int ii = 0; ii < cpb; ++ii) {
    const int i = blockIdx.x * cpb + ii;
    if (i >= n_pad) break;
    const size_t ci = size_t(c) * n_pad + i;
    const size_t e0 = ci * M;
    __syncthreads();
    if (t < F2) s.ai[t] = ai2[ci * F2 + t];
    if (t < F) s.g[t] = gagg[ci * F + t];
    float acc_ai = 0.f;
    for (int m0 = 0; m0 < M; m0 += TE) {
      if (!load_tile(s, be, maskf, nbr, e0, m0, M, DirectRows{})) {
        // every edge of the tile is masked: its cotangents and dpre are
        // exactly 0 (the neighbour side may read dpre of a masked edge)
        for (int x = t; x < TE * F2; x += NT) {
          const int m = m0 + x / F2, ch = x % F2;
          if (m >= M) continue;
          dpre_out[(e0 + m) * F2 + ch] = 0.f;
          if (ch < F) g_be[(e0 + m) * F + ch] = g_bw[(e0 + m) * F + ch] = 0.f;
        }
        continue;
      }
      float acc[4][4];
      tile_pre(s, aj2c, acc);
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        const int e = warp + 8 * i4, m = m0 + e;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ch = lane + 32 * j;
          const float h = silu(acc[i4][j]);
          s.p[e * F2 + ch] = acc[i4][j];
          s.h[e * F2 + ch] = h;
          if (want_w && m < M) h0_out[(e0 + m) * F2 + ch] = h;
        }
      }
      __syncthreads();
      float hc[4][2], hg[4][2];
      tile_hidden(s, hc, hg);
      __syncthreads();   // every thread is done reading h0: s.h takes dh

#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        const int e = warp + 8 * i4, m = m0 + e;
        const float mk = s.mask[e];
        float mu_c, inv_c, mu_g, inv_g;
        ln_stats(hc[i4][0], hc[i4][1], mu_c, inv_c);
        ln_stats(hg[i4][0], hg[i4][1], mu_g, inv_g);
        float xc[2], xg[2], dxc[2], dxg[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int f = lane + 32 * q;
          xc[q] = (hc[i4][q] - mu_c) * inv_c;
          xg[q] = (hg[i4][q] - mu_g) * inv_g;
          const float yc = xc[q] * s.vec[2 * F + f] + s.vec[3 * F + f];
          const float yg = xg[q] * s.vec[4 * F + f] + s.vec[5 * F + f];
          const float sc = sigmoid(yc), core = yc * sc, gate = sigmoid(yg);
          const float bwv = m < M ? bw[(e0 + m) * F + f] : 0.f;
          const float gm = s.g[f];
          if (m < M) g_bw[(e0 + m) * F + f] = gm * core * gate * mk;
          const float scale = bwv * mk;
          const float dyc = gm * gate * scale * (sc * (1.f + yc * (1.f - sc)));
          const float dyg = gm * core * scale * (gate * (1.f - gate));
          if (want_w) {
            lnacc[4 * q + 0] += dyc * xc[q];
            lnacc[4 * q + 1] += dyc;
            lnacc[4 * q + 2] += dyg * xg[q];
            lnacc[4 * q + 3] += dyg;
          }
          dxc[q] = dyc * s.vec[2 * F + f];
          dxg[q] = dyg * s.vec[4 * F + f];
        }
        const float m1c = warp_sum(dxc[0] + dxc[1]) * (1.f / F);
        const float m2c = warp_sum(dxc[0] * xc[0] + dxc[1] * xc[1]) * (1.f / F);
        const float m1g = warp_sum(dxg[0] + dxg[1]) * (1.f / F);
        const float m2g = warp_sum(dxg[0] * xg[0] + dxg[1] * xg[1]) * (1.f / F);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int f = lane + 32 * q;
          const float dhc = inv_c * (dxc[q] - m1c - xc[q] * m2c);
          const float dhg = inv_g * (dxg[q] - m1g - xg[q] * m2g);
          s.h[e * F2 + f] = dhc;
          s.h[e * F2 + F + f] = dhg;
          if (want_w && m < M) {
            dh_out[(e0 + m) * F2 + f] = dhc;
            dh_out[(e0 + m) * F2 + F + f] = dhg;
          }
        }
      }
      __syncthreads();

      // dh0 = [dh_c @ wc1^T | dh_g @ wg1^T]: thread column lane + 32j of
      // 2F is wc1 row lane + 32j (j < 2) or wg1 row lane + 32(j - 2)
      float d[4][4];
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[i4][j] = 0.f;
#pragma unroll 4
      for (int f = 0; f < F; ++f) {
        float ac[4], ag[4];
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          ac[i4] = s.h[(warp + 8 * i4) * F2 + f];
          ag[i4] = s.h[(warp + 8 * i4) * F2 + F + f];
        }
        const float c0 = s.wc[lane * LDW1 + f], c1 = s.wc[(lane + 32) * LDW1 + f];
        const float g0 = s.wg[lane * LDW1 + f], g1 = s.wg[(lane + 32) * LDW1 + f];
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          d[i4][0] = fmaf(ac[i4], c0, d[i4][0]);
          d[i4][1] = fmaf(ac[i4], c1, d[i4][1]);
          d[i4][2] = fmaf(ag[i4], g0, d[i4][2]);
          d[i4][3] = fmaf(ag[i4], g1, d[i4][3]);
        }
      }
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        const int e = warp + 8 * i4, m = m0 + e;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ch = lane + 32 * j;
          const float p = s.p[e * F2 + ch], sp = sigmoid(p);
          const float dp = d[i4][j] * (sp * (1.f + p * (1.f - sp)));
          s.p[e * F2 + ch] = dp;   // only this thread reads or writes it here
          if (m < M) dpre_out[(e0 + m) * F2 + ch] = dp;
        }
      }
      __syncthreads();

      if (t < F2)
        for (int e = 0; e < TE; ++e) acc_ai += s.p[e * F2 + t];
      // g_be = dpre @ w2^T: thread column lane + 32q of F
      float gb[4][2];
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) gb[i4][0] = gb[i4][1] = 0.f;
#pragma unroll 4
      for (int ch = 0; ch < F2; ++ch) {
        const float b0 = s.w2[lane * LDW2 + ch], b1 = s.w2[(lane + 32) * LDW2 + ch];
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const float a = s.p[(warp + 8 * i4) * F2 + ch];
          gb[i4][0] = fmaf(a, b0, gb[i4][0]);
          gb[i4][1] = fmaf(a, b1, gb[i4][1]);
        }
      }
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        const int m = m0 + warp + 8 * i4;
        if (m < M) {
          g_be[(e0 + m) * F + lane] = gb[i4][0];
          g_be[(e0 + m) * F + lane + 32] = gb[i4][1];
        }
      }
      __syncthreads();
    }
    if (t < F2) g_ai2[ci * F2 + t] = acc_ai;
  }

  if (want_w) {
    // the warps' LayerNorm partials, added in warp order
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) s.a[warp * 4 * F + r * F + lane + 32 * q] = lnacc[4 * q + r];
    __syncthreads();
    float v = 0.f;
    for (int w = 0; w < NT / 32; ++w) v += s.a[w * 4 * F + t];
    lnpart[(size_t(blockIdx.y) * gridDim.x + blockIdx.x) * 4 * F + t] = v;
  }
}

__global__ void neighbour_kernel(const float* __restrict__ dpre, const int* __restrict__ rev,
                                 float* __restrict__ g_aj2, int n_pad, int M, int D) {
  const int j = blockIdx.x, c = blockIdx.y, ch = threadIdx.x;
  const int* rj = rev + (size_t(c) * n_pad + j) * D;
  const float* dp = dpre + size_t(c) * n_pad * M * F2;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) {
    const int e = rj[d];
    if (e < 0) break;
    acc += dp[size_t(e) * F2 + ch];
  }
  g_aj2[(size_t(c) * n_pad + j) * F2 + ch] = acc;
}

constexpr int WPART = F * F2 + 2 * F * F + F2;   // g_w2 | g_wc1 | g_wg1 | g_bc1 g_bg1

__host__ __device__ constexpr size_t wgrad_smem_bytes() {
  return (size_t(TE) * F + 3 * size_t(TE) * F2 + TE) * sizeof(float);
}

__global__ void __launch_bounds__(NT)
wgrad_kernel(const float* __restrict__ be, const float* __restrict__ maskf,
             const float* __restrict__ h0, const float* __restrict__ dh,
             const float* __restrict__ dpre, float* __restrict__ wpart, long long n_edges,
             int chunk) {
  extern __shared__ float smem[];
  float* sb = smem;                 // TE x F
  float* sh = sb + TE * F;          // TE x F2
  float* sd = sh + TE * F2;         // TE x F2
  float* sp = sd + TE * F2;         // TE x F2
  float* sm = sp + TE * F2;         // TE
  const int t = threadIdx.x, k = t >> 2, q = t & 3;
  float gw2[32], gwc[16], gwg[16], gbias = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) gw2[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) gwc[j] = gwg[j] = 0.f;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < n_edges ? begin + chunk : n_edges;
  for (long long e_t = begin; e_t < end; e_t += TE) {
    const int n = end - e_t < TE ? int(end - e_t) : TE;
    __syncthreads();
    if (t < TE) sm[t] = t < n ? maskf[e_t + t] : 0.f;
    for (int x = t; x < n * F; x += NT) sb[x] = be[e_t * F + x];
    for (int x = t; x < n * F2; x += NT) {
      sh[x] = h0[e_t * F2 + x];
      sd[x] = dh[e_t * F2 + x];
      sp[x] = dpre[e_t * F2 + x];
    }
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      if (sm[e] == 0.f) continue;   // a masked edge's cotangents are 0 (never written)
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

}  // namespace

extern "C" int chgnet_conv_bwd(const float* ai2, const float* aj2, const float* be,
                               const float* bw, const float* maskf, const int* nbr,
                               const float* w2, const float* wc1, const float* wg1,
                               const float* bc1, const float* bg1, const float* lnc,
                               const float* lng, const float* gagg, const int* rev,
                               float* g_ai2, float* g_aj2, float* g_be, float* g_bw, float* dpre,
                               float* h0, float* dh, float* lnpart, float* wpart, int C,
                               int n_pad, int M, int F_, int D, int want_w, int cpb, int chunk,
                               cudaStream_t stream) {
  if (F_ != F || cpb < 1 || chunk < 1 || D < 1) return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(true);
  cudaError_t err =
      cudaFuncSetAttribute(centre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n_pad + cpb - 1) / cpb, C);
  centre_kernel<<<grid, NT, smem, stream>>>(
      ai2, aj2, be, bw, maskf, nbr, Weights{w2, wc1, wg1, bc1, bg1, lnc, lng}, gagg, g_ai2,
      g_be, g_bw, dpre, h0, dh, lnpart, n_pad, M, cpb, want_w);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  neighbour_kernel<<<dim3(n_pad, C), F2, 0, stream>>>(dpre, rev, g_aj2, n_pad, M, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  if (want_w) {
    const long long n_edges = (long long)C * n_pad * M;
    const size_t wsmem = wgrad_smem_bytes();
    err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(wsmem));
    if (err != cudaSuccess) return int(err);
    wgrad_kernel<<<unsigned((n_edges + chunk - 1) / chunk), NT, wsmem, stream>>>(
        be, maskf, h0, dh, dpre, wpart, n_edges, chunk);
  }
  return int(cudaGetLastError());
}
