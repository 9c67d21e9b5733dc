// Second-order backward of the general PaiNN message block: the VJP of the
// message backward (painn_message_bwd), batched over chains C and ensemble
// members K. Given the forward's inputs, the first-order cotangents g_ds /
// g_dv, and cotangents of the backward's seven outputs (c_phi, c_vcat,
// c_rbf, c_envm, c_unit, c_dw, c_db), it returns the cotangents of the
// backward's ten float inputs: d_phi, d_vcat, d_rbf, d_envm, d_unit, d_dw,
// d_db, d_gds and d_gdv. This is the outer reverse pass of force-loss
// training, which differentiates the forces F = -dE/dx over the parameters.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py, _message_bwd2_pallas
// (kernel _msg_bwd2_kernel), the custom-VJP backward of _message_bwd_op.
// The TPU kernel routes neighbour rows through one-hot MXU products and
// accumulates the neighbour and weight cotangents into output blocks pinned
// across a sequential grid; here rows are read by index and the work is
// split by who owns each output, as in the first-order backward
// (painn_message_bwd.cuh):
//
//   center_kernel    one block per (center i, chain c), one thread per
//                    channel f, looping over the members k in order. Emits
//                    the per-edge d_rbf (C, E, R), d_envm (C, E) and d_unit
//                    (C, 3, n_pad, M), summed over the members inside the
//                    block (R + 4 sums over the channels per edge, by the
//                    warp reduce-scatter of warp_reduce.cuh), the
//                    per-center d_gds and d_gdv, and the block's partial
//                    d_dw / d_db (R + 1, 3F) per member, which the caller
//                    sums over blocks in one fixed order.
//   neighbor_kernel  one block per (table row j, member k, chain c), one
//                    thread per channel f: d_phi and d_vcat of row j, summed
//                    over the edges that read row j, walked in the reverse
//                    table, recomputing the filter there. No float atomics,
//                    so the results repeat bitwise.
//
// Per edge e = (i, m), neighbour row j, channel f, channels t = vv, s, u
// (the derivation: the scalar S = <c, B(inputs, g)> of the first-order
// backward B is expanded per edge and differentiated term by term):
//     wpre_t = rbf[e] . dw[:, tF+f] + db[tF+f],   w_t = wpre_t envm[e]
//     P_t = phi[j, tF+f],  V_x = vcat[j, xF+f],  Cp_t = c_phi[j, tF+f],
//     Cv_x = c_vcat[j, xF+f],  u_x = unit[x, e],  cu_x = c_unit[x, e]
//     g_vv = sum_x g_dv[i, xF+f] V_x,  g_s = g_ds[i, f],
//     g_u = sum_x g_dv[i, xF+f] u_x                      (first order)
//     G_t = c_rbf[e] . dw[:, tF+f] + rbf[e] . c_dw[:, tF+f] + c_db[tF+f]
//     H_t = G_t envm + c_envm[e] wpre_t,   Q_t = Cp_t w_t + H_t P_t
//     T_vv = sum_x Cv_x g_dv[i, xF+f],  T_s = 0,  T_u = sum_x cu_x g_dv[i, xF+f]
//     A_t = g_t Cp_t + T_t P_t
//     dwpre_t = A_t envm + g_t P_t c_envm,   Z_t = g_t P_t envm
//   then
//     d_gds[i, f]     = sum_m Q_s
//     d_gdv[i, xF+f]  = sum_m (Q_vv V_x + Q_u u_x + Cv_x P_vv w_vv + cu_x P_u w_u)
//     d_unit[x, e]    = sum_f g_dv[i, xF+f] Q_u
//     d_envm[e]       = sum_{t,f} (A_t wpre_t + g_t P_t G_t)
//     d_rbf[e, r]     = sum_{t,f} (dwpre_t dw[r, tF+f] + Z_t c_dw[r, tF+f])
//     d_dw[r, tF+f]   = sum_e (rbf[e, r] dwpre_t + c_rbf[e, r] Z_t)
//     d_db[tF+f]      = sum_e dwpre_t
//     d_phi[j, tF+f]  = sum_{e -> j} (H_t g_t + T_t w_t)
//     d_vcat[j, xF+f] = sum_{e -> j} g_dv[i, xF+f] Q_vv
//
// HAS_CDW: force-loss training never consumes the backward's g_dw / g_db
// (the forces depend on positions through rbf, envm and unit only), so c_dw
// and c_db arrive as nothing; without them the terms rbf . c_dw and c_db of
// G and Z . c_dw of d_rbf vanish and the kernels skip them. With them,
// c_dw of the member sits in shared memory (center) or registers
// (neighbour).
//
// The reverse-table contract: d_phi and d_vcat at an edge left out of the
// table are H_t g_t + T_t w_t and g_dv Q_vv; at envm = 0 (w = 0) these are
// c_envm wpre g_t and g_dv c_envm wpre P_vv, zero only where c_envm is 0
// too. So an edge may be left out only if envm == 0 and c_envm == 0 there.
// In training both hold at masked edges: the cotangent reaching g_envm
// passes back through envm = envelope * mask.
//
// Bound on an H100: operations. Per edge, channel and member the kernels
// recompute the filter (3 x 2R multiply-adds) and G (another 3 x 2R, twice
// that with c_dw), and the center kernel adds the d_rbf product (3 x 2R)
// and the d_dw partials (3 x 4R); the feature tables of one (chain,
// member) stay in L2 while they are read. First version, right and simple:
// no tensor cores and no TMA. Each thread keeps its three dist_embed
// columns (3R floats) and, in the center kernel, its d_dw partials (3R) in
// registers; the center's edge rows sit in shared memory and are read as
// broadcasts.

#include <cuda_runtime.h>

#include "warp_reduce.cuh"

namespace msgbwd2 {

struct Args {
  const float *phi, *vcat, *rbf, *envm;
  const int* nbr;
  const float *unit, *dw, *db, *gds, *gdv;
  const float *cphi, *cvcat, *crbf, *cenvm, *cunit, *cdw, *cdb;
  const int* rev;
  float *dphi, *dvcat, *drbf, *denvm, *dunit, *dgds, *dgdv, *ddw_part;
  int C, K, n_pad, M, F, D;
};

template <int R, bool HAS_CDW>
__global__ void __launch_bounds__(128, 2) center_kernel(Args a) {
  static_assert(R + 4 <= 32, "R + 4 sums per edge must fit one warp's 32 slots");
  const int n_pad = a.n_pad, M = a.M, F = a.F, K = a.K;
  const int i = blockIdx.x, c = blockIdx.y;
  const int f = threadIdx.x, lane = f & 31, warp = f >> 5;
  const int n_warps = blockDim.x >> 5;
  const int F3 = 3 * F;
  const bool live = f < F;

  extern __shared__ float smem[];
  float* s_rbf = smem;                          // M * R
  float* s_crbf = s_rbf + M * R;                // M * R
  float* s_env = s_crbf + M * R;                // M
  float* s_cenv = s_env + M;                    // M
  float* s_unit = s_cenv + M;                   // 3 * M
  float* s_cunit = s_unit + 3 * M;              // 3 * M
  float* s_part = s_cunit + 3 * M;              // M * n_warps * 32
  float* s_acc = s_part + M * n_warps * 32;     // M * 32
  float* s_cdw = s_acc + M * 32;                // R * 3F with c_dw, else empty
  int* s_row = reinterpret_cast<int*>(s_cdw + (HAS_CDW ? R * F3 : 0));  // M

  const size_t e0 = (size_t(c) * n_pad + i) * M;
  for (int t = f; t < M * R; t += blockDim.x) {
    s_rbf[t] = a.rbf[e0 * R + t];
    s_crbf[t] = a.crbf[e0 * R + t];
  }
  for (int t = f; t < M * 32; t += blockDim.x) s_acc[t] = 0.f;
  for (int t = f; t < M; t += blockDim.x) {
    s_env[t] = a.envm[e0 + t];
    s_cenv[t] = a.cenvm[e0 + t];
    s_row[t] = a.nbr[e0 + t];
    for (int x = 0; x < 3; ++x) {
      const size_t u = ((size_t(c) * 3 + x) * n_pad + i) * M + t;
      s_unit[x * M + t] = a.unit[u];
      s_cunit[x * M + t] = a.cunit[u];
    }
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const float* dwk = a.dw + size_t(k) * R * F3;
    const float* dbk = a.db + size_t(k) * F3;
    float wv[R], wsc[R], wu[R];
    float bv = 0.f, bs = 0.f, bu = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wv[r] = live ? dwk[r * F3 + f] : 0.f;
      wsc[r] = live ? dwk[r * F3 + F + f] : 0.f;
      wu[r] = live ? dwk[r * F3 + 2 * F + f] : 0.f;
    }
    if (live) { bv = dbk[f]; bs = dbk[F + f]; bu = dbk[2 * F + f]; }
    float cbv = 0.f, cbs = 0.f, cbu = 0.f;
    if constexpr (HAS_CDW) {
      // the previous member's readers of s_cdw are past its closing barrier
      for (int t = f; t < R * F3; t += blockDim.x) s_cdw[t] = a.cdw[size_t(k) * R * F3 + t];
      if (live) {
        const float* cdbk = a.cdb + size_t(k) * F3;
        cbv = cdbk[f]; cbs = cdbk[F + f]; cbu = cdbk[2 * F + f];
      }
      __syncthreads();
    }

    const size_t plane = (size_t(c) * K + k) * n_pad;    // first row of (c, k)
    const float* phik = a.phi + plane * F3;
    const float* vk = a.vcat + plane * F3;
    const float* cpk = a.cphi + plane * F3;
    const float* cvk = a.cvcat + plane * F3;
    float g_s = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
    if (live) {
      g_s = a.gds[(plane + i) * F + f];
      const float* gdvi = a.gdv + (plane + i) * F3;
      gx = gdvi[f]; gy = gdvi[F + f]; gz = gdvi[2 * F + f];
    }
    float dgs = 0.f, dgx = 0.f, dgy = 0.f, dgz = 0.f;
    float ddv[R], dds[R], ddu[R];
#pragma unroll
    for (int r = 0; r < R; ++r) { ddv[r] = 0.f; dds[r] = 0.f; ddu[r] = 0.f; }
    float dbv = 0.f, dbs = 0.f, dbu = 0.f;

    for (int m = 0; m < M; ++m) {
      float v[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) v[t] = 0.f;
      if (live) {
        const size_t j = size_t(s_row[m]) * F3;
        const float pv = phik[j + f], ps = phik[j + F + f], pu = phik[j + 2 * F + f];
        const float qx = vk[j + f], qy = vk[j + F + f], qz = vk[j + 2 * F + f];
        const float cpv = cpk[j + f], cps = cpk[j + F + f], cpu = cpk[j + 2 * F + f];
        const float cqx = cvk[j + f], cqy = cvk[j + F + f], cqz = cvk[j + 2 * F + f];
        const float* q = s_rbf + m * R;
        const float* cq = s_crbf + m * R;
        float tv = 0.f, ts = 0.f, tu = 0.f, hv = 0.f, hs = 0.f, hu = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          tv = fmaf(q[r], wv[r], tv);
          ts = fmaf(q[r], wsc[r], ts);
          tu = fmaf(q[r], wu[r], tu);
          hv = fmaf(cq[r], wv[r], hv);
          hs = fmaf(cq[r], wsc[r], hs);
          hu = fmaf(cq[r], wu[r], hu);
        }
        if constexpr (HAS_CDW) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            hv = fmaf(q[r], s_cdw[r * F3 + f], hv);
            hs = fmaf(q[r], s_cdw[r * F3 + F + f], hs);
            hu = fmaf(q[r], s_cdw[r * F3 + 2 * F + f], hu);
          }
          hv += cbv; hs += cbs; hu += cbu;
        }
        const float env = s_env[m], cenv = s_cenv[m];
        const float ux = s_unit[m], uy = s_unit[M + m], uz = s_unit[2 * M + m];
        const float cux = s_cunit[m], cuy = s_cunit[M + m], cuz = s_cunit[2 * M + m];
        const float pre_v = tv + bv, pre_s = ts + bs, pre_u = tu + bu;
        const float w_v = pre_v * env, w_s = pre_s * env, w_u = pre_u * env;
        const float gi_v = gx * qx + gy * qy + gz * qz;
        const float gi_u = gx * ux + gy * uy + gz * uz;
        const float h_v = hv * env + cenv * pre_v;
        const float h_s = hs * env + cenv * pre_s;
        const float h_u = hu * env + cenv * pre_u;
        const float q_v = cpv * w_v + h_v * pv;
        const float q_s = cps * w_s + h_s * ps;
        const float q_u = cpu * w_u + h_u * pu;
        const float t_v = gx * cqx + gy * cqy + gz * cqz;
        const float t_u = gx * cux + gy * cuy + gz * cuz;
        const float c_vv = pv * w_v, c_u = pu * w_u;
        dgs += q_s;
        dgx += q_v * qx + q_u * ux + cqx * c_vv + cux * c_u;
        dgy += q_v * qy + q_u * uy + cqy * c_vv + cuy * c_u;
        dgz += q_v * qz + q_u * uz + cqz * c_vv + cuz * c_u;
        const float a_v = gi_v * cpv + t_v * pv, a_s = g_s * cps, a_u = gi_u * cpu + t_u * pu;
        const float gp_v = gi_v * pv, gp_s = g_s * ps, gp_u = gi_u * pu;
        const float dp_v = a_v * env + gp_v * cenv;
        const float dp_s = a_s * env + gp_s * cenv;
        const float dp_u = a_u * env + gp_u * cenv;
        const float z_v = gp_v * env, z_s = gp_s * env, z_u = gp_u * env;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ddv[r] = fmaf(cq[r], z_v, fmaf(q[r], dp_v, ddv[r]));
          dds[r] = fmaf(cq[r], z_s, fmaf(q[r], dp_s, dds[r]));
          ddu[r] = fmaf(cq[r], z_u, fmaf(q[r], dp_u, ddu[r]));
        }
        dbv += dp_v; dbs += dp_s; dbu += dp_u;
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = dp_v * wv[r] + dp_s * wsc[r] + dp_u * wu[r];
        if constexpr (HAS_CDW) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            v[r] += z_v * s_cdw[r * F3 + f] + z_s * s_cdw[r * F3 + F + f] +
                    z_u * s_cdw[r * F3 + 2 * F + f];
        }
        v[R] = a_v * pre_v + a_s * pre_s + a_u * pre_u + gp_v * hv + gp_s * hs + gp_u * hu;
        v[R + 1] = gx * q_u;
        v[R + 2] = gy * q_u;
        v[R + 3] = gz * q_u;
      }
      s_part[(m * n_warps + warp) * 32 + lane] = warp_reduce::reduce_scatter32(v, lane);
    }
    __syncthreads();
    // warps' partials in warp order, then members in member order
    for (int t = f; t < M * 32; t += blockDim.x) {
      const int m = t >> 5, l = t & 31;
      float sum = 0.f;
      for (int w = 0; w < n_warps; ++w) sum += s_part[(m * n_warps + w) * 32 + l];
      s_acc[t] += sum;
    }
    __syncthreads();

    if (live) {
      a.dgds[(plane + i) * F + f] = dgs;
      float* gv = a.dgdv + (plane + i) * F3;
      gv[f] = dgx; gv[F + f] = dgy; gv[2 * F + f] = dgz;
      float* out = a.ddw_part + ((size_t(c) * n_pad + i) * K + k) * (R + 1) * F3;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        out[r * F3 + f] = ddv[r];
        out[r * F3 + F + f] = dds[r];
        out[r * F3 + 2 * F + f] = ddu[r];
      }
      out[R * F3 + f] = dbv;
      out[R * F3 + F + f] = dbs;
      out[R * F3 + 2 * F + f] = dbu;
    }
  }

  for (int t = f; t < M * R; t += blockDim.x) {
    const int m = t / R, r = t - m * R;
    a.drbf[e0 * R + t] = s_acc[m * 32 + r];
  }
  for (int t = f; t < M; t += blockDim.x) {
    a.denvm[e0 + t] = s_acc[t * 32 + R];
    for (int x = 0; x < 3; ++x)
      a.dunit[((size_t(c) * 3 + x) * n_pad + i) * M + t] = s_acc[t * 32 + R + 1 + x];
  }
}

template <int R, bool HAS_CDW>
__global__ void neighbor_kernel(Args a) {
  const int n_pad = a.n_pad, M = a.M, F = a.F, K = a.K;
  const int j = blockIdx.x, k = blockIdx.y, c = blockIdx.z;
  const int f = threadIdx.x;
  if (f >= F) return;
  const int F3 = 3 * F;
  const size_t E = size_t(n_pad) * M;

  const float* dwk = a.dw + size_t(k) * R * F3;
  float wv[R], wsc[R], wu[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wv[r] = dwk[r * F3 + f];
    wsc[r] = dwk[r * F3 + F + f];
    wu[r] = dwk[r * F3 + 2 * F + f];
  }
  const float* dbk = a.db + size_t(k) * F3;
  const float bv = dbk[f], bs = dbk[F + f], bu = dbk[2 * F + f];
  float cwv[HAS_CDW ? R : 1], cws[HAS_CDW ? R : 1], cwu[HAS_CDW ? R : 1];
  float cbv = 0.f, cbs = 0.f, cbu = 0.f;
  if constexpr (HAS_CDW) {
    const float* cdwk = a.cdw + size_t(k) * R * F3;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cwv[r] = cdwk[r * F3 + f];
      cws[r] = cdwk[r * F3 + F + f];
      cwu[r] = cdwk[r * F3 + 2 * F + f];
    }
    const float* cdbk = a.cdb + size_t(k) * F3;
    cbv = cdbk[f]; cbs = cdbk[F + f]; cbu = cdbk[2 * F + f];
  }

  const size_t plane = (size_t(c) * K + k) * n_pad;
  const size_t row = (plane + j) * F3;
  const float pv = a.phi[row + f];
  const float vx = a.vcat[row + f], vy = a.vcat[row + F + f], vz = a.vcat[row + 2 * F + f];
  const float cpv = a.cphi[row + f];
  const float cvx = a.cvcat[row + f], cvy = a.cvcat[row + F + f], cvz = a.cvcat[row + 2 * F + f];

  float a_v = 0.f, a_s = 0.f, a_u = 0.f, a_x = 0.f, a_y = 0.f, a_z = 0.f;
  const int* rj = a.rev + (size_t(c) * n_pad + j) * a.D;
  for (int d = 0; d < a.D; ++d) {
    const int e = __ldg(rj + d);
    if (e < 0) break;                        // the same for every thread
    const int i = e / M, m = e - i * M;
    const float* q = a.rbf + (size_t(c) * E + e) * R;
    const float* cq = a.crbf + (size_t(c) * E + e) * R;
    float tv = 0.f, ts = 0.f, tu = 0.f, hv = 0.f, hs = 0.f, hu = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float qr = __ldg(q + r), cqr = __ldg(cq + r);
      tv = fmaf(qr, wv[r], tv);
      ts = fmaf(qr, wsc[r], ts);
      tu = fmaf(qr, wu[r], tu);
      hv = fmaf(cqr, wv[r], hv);
      hs = fmaf(cqr, wsc[r], hs);
      hu = fmaf(cqr, wu[r], hu);
      if constexpr (HAS_CDW) {
        hv = fmaf(qr, cwv[r], hv);
        hs = fmaf(qr, cws[r], hs);
        hu = fmaf(qr, cwu[r], hu);
      }
    }
    hv += cbv; hs += cbs; hu += cbu;
    const float env = __ldg(a.envm + size_t(c) * E + e);
    const float cenv = __ldg(a.cenvm + size_t(c) * E + e);
    const float pre_v = tv + bv, pre_s = ts + bs, pre_u = tu + bu;
    const float w_v = pre_v * env, w_u = pre_u * env;
    const float h_v = hv * env + cenv * pre_v;
    const float h_s = hs * env + cenv * pre_s;
    const float h_u = hu * env + cenv * pre_u;
    const size_t ri = plane + i;
    const float g_s = a.gds[ri * F + f];
    const float gx = a.gdv[ri * F3 + f], gy = a.gdv[ri * F3 + F + f], gz = a.gdv[ri * F3 + 2 * F + f];
    float ux, uy, uz, cux, cuy, cuz;
    {
      const size_t u0 = (size_t(c) * 3 * n_pad + i) * M + m, us = size_t(n_pad) * M;
      ux = __ldg(a.unit + u0); uy = __ldg(a.unit + u0 + us); uz = __ldg(a.unit + u0 + 2 * us);
      cux = __ldg(a.cunit + u0); cuy = __ldg(a.cunit + u0 + us); cuz = __ldg(a.cunit + u0 + 2 * us);
    }
    const float gi_v = gx * vx + gy * vy + gz * vz;
    const float gi_u = gx * ux + gy * uy + gz * uz;
    const float t_v = gx * cvx + gy * cvy + gz * cvz;
    const float t_u = gx * cux + gy * cuy + gz * cuz;
    a_v += h_v * gi_v + t_v * w_v;
    a_s += h_s * g_s;
    a_u += h_u * gi_u + t_u * w_u;
    const float q_v = cpv * w_v + h_v * pv;
    a_x += gx * q_v;
    a_y += gy * q_v;
    a_z += gz * q_v;
  }
  a.dphi[row + f] = a_v;
  a.dphi[row + F + f] = a_s;
  a.dphi[row + 2 * F + f] = a_u;
  a.dvcat[row + f] = a_x;
  a.dvcat[row + F + f] = a_y;
  a.dvcat[row + 2 * F + f] = a_z;
}

template <int R, bool HAS_CDW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int threads = ((a.F + 31) / 32) * 32;
  const int n_warps = threads / 32;
  const size_t shmem =
      (size_t(a.M) * (2 * R + 8 + n_warps * 32 + 32) + (HAS_CDW ? size_t(R) * 3 * a.F : 0)) *
          sizeof(float) +
      size_t(a.M) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(center_kernel<R, HAS_CDW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(shmem));
  if (err != cudaSuccess) return err;
  center_kernel<R, HAS_CDW><<<dim3(a.n_pad, a.C), threads, shmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  neighbor_kernel<R, HAS_CDW><<<dim3(a.n_pad, a.K, a.C), threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_r(const Args& a, int has_cdw, cudaStream_t stream) {
  return has_cdw ? launch<R, true>(a, stream) : launch<R, false>(a, stream);
}

}  // namespace msgbwd2

// Launches both kernels for a radial width R of 8, 16 or 24 and returns the
// first CUDA error (a refused launch never runs). c_dw / c_db are read only
// when has_cdw is set.
extern "C" int painn_message_bwd2(
    const float* phi, const float* vcat, const float* rbf, const float* envm,
    const int* nbr, const float* unit, const float* dw, const float* db,
    const float* gds, const float* gdv, const float* cphi, const float* cvcat,
    const float* crbf, const float* cenvm, const float* cunit, const float* cdw,
    const float* cdb, const int* rev, float* dphi, float* dvcat, float* drbf,
    float* denvm, float* dunit, float* dgds, float* dgdv, float* ddw_part,
    int C, int K, int n_pad, int M, int R, int F, int D, int has_cdw,
    cudaStream_t stream) {
  const msgbwd2::Args a{phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv,
                        cphi, cvcat, crbf, cenvm, cunit, cdw, cdb, rev,
                        dphi, dvcat, drbf, denvm, dunit, dgds, dgdv, ddw_part,
                        C, K, n_pad, M, F, D};
  cudaError_t err;
  switch (R) {
    case 8: err = msgbwd2::launch_r<8>(a, has_cdw, stream); break;
    case 16: err = msgbwd2::launch_r<16>(a, has_cdw, stream); break;
    case 24: err = msgbwd2::launch_r<24>(a, has_cdw, stream); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(err);
}
