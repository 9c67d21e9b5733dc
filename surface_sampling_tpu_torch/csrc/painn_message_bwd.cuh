// Backward of the general PaiNN message block, batched over chains C and
// ensemble members K: the cotangents of every input given the cotangents
// g_ds (C, K, n_pad, F) and g_dv (C, K, n_pad, 3F). Shared by
// painn_message_bwd.cu (neighbour j read from row nbr[e] of the table) and
// painn_message_bwd_banded.cu (a supercell: neighbour rank r read from row
// s + ((r - s) mod n_pad) of the sorted table extended by the band's halo,
// for the window start s of the centre's block; an edge outside its window
// reads zeros, as the TPU kernel's one-hot router does).
//
// The TPU kernels (surface_sampling_tpu/ops/pallas_painn.py,
// _msg_bwd_kernel and _msg_bwd_kernel_banded) scatter neighbour cotangents
// through transposed one-hot matmuls into output blocks pinned across a
// sequential grid; neither exists here, so the work is split by who owns
// each output:
//
//   center_kernel    one block per (center i, chain c), one thread per
//                    channel f, looping over the members k. Emits the
//                    per-edge cotangents g_rbf (C, E, R), g_envm (C, E) and
//                    g_unit (C, 3, n_pad, M). rbf / envm / unit carry no
//                    member axis, so their cotangents sum over k: the sum is
//                    taken inside the block, k = 0, 1, ... in order. Each
//                    edge needs R + 4 sums over the 3F channels: a warp
//                    reduce-scatter (31 shuffles for 32 sums) leaves slot l's
//                    warp sum in lane l, and the warps' partials are added in
//                    warp order from shared memory. On request (training),
//                    each block also writes its partial g_dw / g_db
//                    (R + 1, 3F) per member; the caller sums the partials over
//                    blocks in a fixed order. The forces path never asks.
//   neighbor_kernel  one block per (table row j, member k, chain c), one
//                    thread per channel f. g_phi and g_vcat of row j are sums
//                    over the edges e = (i, m) that read row j: the block
//                    walks j's entries in the reverse table (ascending edge
//                    id; unselected edges left out) and recomputes the filter
//                    w_e and g_inv_e there. A gather in a fixed order: no
//                    float atomics, so results repeat bitwise. In the banded
//                    layout the table has n_pad + halo rows and the reverse
//                    table is keyed by extended row, so a slot read as row r
//                    by one window and as row r + n_pad by another gets two
//                    rows of cotangents, which the caller folds.
//
// Per edge e = (i, m), neighbour row j, channel f, with t = vv, s, unit:
//     wpre_t = rbf[e] . dw[:, tF + f] + db[tF + f],   w_t = wpre_t * envm[e]
//     g_c_vv = sum_x g_dv[i, xF + f] * vcat[j, xF + f]
//     g_c_s  = g_ds[i, f]
//     g_c_u  = sum_x g_dv[i, xF + f] * unit[x, i, m]
//     g_phi[j, tF + f]  += g_c_t * w_t
//     g_vcat[j, xF + f] += g_dv[i, xF + f] * phi[j, f] * w_vv
//     g_w_t = g_c_t * phi[j, tF + f],   gwe_t = g_w_t * envm[e]
//     g_envm[e]    = sum_{t,f} g_w_t * wpre_t
//     g_rbf[e, r]  = sum_{t,f} gwe_t * dw[r, tF + f]
//     g_unit[x, e] = sum_f g_dv[i, xF + f] * phi[j, 2F + f] * w_u
//     g_dw[r, tF + f] = sum_e rbf[e, r] * gwe_t,   g_db[tF + f] = sum_e gwe_t
//
// Bound on an H100: operations. Both kernels recompute the radial filter
// (2R multiply-adds per channel and edge, 3F channels); the center kernel
// adds the g_rbf product (another 2R per channel and edge) and the g_dw
// product when asked. The tables phi, vcat, g_ds and g_dv of one
// (chain, member) stay in L2 while they are read.
//
// First version, right and simple: no tensor cores and no TMA. Each thread
// keeps its three dist_embed columns (3R floats) in registers; the center's
// edge rows sit in shared memory and are read as broadcasts.

#pragma once

#include <cuda_runtime.h>

#include "painn_band.cuh"
#include "warp_reduce.cuh"

namespace msgbwd {

// Where each (chain, member) plane of the tables starts and how an edge
// finds its neighbour's row. phi / vcat / g_phi / g_vcat have n_tab rows a
// plane (n_pad, or n_pad + halo in the banded layout); g_ds / g_dv have
// n_pad. ws == nullptr: the row is nbr[e]. Otherwise centre i reads from
// the window that starts at ws[i / n_blk] and is W rows wide.
struct Layout {
  int n_pad, n_tab, M, F;
  const int* ws;
  int n_blk, W;
};

// At most 128 threads (F <= 128); the register cap keeps three blocks
// (twelve warps) on an SM to hide the latency of the neighbour gathers.
template <int R, bool WANT_DW>
__global__ void __launch_bounds__(128, WANT_DW ? 2 : 3) center_kernel(
    const float* __restrict__ phi, const float* __restrict__ vcat,
    const float* __restrict__ rbf, const float* __restrict__ envm,
    const int* __restrict__ nbr, const float* __restrict__ unit,
    const float* __restrict__ dw, const float* __restrict__ db,
    const float* __restrict__ gds, const float* __restrict__ gdv,
    float* __restrict__ g_rbf, float* __restrict__ g_envm,
    float* __restrict__ g_unit, float* __restrict__ gdw_part, int K, Layout L) {
  static_assert(R + 4 <= 32, "R + 4 sums per edge must fit one warp's 32 slots");
  const int n_pad = L.n_pad, M = L.M, F = L.F;
  const int i = blockIdx.x, c = blockIdx.y;
  const int f = threadIdx.x, lane = f & 31, warp = f >> 5;
  const int n_warps = blockDim.x >> 5;
  const int F3 = 3 * F;
  const bool live = f < F;

  extern __shared__ float smem[];
  float* s_rbf = smem;                          // M * R
  float* s_env = s_rbf + M * R;                 // M
  float* s_unit = s_env + M;                    // 3 * M
  float* s_part = s_unit + 3 * M;               // M * n_warps * 32
  float* s_acc = s_part + M * n_warps * 32;     // M * 32
  int* s_row = reinterpret_cast<int*>(s_acc + M * 32);  // M, -1: reads zeros

  const size_t e0 = (size_t(c) * n_pad + i) * M;
  const int s_win = L.ws ? L.ws[i / L.n_blk] : 0;
  for (int t = f; t < M * R; t += blockDim.x) s_rbf[t] = rbf[e0 * R + t];
  for (int t = f; t < M * 32; t += blockDim.x) s_acc[t] = 0.f;
  for (int t = f; t < M; t += blockDim.x) {
    s_env[t] = envm[e0 + t];
    const int r = nbr[e0 + t];
    s_row[t] = L.ws ? banded::window_row(r, s_win, n_pad, L.W) : r;
    for (int x = 0; x < 3; ++x)
      s_unit[x * M + t] = unit[((size_t(c) * 3 + x) * n_pad + i) * M + t];
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const float* dwk = dw + size_t(k) * R * F3;
    const float* dbk = db + size_t(k) * F3;
    float wv[R], wsc[R], wu[R];
    float bv = 0.f, bs = 0.f, bu = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wv[r] = live ? dwk[r * F3 + f] : 0.f;
      wsc[r] = live ? dwk[r * F3 + F + f] : 0.f;
      wu[r] = live ? dwk[r * F3 + 2 * F + f] : 0.f;
    }
    if (live) { bv = dbk[f]; bs = dbk[F + f]; bu = dbk[2 * F + f]; }

    const size_t tplane = (size_t(c) * K + k) * L.n_tab;   // first table row of (c, k)
    const size_t cplane = (size_t(c) * K + k) * n_pad;     // first centre row of (c, k)
    const float* phik = phi + tplane * F3;
    const float* vk = vcat + tplane * F3;
    float g_s = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
    if (live) {
      g_s = gds[(cplane + i) * F + f];
      const float* gdvi = gdv + (cplane + i) * F3;
      gx = gdvi[f]; gy = gdvi[F + f]; gz = gdvi[2 * F + f];
    }
    float dwv[WANT_DW ? R : 1], dws[WANT_DW ? R : 1], dwu[WANT_DW ? R : 1];
    float dbv = 0.f, dbs = 0.f, dbu = 0.f;
    if constexpr (WANT_DW) {
#pragma unroll
      for (int r = 0; r < R; ++r) { dwv[r] = 0.f; dws[r] = 0.f; dwu[r] = 0.f; }
    }

    // the neighbour row's six values are loaded one edge ahead, so the
    // gather's latency overlaps the previous edge's arithmetic; an edge
    // outside its window reads zeros
    float pv = 0.f, ps = 0.f, pu = 0.f, qx = 0.f, qy = 0.f, qz = 0.f;
    if (live && s_row[0] >= 0) {
      const size_t j = size_t(s_row[0]) * F3;
      pv = phik[j + f]; ps = phik[j + F + f]; pu = phik[j + 2 * F + f];
      qx = vk[j + f]; qy = vk[j + F + f]; qz = vk[j + 2 * F + f];
    }
    for (int m = 0; m < M; ++m) {
      float npv = 0.f, nps = 0.f, npu = 0.f, nqx = 0.f, nqy = 0.f, nqz = 0.f;
      if (live && m + 1 < M && s_row[m + 1] >= 0) {
        const size_t j = size_t(s_row[m + 1]) * F3;
        npv = phik[j + f]; nps = phik[j + F + f]; npu = phik[j + 2 * F + f];
        nqx = vk[j + f]; nqy = vk[j + F + f]; nqz = vk[j + 2 * F + f];
      }
      const float* q = s_rbf + m * R;
      float v[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) v[t] = 0.f;
      if (live) {
        float tv = 0.f, ts = 0.f, tu = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          tv = fmaf(q[r], wv[r], tv);
          ts = fmaf(q[r], wsc[r], ts);
          tu = fmaf(q[r], wu[r], tu);
        }
        const float env = s_env[m];
        const float pre_v = tv + bv, pre_s = ts + bs, pre_u = tu + bu;
        const float ux = s_unit[m], uy = s_unit[M + m], uz = s_unit[2 * M + m];
        const float g_cvv = gx * qx + gy * qy + gz * qz;
        const float g_cu = gx * ux + gy * uy + gz * uz;
        const float g_wv = g_cvv * pv, g_ws = g_s * ps, g_wu = g_cu * pu;
        const float ev = g_wv * env, es = g_ws * env, eu = g_wu * env;
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = ev * wv[r] + es * wsc[r] + eu * wu[r];
        v[R] = g_wv * pre_v + g_ws * pre_s + g_wu * pre_u;
        const float c_u = pu * (pre_u * env);
        v[R + 1] = gx * c_u;
        v[R + 2] = gy * c_u;
        v[R + 3] = gz * c_u;
        if constexpr (WANT_DW) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            dwv[r] = fmaf(q[r], ev, dwv[r]);
            dws[r] = fmaf(q[r], es, dws[r]);
            dwu[r] = fmaf(q[r], eu, dwu[r]);
          }
          dbv += ev; dbs += es; dbu += eu;
        }
      }
      s_part[(m * n_warps + warp) * 32 + lane] = warp_reduce::reduce_scatter32(v, lane);
      pv = npv; ps = nps; pu = npu; qx = nqx; qy = nqy; qz = nqz;
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

    if constexpr (WANT_DW) {
      if (live) {
        float* out = gdw_part + ((size_t(c) * n_pad + i) * K + k) * (R + 1) * F3;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          out[r * F3 + f] = dwv[r];
          out[r * F3 + F + f] = dws[r];
          out[r * F3 + 2 * F + f] = dwu[r];
        }
        out[R * F3 + f] = dbv;
        out[R * F3 + F + f] = dbs;
        out[R * F3 + 2 * F + f] = dbu;
      }
    }
  }

  for (int t = f; t < M * R; t += blockDim.x) {
    const int m = t / R, r = t - m * R;
    g_rbf[e0 * R + t] = s_acc[m * 32 + r];
  }
  for (int t = f; t < M; t += blockDim.x) {
    g_envm[e0 + t] = s_acc[t * 32 + R];
    for (int x = 0; x < 3; ++x)
      g_unit[((size_t(c) * 3 + x) * n_pad + i) * M + t] = s_acc[t * 32 + R + 1 + x];
  }
}

template <int R>
__global__ void neighbor_kernel(
    const float* __restrict__ phi, const float* __restrict__ vcat,
    const float* __restrict__ rbf, const float* __restrict__ envm,
    const float* __restrict__ unit, const float* __restrict__ dw,
    const float* __restrict__ db, const float* __restrict__ gds,
    const float* __restrict__ gdv, const int* __restrict__ rev,
    float* __restrict__ g_phi, float* __restrict__ g_vcat, int K, Layout L, int D) {
  const int n_pad = L.n_pad, M = L.M, F = L.F;
  const int j = blockIdx.x, k = blockIdx.y, c = blockIdx.z;
  const int f = threadIdx.x;
  if (f >= F) return;
  const int F3 = 3 * F;
  const size_t E = size_t(n_pad) * M;

  const float* dwk = dw + size_t(k) * R * F3;
  float wv[R], wsc[R], wu[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wv[r] = dwk[r * F3 + f];
    wsc[r] = dwk[r * F3 + F + f];
    wu[r] = dwk[r * F3 + 2 * F + f];
  }
  const float* dbk = db + size_t(k) * F3;
  const float bv = dbk[f], bs = dbk[F + f], bu = dbk[2 * F + f];

  const size_t cplane = (size_t(c) * K + k) * n_pad;
  const size_t row = ((size_t(c) * K + k) * L.n_tab + j) * F3;
  const float pv = phi[row + f];
  const float vx = vcat[row + f], vy = vcat[row + F + f], vz = vcat[row + 2 * F + f];

  float a_v = 0.f, a_s = 0.f, a_u = 0.f, a_x = 0.f, a_y = 0.f, a_z = 0.f;
  const int* rj = rev + (size_t(c) * L.n_tab + j) * D;
  for (int d = 0; d < D; ++d) {
    const int e = __ldg(rj + d);
    if (e < 0) break;                        // the same for every thread
    const int i = e / M, m = e - i * M;
    const float* q = rbf + (size_t(c) * E + e) * R;
    float tv = 0.f, ts = 0.f, tu = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float qr = __ldg(q + r);
      tv = fmaf(qr, wv[r], tv);
      ts = fmaf(qr, wsc[r], ts);
      tu = fmaf(qr, wu[r], tu);
    }
    const float env = __ldg(envm + size_t(c) * E + e);
    const float w_v = (tv + bv) * env, w_s = (ts + bs) * env, w_u = (tu + bu) * env;
    const size_t ri = cplane + i;
    const float g_s = gds[ri * F + f];
    const float gx = gdv[ri * F3 + f], gy = gdv[ri * F3 + F + f], gz = gdv[ri * F3 + 2 * F + f];
    const float ux = __ldg(unit + (size_t(c) * 3 * n_pad + i) * M + m);
    const float uy = __ldg(unit + ((size_t(c) * 3 + 1) * n_pad + i) * M + m);
    const float uz = __ldg(unit + ((size_t(c) * 3 + 2) * n_pad + i) * M + m);
    a_v += (gx * vx + gy * vy + gz * vz) * w_v;
    a_s += g_s * w_s;
    a_u += (gx * ux + gy * uy + gz * uz) * w_u;
    const float c_vv = pv * w_v;
    a_x += gx * c_vv;
    a_y += gy * c_vv;
    a_z += gz * c_vv;
  }
  g_phi[row + f] = a_v;
  g_phi[row + F + f] = a_s;
  g_phi[row + 2 * F + f] = a_u;
  g_vcat[row + f] = a_x;
  g_vcat[row + F + f] = a_y;
  g_vcat[row + 2 * F + f] = a_z;
}

template <int R, bool WANT_DW>
cudaError_t launch_center(const float* phi, const float* vcat, const float* rbf,
                          const float* envm, const int* nbr, const float* unit,
                          const float* dw, const float* db, const float* gds,
                          const float* gdv, float* g_rbf, float* g_envm,
                          float* g_unit, float* gdw_part, int C, int K, Layout L,
                          cudaStream_t stream) {
  const int threads = ((L.F + 31) / 32) * 32;
  const int n_warps = threads / 32;
  const size_t shmem = (size_t(L.M) * (R + 4 + n_warps * 32 + 32)) * sizeof(float) +
                       size_t(L.M) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(center_kernel<R, WANT_DW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(shmem));
  if (err != cudaSuccess) return err;
  center_kernel<R, WANT_DW><<<dim3(L.n_pad, C), threads, shmem, stream>>>(
      phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv, g_rbf, g_envm, g_unit,
      gdw_part, K, L);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch(const float* phi, const float* vcat, const float* rbf,
                   const float* envm, const int* nbr, const float* unit,
                   const float* dw, const float* db, const float* gds,
                   const float* gdv, const int* rev, float* g_phi, float* g_vcat,
                   float* g_rbf, float* g_envm, float* g_unit, float* gdw_part,
                   int C, int K, Layout L, int D, int want_dw, cudaStream_t stream) {
  cudaError_t err = want_dw
      ? launch_center<R, true>(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv,
                               g_rbf, g_envm, g_unit, gdw_part, C, K, L, stream)
      : launch_center<R, false>(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv,
                                g_rbf, g_envm, g_unit, gdw_part, C, K, L, stream);
  if (err != cudaSuccess) return err;
  const int threads = ((L.F + 31) / 32) * 32;
  neighbor_kernel<R><<<dim3(L.n_tab, K, C), threads, 0, stream>>>(
      phi, vcat, rbf, envm, unit, dw, db, gds, gdv, rev, g_phi, g_vcat, K, L, D);
  return cudaGetLastError();
}

// Launches both kernels for a radial width R of 8, 16 or 24 and returns
// the first CUDA error (a refused launch never runs).
inline int backward(const float* phi, const float* vcat, const float* rbf,
                    const float* envm, const int* nbr, const float* unit,
                    const float* dw, const float* db, const float* gds,
                    const float* gdv, const int* rev, float* g_phi, float* g_vcat,
                    float* g_rbf, float* g_envm, float* g_unit, float* gdw_part,
                    int C, int K, int R, Layout L, int D, int want_dw,
                    cudaStream_t stream) {
  cudaError_t err;
  switch (R) {
    case 8: err = launch<8>(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv, rev, g_phi, g_vcat, g_rbf, g_envm, g_unit, gdw_part, C, K, L, D, want_dw, stream); break;
    case 16: err = launch<16>(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv, rev, g_phi, g_vcat, g_rbf, g_envm, g_unit, gdw_part, C, K, L, D, want_dw, stream); break;
    case 24: err = launch<24>(phi, vcat, rbf, envm, nbr, unit, dw, db, gds, gdv, rev, g_phi, g_vcat, g_rbf, g_envm, g_unit, gdw_part, C, K, L, D, want_dw, stream); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(err);
}

}  // namespace msgbwd
