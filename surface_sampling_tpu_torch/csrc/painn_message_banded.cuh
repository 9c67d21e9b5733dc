// Windowed (banded) general PaiNN message, shared by
// painn_message_fused_banded.cu (every centre of the sorted cell) and
// painn_message_subset.cu (the centres of selected blocks, chosen per
// chain). Batched over chains C and ensemble members K.
//
// Replaces the body of surface_sampling_tpu/ops/pallas_painn.py,
// _msg_kernel_banded. Slots are in the routing band's spatial order
// (ops/banding.py); phi and vcat arrive extended by a halo (rows [0, halo)
// of the sorted table appended after row n_pad - 1) so that a window that
// wraps past the end stays contiguous; nbr carries the neighbour's sorted
// rank. For a centre of block b the window starts at s = ws[b] and its
// neighbour of rank r is read from row s + ((r - s) mod n_pad) of the
// extended table when (r - s) mod n_pad < W. Outside the window the TPU
// kernel's one-hot router over W columns matches nothing, so such an edge
// contributes zero; here it is skipped. The host builds the band so that
// every selected edge lies in its window (ops/banding.build_routing_band),
// and the window never reaches past row n_pad + halo - 1.
//
// Per edge e = (i, m), neighbour row j, for channel f of F:
//     w_t = (rbf[e] . dw[:, tF + f] + db[tF + f]) * envm[e]    t = vv, s, unit
//     c_t = phi[j, tF + f] * w_t
//     ds[i, f]     += c_s
//     dv[i, x*F+f] += c_unit * unit[x, i, m] + c_vv * vcat[j, x*F + f]
//
// Bound on an H100: operations, as painn_message_fused.cu: 2 * E * R * 3F
// multiply-adds of the radial filter per (chain, member). The window
// removes no work here: rows are loaded by index, not routed through
// one-hot products of width W, so the TPU's reason for the band does not
// apply; the kernel keeps the band's addressing because the supercell path
// lays its tables out that way.
//
// Design: as painn_message_fused.cu. One block per (centre row i, member k,
// chain c), one thread per channel; the centre's M edge rows are staged in
// shared memory with each edge's table row resolved once (-1 outside the
// window); the thread keeps its 3R dist_embed weights in registers. Each
// thread owns its outputs: no atomics, deterministic sums.

#pragma once

#include <cuda_runtime.h>

#include "painn_band.cuh"

namespace banded {

// Centre row i of n_rows reads its window start from
// ws[c * ws_stride + i / n_blk]: ws_stride = 0 shares one table of starts
// over the chains (the full cell), ws_stride = n_rows / n_blk gives every
// chain its own list of blocks (a subset).
template <int R>
__global__ void message_kernel(
    const float* __restrict__ phi, const float* __restrict__ vcat,
    const float* __restrict__ rbf, const float* __restrict__ envm,
    const int* __restrict__ nbr, const float* __restrict__ unit,
    const float* __restrict__ dw, const float* __restrict__ db,
    const int* __restrict__ ws, float* __restrict__ ds, float* __restrict__ dv,
    int K, int n_rows, int n_pad, int n_ext, int M, int F, int n_blk, int W,
    int ws_stride) {
  const int i = blockIdx.x, k = blockIdx.y, c = blockIdx.z;
  const int f = threadIdx.x;
  const int F3 = 3 * F;
  const int s = ws[size_t(c) * ws_stride + i / n_blk];

  extern __shared__ float smem[];
  float* s_rbf = smem;                  // M * R
  float* s_env = s_rbf + M * R;         // M
  float* s_unit = s_env + M;            // 3 * M
  int* s_row = reinterpret_cast<int*>(s_unit + 3 * M);  // M

  const size_t e0 = (size_t(c) * n_rows + i) * M;
  for (int t = f; t < M * R; t += blockDim.x) s_rbf[t] = rbf[e0 * R + t];
  for (int t = f; t < M; t += blockDim.x) {
    s_env[t] = envm[e0 + t];
    s_row[t] = window_row(nbr[e0 + t], s, n_pad, W);
    for (int x = 0; x < 3; ++x)
      s_unit[x * M + t] = unit[((size_t(c) * 3 + x) * n_rows + i) * M + t];
  }
  __syncthreads();
  if (f >= F) return;

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

  const size_t plane = (size_t(c) * K + k) * n_ext;    // first table row of (c, k)
  const float* phik = phi + plane * F3;
  const float* vk = vcat + plane * F3;

  float acc_s = 0.f, acc_x = 0.f, acc_y = 0.f, acc_z = 0.f;
  for (int m = 0; m < M; ++m) {
    const int row = s_row[m];
    if (row < 0) continue;               // the same for every thread of the block
    const float* q = s_rbf + m * R;
    float tv = 0.f, ts = 0.f, tu = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      tv = fmaf(q[r], wv[r], tv);
      ts = fmaf(q[r], wsc[r], ts);
      tu = fmaf(q[r], wu[r], tu);
    }
    const float e = s_env[m];
    tv = (tv + bv) * e;
    ts = (ts + bs) * e;
    tu = (tu + bu) * e;
    const size_t j = size_t(row) * F3;
    const float c_vv = phik[j + f] * tv;
    const float c_s = phik[j + F + f] * ts;
    const float c_u = phik[j + 2 * F + f] * tu;
    acc_s += c_s;
    acc_x += c_u * s_unit[m] + c_vv * vk[j + f];
    acc_y += c_u * s_unit[M + m] + c_vv * vk[j + F + f];
    acc_z += c_u * s_unit[2 * M + m] + c_vv * vk[j + 2 * F + f];
  }
  const size_t row_out = (size_t(c) * K + k) * n_rows + i;
  ds[row_out * F + f] = acc_s;
  float* dvr = dv + row_out * F3;
  dvr[f] = acc_x;
  dvr[F + f] = acc_y;
  dvr[2 * F + f] = acc_z;
}

template <int R>
void launch(const float* phi, const float* vcat, const float* rbf,
            const float* envm, const int* nbr, const float* unit,
            const float* dw, const float* db, const int* ws, float* ds,
            float* dv, int C, int K, int n_rows, int n_pad, int n_ext, int M,
            int F, int n_blk, int W, int ws_stride, cudaStream_t stream) {
  const dim3 grid(n_rows, K, C);
  const size_t shmem = size_t(M) * (R + 4) * sizeof(float) + size_t(M) * sizeof(int);
  message_kernel<R><<<grid, F, shmem, stream>>>(
      phi, vcat, rbf, envm, nbr, unit, dw, db, ws, ds, dv, K, n_rows, n_pad,
      n_ext, M, F, n_blk, W, ws_stride);
}

// Launches the kernel for a radial width R of 8, 16, 24 or 32 and returns
// cudaGetLastError() (a refused launch never runs).
inline int message(const float* phi, const float* vcat, const float* rbf,
                   const float* envm, const int* nbr, const float* unit,
                   const float* dw, const float* db, const int* ws, float* ds,
                   float* dv, int C, int K, int n_rows, int n_pad, int n_ext,
                   int M, int R, int F, int n_blk, int W, int ws_stride,
                   cudaStream_t stream) {
  switch (R) {
    case 8: launch<8>(phi, vcat, rbf, envm, nbr, unit, dw, db, ws, ds, dv, C, K, n_rows, n_pad, n_ext, M, F, n_blk, W, ws_stride, stream); break;
    case 16: launch<16>(phi, vcat, rbf, envm, nbr, unit, dw, db, ws, ds, dv, C, K, n_rows, n_pad, n_ext, M, F, n_blk, W, ws_stride, stream); break;
    case 24: launch<24>(phi, vcat, rbf, envm, nbr, unit, dw, db, ws, ds, dv, C, K, n_rows, n_pad, n_ext, M, F, n_blk, W, ws_stride, stream); break;
    case 32: launch<32>(phi, vcat, rbf, envm, nbr, unit, dw, db, ws, ds, dv, C, K, n_rows, n_pad, n_ext, M, F, n_blk, W, ws_stride, stream); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace banded
