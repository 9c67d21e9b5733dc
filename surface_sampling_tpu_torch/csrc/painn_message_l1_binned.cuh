// Species-binned layer-1 PaiNN message, shared by
// painn_message_l1_banded.cu (the supercell's sorted cell, neighbours read
// through the routing band's window) and painn_message_l1.cu (the unbanded
// message: an identity band, every window starting at 0 and W = n_pad, no
// halo, so banded::window_row(r, 0, n_pad, n_pad) == r). Batched over
// chains C and ensemble members K.
//
// Per edge e = (i, m), neighbour row j, for channel f of F:
//     w_s = (rbf[e] . dw2[:, f]     + db2[f])     * envm[e]
//     w_u = (rbf[e] . dw2[:, F + f] + db2[F + f]) * envm[e]
//     ds[i, f]      += philt[species[j], f]     * w_s
//     dv[i, x*F+f]  += philt[species[j], F + f] * w_u * unit[x, i, m]
//
// At layer 1 a neighbour enters only through its species, so the sum over
// a centre's edges is reassociated per (centre, species):
//     ds[i, f]     = sum_sp philt[sp, f]     (A[i, sp] . dw2_s[:, f] + a[i, sp] db2_s[f])
//     dv[i, x*F+f] = sum_sp philt[sp, F + f] (B[i, sp, x] . dw2_u[:, f] + b[i, sp, x] db2_u[f])
// with A[i, sp] = sum_{live m, sp_m = sp} envm_m rbf_m, a[i, sp] = sum envm_m,
// and B, b the same with envm_m unit_x,m: one bin of 4 x (R + 1) values per
// (centre, species present), shared by the members, then per member and
// channel 4 (R + 1) multiply-adds per species present, where the per-edge
// sum takes 4R per live edge (a centre of the 2x2 cell has ~25 live edges
// and 2-3 species among them).
//
// Bound on an H100: operations, f32 (67 TFLOP/s): 8 (R + 1) per live edge
// for the bins, and (8 (R + 1) + 8) per (chain, centre, member, channel,
// species present) for the products, against a few hundred MB of inputs.
// The design:
//
// - A block per (band block of n_blk sorted centres, chain), four warps.
//   Warp w bins centres w, w + 4, ...: its live slots (envm != 0 and inside
//   the window) in ascending order, a ballot per 32 slots; each live edge's
//   species and envelope factors are broadcast by shuffles and lane q adds
//   entries q, q + 32, ... of the species' bin in shared memory. A dead
//   edge's rbf, unit vector and species are never read.
// - Then thread u takes the (member, channel) pairs u, u + 128, ... over
//   all the block's centres: its two dist_embed columns and biases (2 (R +
//   1) floats) in registers, each bin row read as one 16-byte broadcast
//   (the bins are r-major: (1, ux, uy, uz) of one r side by side), the
//   species present in ascending order from a bitmask, outputs written by
//   consecutive threads to consecutive channels.
//
// Every sum runs in one fixed order (a bin over its edges in slot order, a
// centre's species in ascending order), no atomics: launches repeat
// bitwise. T1 (species rows, the zero row included) is at most 32.

#pragma once

#include <cuda_runtime.h>

#include "painn_band.cuh"

namespace l1binned {

constexpr int NW = 4, THREADS = NW * 32;
constexpr unsigned FULL = 0xffffffffu;

template <int R>
__global__ void __launch_bounds__(THREADS) binned_kernel(
    const int* __restrict__ species, const float* __restrict__ philt,
    const float* __restrict__ rbf, const float* __restrict__ envm,
    const int* __restrict__ nbr, const float* __restrict__ unit,
    const float* __restrict__ dw2, const float* __restrict__ db2,
    const int* __restrict__ ws, float* __restrict__ ds, float* __restrict__ dv, int K,
    int n_pad, int n_ext, int M, int F, int T1, int n_blk, int W) {
  constexpr int RB = R + 1, Q = 4 * RB;         // a bin: (rbf, 1) x (1, ux, uy, uz), r-major
  constexpr int QL = (Q + 31) / 32;             // bin entries a lane
  const int b = blockIdx.x, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = ws ? ws[b] : 0, row0 = b * n_blk;
  const size_t e_blk = (size_t(c) * n_pad + row0) * M;
  const size_t plane = size_t(n_pad) * M;

  extern __shared__ __align__(16) float smem[];
  float* s_bin = smem;                                             // n_blk x T1 x Q
  unsigned* s_present = reinterpret_cast<unsigned*>(s_bin + size_t(n_blk) * T1 * Q);

  for (int q = tid; q < n_blk * T1 * Q; q += THREADS) s_bin[q] = 0.f;
  __syncthreads();

  for (int i = warp; i < n_blk; i += NW) {
    const size_t ei = e_blk + size_t(i) * M;
    float* bins = s_bin + size_t(i) * T1 * Q;
    unsigned present = 0;
    for (int m0 = 0; m0 < M; m0 += 32) {
      const int m = m0 + lane;
      int row = -1;
      if (m < M && envm[ei + m] != 0.f) row = banded::window_row(nbr[ei + m], s, n_pad, W);
      float f0 = 0.f, f1 = 0.f, f2 = 0.f, f3 = 0.f;
      int sp = 0;
      if (row >= 0) {
        const size_t u0 = (size_t(c) * 3 * n_pad + row0 + i) * M + m;
        f0 = envm[ei + m];
        f1 = f0 * unit[u0];
        f2 = f0 * unit[u0 + plane];
        f3 = f0 * unit[u0 + 2 * plane];
        sp = species[size_t(c) * n_ext + row];
      }
      unsigned bal = __ballot_sync(FULL, row >= 0);
      while (bal) {
        const int src = __ffs(bal) - 1;
        bal &= bal - 1;
        const int spb = __shfl_sync(FULL, sp, src);
        const float g0 = __shfl_sync(FULL, f0, src), g1 = __shfl_sync(FULL, f1, src);
        const float g2 = __shfl_sync(FULL, f2, src), g3 = __shfl_sync(FULL, f3, src);
        const float rv = lane < R ? rbf[(ei + m0 + src) * R + lane] : 1.f;
        float* bin = bins + spb * Q;
#pragma unroll
        for (int j = 0; j < QL; ++j) {
          const int q = lane + 32 * j, r = q >> 2, a = q & 3;
          const float x = __shfl_sync(FULL, rv, r < 32 ? r : 0);
          const float ga = a == 0 ? g0 : a == 1 ? g1 : a == 2 ? g2 : g3;
          if (q < Q) bin[q] += ga * x;
        }
        present |= 1u << spb;
      }
    }
    if (lane == 0) s_present[i] = present;
  }
  __syncthreads();

  const int F2 = 2 * F;
  for (int u = tid; u < K * F; u += THREADS) {
    const int k = u / F, f = u - k * F;
    float wsf[RB], wuf[RB];
    const float* dwk = dw2 + size_t(k) * R * F2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wsf[r] = __ldg(dwk + r * F2 + f);
      wuf[r] = __ldg(dwk + r * F2 + F + f);
    }
    wsf[R] = __ldg(db2 + size_t(k) * F2 + f);
    wuf[R] = __ldg(db2 + size_t(k) * F2 + F + f);
    const float* ph = philt + size_t(k) * T1 * F2;
    for (int i = 0; i < n_blk; ++i) {
      float as = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
      unsigned left = s_present[i];
      while (left) {
        const int sp = __ffs(left) - 1;
        left &= left - 1;
        const float4* bin = reinterpret_cast<const float4*>(s_bin + (size_t(i) * T1 + sp) * Q);
        float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 v = bin[r];
          t0 = fmaf(v.x, wsf[r], t0);
          t1 = fmaf(v.y, wuf[r], t1);
          t2 = fmaf(v.z, wuf[r], t2);
          t3 = fmaf(v.w, wuf[r], t3);
        }
        const float ps = __ldg(ph + sp * F2 + f), pu = __ldg(ph + sp * F2 + F + f);
        as = fmaf(ps, t0, as);
        ax = fmaf(pu, t1, ax);
        ay = fmaf(pu, t2, ay);
        az = fmaf(pu, t3, az);
      }
      const size_t row = (size_t(c) * K + k) * n_pad + row0 + i;
      ds[row * F + f] = as;
      dv[row * 3 * F + f] = ax;
      dv[row * 3 * F + F + f] = ay;
      dv[row * 3 * F + 2 * F + f] = az;
    }
  }
}

// Bytes of dynamic shared memory of a block: the bins and the bitmasks.
inline size_t smem_bytes(int R, int n_blk, int T1) {
  return (size_t(n_blk) * T1 * 4 * (R + 1) + n_blk) * sizeof(float);
}

template <int R>
cudaError_t launch(const int* species, const float* philt, const float* rbf, const float* envm,
                   const int* nbr, const float* unit, const float* dw2, const float* db2,
                   const int* ws, float* ds, float* dv, int C, int K, int n_pad, int n_ext,
                   int M, int F, int T1, int n_blk, int W, cudaStream_t stream) {
  const size_t shmem = smem_bytes(R, n_blk, T1);
  cudaError_t err = cudaFuncSetAttribute(binned_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(shmem));
  if (err != cudaSuccess) return err;
  binned_kernel<R><<<dim3(n_pad / n_blk, C), THREADS, shmem, stream>>>(
      species, philt, rbf, envm, nbr, unit, dw2, db2, ws, ds, dv, K, n_pad, n_ext, M, F, T1,
      n_blk, W);
  return cudaGetLastError();
}

// Launches the kernel for a radial width R of 8, 16 or 24 and at most 32
// species rows, and returns cudaGetLastError() (a refused launch never
// runs). ws = nullptr with n_ext = W = n_pad is the unbanded message.
inline int message(const int* species, const float* philt, const float* rbf,
                   const float* envm, const int* nbr, const float* unit, const float* dw2,
                   const float* db2, const int* ws, float* ds, float* dv, int C, int K,
                   int n_pad, int n_ext, int M, int R, int F, int T1, int n_blk, int W,
                   cudaStream_t stream) {
  if (T1 > 32 || n_blk <= 0 || n_pad % n_blk) return int(cudaErrorInvalidValue);
  switch (R) {
    case 8: return int(launch<8>(species, philt, rbf, envm, nbr, unit, dw2, db2, ws, ds, dv, C, K, n_pad, n_ext, M, F, T1, n_blk, W, stream));
    case 16: return int(launch<16>(species, philt, rbf, envm, nbr, unit, dw2, db2, ws, ds, dv, C, K, n_pad, n_ext, M, F, T1, n_blk, W, stream));
    case 24: return int(launch<24>(species, philt, rbf, envm, nbr, unit, dw2, db2, ws, ds, dv, C, K, n_pad, n_ext, M, F, T1, n_blk, W, stream));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace l1binned
