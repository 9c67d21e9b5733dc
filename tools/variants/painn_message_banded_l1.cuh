// Variant of row 6 for tools/port_profile.py --variants (l1_edges): a copy
// of csrc/painn_message_banded.cuh with a layer-1 form (L1 below), the
// per-edge design of row 6 that the species-binned kernel replaced
// (PERF.md, PR 12). Windowed (banded) PaiNN message, batched over chains C
// and ensemble members K.
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
// The layer-1 form (template flag L1; _msg_kernel_l1_banded): v == 0, so
// the vv type and the vcat term vanish, and a neighbour enters only
// through its species: phi's row is philt[k, species_ext[c, j]] (K, T1,
// 2F). The filter has two types, s and unit (dw2 (K, R, 2F), db2 (K, 2F)).
// A live edge stages its neighbour's species where the general form stages
// the table row, so a slice reads two 16-byte rows of philt an edge.
//
// Bound on an H100: operations. Per live edge and member the radial filter
// is 2R x 3F multiply-adds, ~87% of the work; the rest is ~16F elementwise.
// The design, by what holds the work back:
//
// - Dead edges. About 60% of the edge slots carry envm == 0 (empty sites,
//   cut-off candidates, padded rows). The block compacts each centre's live
//   slots (envm != 0 and inside the window) in ascending slot order, a warp
//   ballot per 32 slots, and computes those only: a dead edge's rbf, unit
//   and neighbour row are never read.
// - The filter on the tensor cores. W = RBF (16 live edges x R) . dw_k
//   (R x 16 channels) runs as mma.sync m16n8k8 TF32 (two n-tiles of 8
//   channels) with the 3xTF32 split of tf32_mma.cuh, f32 accuracy. Edges
//   are the mma rows, so a centre's 16-edge tiles never mix centres; the
//   elementwise step (c_t, the three dv terms) runs on the accumulator
//   fragment in registers. The n-tiles' columns are interleaved so that
//   lane t holds channels 4t .. 4t + 3 of the slice: its neighbour rows are
//   read as 16-byte loads, and each lane keeps those channels' partial sums
//   over its two edge rows of every tile. They are summed once per centre
//   and slice over the 8 lanes that share the channels (a fixed butterfly),
//   not per edge.
// - Members inside the block. One block covers one band block of n_blk
//   sorted centres and one chain. The geometry of its live edges (rbf rows,
//   envelope and unit vector, neighbour row) is staged in shared memory once
//   and serves all K members; a warp's unit of work is a slice (member k,
//   16 channels) over all the block's centres, warp w taking slices w,
//   w + NW, ..., so warps never wait for each other and the filter's
//   weights for a slice are loaded once into registers.
// - Row gathers. A slice's neighbour rows are read straight from global
//   memory, 64 bytes a row and type; the block's centres share most of
//   them (~93 distinct rows for ~200 live edges a block at the 2x2 cell),
//   and the loads of one slice follow each other closely, so L1 serves the
//   repeats. Staging each distinct row once per block and slice in shared
//   memory (a W-entry map of the window, cp.async, a slice ring shared by
//   the warps) was measured too: the block-wide barriers of every slice and
//   the warps' uneven shares of centres made it more than twice as slow
//   (PERF.md §6).
// - Occupancy and registers. The filter's B fragments of a slice (72
//   registers), its accumulators and the rows take ~250 registers a thread:
//   two blocks of four warps an SM. Fewer registers (more blocks, or eight
//   channels a slice) were slower on the H100.
// - Shared memory is bounded: a block whose centres need more than
//   CAP_EDGES padded live edges runs them in consecutive groups that fit.
//
// Summation order, per centre: each lane adds its edge rows tile by tile
// (rows g, g + 8 of each 16-edge tile, in the centre's ascending slot
// order), then the 8 lanes of a channel quadruple by a fixed butterfly. A
// centre's ds and dv depend only on its own live edges and their tile
// split, not on the other centres of its block or group, nor on the warp
// that computes it: the full cell and a subset of blocks give the same bits
// for the same centre. No atomics, so launches repeat bitwise.

#pragma once

#include <cuda_runtime.h>

#include "painn_band.cuh"
#include "tf32_mma.cuh"

namespace banded {

using namespace tf32mma;

constexpr int NW = 4;                 // warps a block
constexpr int THREADS = NW * 32;
constexpr int SL = 16;                // channels a slice (two mma n-tiles)
constexpr int ET = 16;                // live edges a tile (the mma rows)
constexpr int CAP_EDGES = 256;        // padded live edges a group holds
constexpr int BLOCKS_PER_SM = 2, L1_BLOCKS_PER_SM = 2;

// A centre's live edge: its neighbour's row of the extended table, or -1
// (envm == 0, or outside the window).
__device__ __forceinline__ int live_row(const float* __restrict__ envm,
                                        const int* __restrict__ nbr, size_t e, int s, int n_pad,
                                        int W) {
  return envm[e] == 0.f ? -1 : window_row(nbr[e], s, n_pad, W);
}

__host__ __device__ constexpr int padded(int n) { return (n + ET - 1) / ET * ET; }

// Edges a group holds: a single centre always fits.
__host__ __device__ constexpr int cap_edges(int M) {
  return padded(M) > CAP_EDGES ? padded(M) : CAP_EDGES;
}

// 4-byte words of dynamic shared memory a block takes.
template <int R>
__host__ __device__ constexpr size_t smem_words(int M, int n_blk) {
  return size_t(cap_edges(M)) * (R + 4 + 4 + 1) + size_t(3) * n_blk + 2;
}

// One block per (band block, chain): centre rows row0 .. row0 + n_blk - 1
// of n_rows read their window start from ws[c * ws_stride + blockIdx.x]:
// ws_stride = 0 shares one table of starts over the chains (the full cell),
// ws_stride = n_rows / n_blk gives every chain its own list of blocks (a
// subset); ws = nullptr starts every window at 0 (with W = n_pad: the
// identity band of the unbanded message). Lane (g, t) = (lane / 4,
// lane % 4) holds, in the mma's accumulator layout, edge rows g and g + 8
// of a tile.
template <int R, bool L1>
__global__ void __launch_bounds__(THREADS, L1 ? L1_BLOCKS_PER_SM : BLOCKS_PER_SM) message_kernel(
    const float* __restrict__ phi, const float* __restrict__ vcat,
    const int* __restrict__ species, const float* __restrict__ rbf,
    const float* __restrict__ envm, const int* __restrict__ nbr,
    const float* __restrict__ unit, const float* __restrict__ dw,
    const float* __restrict__ db, const int* __restrict__ ws, float* __restrict__ ds,
    float* __restrict__ dv, int K, int n_rows, int n_pad, int n_ext, int M, int F, int T1,
    int n_blk, int W, int ws_stride) {
  static_assert(R % 8 == 0 && R <= 24, "R must be 8, 16 or 24");
  constexpr int S = R + 4;            // floats a staged rbf row
  constexpr int KS = R / 8;           // k steps of the filter
  constexpr int NT = L1 ? 2 : 3;      // filter types: (vv,) s, unit
  constexpr int TS = NT - 2, TU = NT - 1;
  const int b = blockIdx.x, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const unsigned below = (1u << lane) - 1u;
  const int F3 = 3 * F, FT = NT * F;  // widths of a table row and of a weight row
  const int CE = cap_edges(M);
  const int s = ws ? ws[size_t(c) * ws_stride + b] : 0;
  const int row0 = b * n_blk;
  const size_t e_blk = (size_t(c) * n_rows + row0) * M;   // first edge slot of the block

  extern __shared__ __align__(16) float smem[];
  float* s_rbf = smem;                                         // CE x S
  float4* s_geo = reinterpret_cast<float4*>(s_rbf + CE * S);   // CE: envm, unit x|y|z
  int* s_erow = reinterpret_cast<int*>(s_geo + CE);            // CE: neighbour's table row
  int* s_nlive = s_erow + CE;                                  // n_blk: live edges a centre
  int* s_cbase = s_nlive + n_blk;                              // n_blk: its first edge
  int* s_gfirst = s_cbase + n_blk;                             // groups' first centres, n_blk
  int* s_ng = s_gfirst + n_blk + 1;                            // number of groups

  // live edges of each centre, a warp a centre; then the groups
  for (int i = warp; i < n_blk; i += NW) {
    int n = 0;
    for (int m0 = 0; m0 < M; m0 += 32) {
      const int m = m0 + lane;
      n += __popc(__ballot_sync(
          FULL, m < M && live_row(envm, nbr, e_blk + size_t(i) * M + m, s, n_pad, W) >= 0));
    }
    if (lane == 0) s_nlive[i] = n;
  }
  __syncthreads();
  if (tid == 0) {
    int ng = 1, base = 0;
    s_gfirst[0] = 0;
    for (int i = 0; i < n_blk; ++i) {
      const int p = padded(s_nlive[i]);
      if (i > s_gfirst[ng - 1] && base + p > CE) {
        s_gfirst[ng++] = i;
        base = 0;
      }
      s_cbase[i] = base;
      base += p;
    }
    s_gfirst[ng] = n_blk;
    s_ng[0] = ng;
  }
  __syncthreads();

  const int n_cs = F / SL, n_sl = K * n_cs;
  for (int gi = 0; gi < s_ng[0]; ++gi) {
    const int g0 = s_gfirst[gi], g1 = s_gfirst[gi + 1];

    // ---- the group's edges, a warp a centre: its live slots in ascending
    // order, then its padding (zero rbf and envelope, row s)
    for (int i = g0 + warp; i < g1; i += NW) {
      const size_t ei = e_blk + size_t(i) * M;
      const int base = s_cbase[i];
      int done = 0;
      for (int m0 = 0; m0 < M; m0 += 32) {
        const int m = m0 + lane;
        const int row = m < M ? live_row(envm, nbr, ei + m, s, n_pad, W) : -1;
        const unsigned bal = __ballot_sync(FULL, row >= 0);
        if (row >= 0) {
          const int e = base + done + __popc(bal & below);
#pragma unroll
          for (int q = 0; q < R / 4; ++q)
            cp_async16(s_rbf + e * S + 4 * q, rbf + (ei + m) * R + 4 * q, true);
          const size_t u0 = (size_t(c) * 3 * n_rows + row0 + i) * M + m;
          const size_t plane = size_t(n_rows) * M;
          s_geo[e] = make_float4(envm[ei + m], unit[u0], unit[u0 + plane], unit[u0 + 2 * plane]);
          s_erow[e] = L1 ? __ldg(species + size_t(c) * n_ext + row) : row;
        }
        done += __popc(bal);
      }
      for (int e = base + done + lane; e < base + padded(done); e += 32) {
#pragma unroll
        for (int q = 0; q < R / 4; ++q) cp_async16(s_rbf + e * S + 4 * q, rbf, false);
        s_geo[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        s_erow[e] = L1 ? T1 - 1 : s;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // ---- slices u = (member k, channels SL cs ..), warp w taking u = w,
    // w + NW, ...
    for (int u = warp; u < n_sl; u += NW) {
      const int k = u / n_cs, cs = u - k * n_cs;
      // B fragments (r x channel) of both n-tiles: b0 = (r = 8ks + t,
      // column g), b1 = (r = 8ks + t + 4, column g); column n of n-tile h
      // is channel 4 (n / 2) + 2h + n % 2 of the slice, so this lane's
      // accumulator columns (2t, 2t + 1 of both) are channels 4t .. 4t + 3
      const float* dwk = dw + size_t(k) * R * FT + cs * SL;
      unsigned bh[2][NT][KS][2], bl[2][NT][KS][2];
      float bias[NT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int T = 0; T < NT; ++T)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const int ch = 4 * (g >> 1) + 2 * h + (g & 1);
            split(__ldg(dwk + (ks * 8 + t) * FT + T * F + ch), bh[h][T][ks][0], bl[h][T][ks][0]);
            split(__ldg(dwk + (ks * 8 + t + 4) * FT + T * F + ch), bh[h][T][ks][1],
                  bl[h][T][ks][1]);
          }
#pragma unroll
      for (int T = 0; T < NT; ++T) {
        const float4 b4 =
            __ldg(reinterpret_cast<const float4*>(db + size_t(k) * FT + T * F + cs * SL + 4 * t));
        bias[T][0] = b4.x;
        bias[T][1] = b4.y;
        bias[T][2] = b4.z;
        bias[T][3] = b4.w;
      }
      const size_t plane = (size_t(c) * K + k) * n_ext;
      const float* pk = L1 ? phi + size_t(k) * T1 * FT + cs * SL + 4 * t
                           : phi + plane * F3 + cs * SL + 4 * t;
      const float* vk = L1 ? nullptr : vcat + plane * F3 + cs * SL + 4 * t;

      for (int i = g0; i < g1; ++i) {
        const int e_beg = s_cbase[i], n_t = padded(s_nlive[i]) / ET;
        float a_s[4] = {}, a_x[4] = {}, a_y[4] = {}, a_z[4] = {};
        for (int tt = 0; tt < n_t; ++tt) {
          const int e0 = e_beg + tt * ET;
          // W (16 edges x 8 channels) = RBF . dw, per n-tile h and type T
          float w[2][NT][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int T = 0; T < NT; ++T)
#pragma unroll
              for (int q = 0; q < 4; ++q) w[h][T][q] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const float* r_lo = s_rbf + (e0 + g) * S + ks * 8 + t;
            const float* r_hi = r_lo + 8 * S;
            const float a[4] = {r_lo[0], r_hi[0], r_lo[4], r_hi[4]};
            unsigned ah[4], al[4];
            split_all(a, ah, al);
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int T = 0; T < NT; ++T) mma3(w[h][T], ah, al, bh[h][T][ks], bl[h][T][ks]);
          }
          // elementwise, on the accumulator fragment: w[h][T][2 hr + q] is
          // edge e0 + g + 8 hr, channel 4t + 2h + q of the slice
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int e = e0 + g + 8 * hr;
            const float4 geo = s_geo[e];
            const float* pr = pk + size_t(s_erow[e]) * FT;
            const float4 ps4 = __ldg(reinterpret_cast<const float4*>(pr + TS * F));
            const float4 pu4 = __ldg(reinterpret_cast<const float4*>(pr + TU * F));
            const float ps[4] = {ps4.x, ps4.y, ps4.z, ps4.w};
            const float pu[4] = {pu4.x, pu4.y, pu4.z, pu4.w};
            float pv[4] = {}, qx[4] = {}, qy[4] = {}, qz[4] = {};
            if constexpr (!L1) {
              const size_t jr = size_t(s_erow[e]) * F3;
              const float4 pv4 = __ldg(reinterpret_cast<const float4*>(pr));
              const float4 qx4 = __ldg(reinterpret_cast<const float4*>(vk + jr));
              const float4 qy4 = __ldg(reinterpret_cast<const float4*>(vk + jr + F));
              const float4 qz4 = __ldg(reinterpret_cast<const float4*>(vk + jr + 2 * F));
              pv[0] = pv4.x; pv[1] = pv4.y; pv[2] = pv4.z; pv[3] = pv4.w;
              qx[0] = qx4.x; qx[1] = qx4.y; qx[2] = qx4.z; qx[3] = qx4.w;
              qy[0] = qy4.x; qy[1] = qy4.y; qy[2] = qy4.z; qy[3] = qy4.w;
              qz[0] = qz4.x; qz[1] = qz4.y; qz[2] = qz4.z; qz[3] = qz4.w;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int h = j >> 1, idx = 2 * hr + (j & 1);
              const float c_s = ps[j] * ((w[h][TS][idx] + bias[TS][j]) * geo.x);
              const float c_u = pu[j] * ((w[h][TU][idx] + bias[TU][j]) * geo.x);
              a_s[j] += c_s;
              if constexpr (L1) {
                a_x[j] += c_u * geo.y;
                a_y[j] += c_u * geo.z;
                a_z[j] += c_u * geo.w;
              } else {
                const float c_vv = pv[j] * ((w[h][0][idx] + bias[0][j]) * geo.x);
                a_x[j] += c_u * geo.y + c_vv * qx[j];
                a_y[j] += c_u * geo.z + c_vv * qy[j];
                a_z[j] += c_u * geo.w + c_vv * qz[j];
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int x = 4; x < 32; x <<= 1) {
            a_s[j] += __shfl_xor_sync(FULL, a_s[j], x);
            a_x[j] += __shfl_xor_sync(FULL, a_x[j], x);
            a_y[j] += __shfl_xor_sync(FULL, a_y[j], x);
            a_z[j] += __shfl_xor_sync(FULL, a_z[j], x);
          }
        }
        if (g == 0) {
          const size_t row = (size_t(c) * K + k) * n_rows + row0 + i;
          const int col = cs * SL + 4 * t;
          *reinterpret_cast<float4*>(ds + row * F + col) =
              make_float4(a_s[0], a_s[1], a_s[2], a_s[3]);
          float* dvr = dv + row * F3 + col;
          *reinterpret_cast<float4*>(dvr) = make_float4(a_x[0], a_x[1], a_x[2], a_x[3]);
          *reinterpret_cast<float4*>(dvr + F) = make_float4(a_y[0], a_y[1], a_y[2], a_y[3]);
          *reinterpret_cast<float4*>(dvr + 2 * F) = make_float4(a_z[0], a_z[1], a_z[2], a_z[3]);
        }
      }
    }
    __syncthreads();
  }
}

// Bytes of dynamic shared memory of a block at these sizes (what the launch
// asks for); 0 for an R the kernel does not take.
inline size_t smem_bytes(int R, int M, int n_blk) {
  switch (R) {
    case 8: return smem_words<8>(M, n_blk) * 4;
    case 16: return smem_words<16>(M, n_blk) * 4;
    case 24: return smem_words<24>(M, n_blk) * 4;
    default: return 0;
  }
}

template <int R>
cudaError_t launch_l1(const int* species, const float* philt, const float* rbf,
                      const float* envm, const int* nbr, const float* unit,
                      const float* dw2, const float* db2, const int* ws, float* ds,
                      float* dv, int C, int K, int n_pad, int n_ext, int M, int F, int T1,
                      int n_blk, int W, cudaStream_t stream) {
  const size_t shmem = smem_words<R>(M, n_blk) * 4;
  cudaError_t err = cudaFuncSetAttribute(message_kernel<R, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(shmem));
  if (err != cudaSuccess) return err;
  message_kernel<R, true><<<dim3(n_pad / n_blk, C), THREADS, shmem, stream>>>(
      philt, nullptr, species, rbf, envm, nbr, unit, dw2, db2, ws, ds, dv, K, n_pad, n_pad,
      n_ext, M, F, T1, n_blk, W, 0);
  return cudaGetLastError();
}

}  // namespace banded
