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
//   center_kernel    one block (4 warps) per (centre i, chain c). Emits the
//                    per-edge cotangents g_rbf (C, E, R), g_envm (C, E) and
//                    g_unit (C, 3, n_pad, M), summed over the members (rbf,
//                    envm and unit carry no member axis). On request
//                    (training) it also writes its block's g_dw / g_db
//                    partial (K, R + 1, 3F); the caller sums the partials
//                    over blocks in one fixed order. The forces path never
//                    asks.
//   neighbor_kernel  one block (4 warps) per (table row j, chain c), the
//                    members looped inside. g_phi and g_vcat of row j are
//                    sums over the edges that read row j, listed by the
//                    reverse table (ascending edge id, unselected edges
//                    left out). In the banded layout the table has
//                    n_pad + halo rows and the reverse table is keyed by
//                    extended row, so a slot read as row r by one window and
//                    as row r + n_pad by another gets two rows of
//                    cotangents, which the caller folds.
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
// What bounds the work on an H100, and what the design does about it:
//
// - Dead edges. About two thirds of the edge slots of the relaxed paths
//   have envm == 0 (cut-off candidates of the relax table, empty sites,
//   padded rows). The centre block compacts its live slots (envm != 0) in
//   ascending slot order, by a warp ballot and a prefix count into shared
//   memory, and computes those only; the neighbour kernel walks the reverse
//   table, which lists live edges only. Dead-edge contract: at a dead slot
//   the kernel writes exact zeros to g_rbf, g_unit AND g_envm. The plain
//   version gives zeros for the first two (both carry the factor envm) but
//   sum_{t,f} g_w_t * wpre_t for g_envm; that value never reaches a
//   position, since envm = envelope(d) * mask is zero there and the
//   cotangent flows on through envm's own factors (ROADMAP Queue 3,
//   tests/test_torch_bwd_contract.py).
// - The radial contractions. The filter W = RBF (L x R) . dw_k (R x 3F) +
//   db_k, g_rbf += G (L x 3F) . dw_k^T and g_dw_k += RBF^T . G are products
//   of tiles. They run on the tensor cores as mma.sync m16n8k8 TF32 with a
//   3xTF32 split (each operand x = hi + lo, both TF32, |x - hi - lo| <=
//   2^-20 |x|; a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi), which keeps f32
//   accuracy: a single TF32 pass (about 3 decimal digits) is never used. The centre
//   kernel tiles 16 live edges of its centre (the mma rows) by 8 channels
//   of each of the three channel groups (the mma columns); the elementwise
//   step runs on the filter's accumulator fragment in registers, and that
//   fragment is, with the k index permuted inside each 8-wide step, already
//   the A operand of the g_rbf product, so G never leaves the registers
//   (with g_dw requested it goes through a small per-warp tile in shared
//   memory, transposed, as the B operand of RBF^T . G). The neighbour
//   kernel computes W^T = dw_k^T . RBF^T over tiles of 16 channels by 8
//   incoming edges, so each thread's partial sums over edges stay in its
//   own registers.
// - The per-edge sums (g_envm, g_unit: R + 4 sums over 3F channels a
//   slot). No warp-wide shuffle reduction: g_rbf accumulates in the mma's
//   own fragments; g_envm and g_unit are per-thread partials over two
//   channels, added across the four threads of a quad, then into the
//   warp's slice of shared memory; the four warps' slices are added in
//   warp order at the end.
// - Row gathers. Each warp copies the neighbour rows phi[j], vcat[j] of its
//   next tile (centre kernel: 16 edges x 6 x 8 channels) or the centre rows
//   g_ds[i], g_dv[i] of its next tiles (neighbour kernel: 8 edges x 4 x 16
//   channels) into a shared-memory ring (CT_STAGES / NB_STAGES deep) with
//   cp.async (16 bytes a thread; Hopper's TMA has no row gather) while the
//   current tile computes. The staged rows are padded so that the fragment
//   reads are free of bank conflicts. These gathers are the kernels' next
//   floor: every live edge and member moves 6F floats (centre) and 4F
//   floats (neighbour) from L2, ~6 GB a launch at the relaxed 1x1 path's
//   C = 128; a row is staged once per edge that reads it, not once per
//   block.
// - Occupancy. Registers (~165 a thread at R = 24) and shared memory
//   (~66 KB a centre block at M = 64) allow three blocks, twelve warps, an
//   SM; a deeper centre ring or more registers drops that to two and is
//   slower on the H100.
//
// Summation orders are fixed: the centre kernel sums members, then channel
// groups, in unit order within a warp, then warps in order; the neighbour
// kernel sums each thread's edges (the reverse table's ascending order,
// two per tile), then the quad's four threads by a fixed tree. No float
// atomics, so a relaxed run or a training step repeats bitwise.

#pragma once

#include <cuda_runtime.h>

#include "painn_band.cuh"
#include "tf32_mma.cuh"

namespace msgbwd {

using namespace tf32mma;

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

constexpr int NW = 4;                 // warps a block
constexpr int THREADS = NW * 32;
constexpr int CT_ROWS = 16;           // live edges a centre tile (mma rows)
constexpr int CT_STRIDE = 56;         // floats a staged neighbour row: 6 x 8 channels + 8 pad
constexpr int G_STRIDE = 40;          // floats a row of the per-warp G tile (24 + 16 pad)
constexpr int NB_EDGES = 8;           // incoming edges a neighbour tile (mma columns)
constexpr int NB_CH = 16;             // channels a neighbour tile (mma rows)
constexpr int NB_STRIDE = 68;         // floats a staged centre row: 4 x 16 channels + 4 pad
constexpr int CT_STAGES = 2;          // depth of the centre kernel's cp.async ring
constexpr int NB_STAGES = 3;          // depth of the neighbour kernel's cp.async ring

// ---- shared-memory plans ---------------------------------------------------

template <int R, bool WANT_DW>
__host__ __device__ constexpr size_t center_smem_floats(int Mp) {
  return size_t(NW) * CT_STAGES * CT_ROWS * CT_STRIDE + (WANT_DW ? size_t(NW) * CT_ROWS * G_STRIDE : 0) +
         size_t(NW + 1) * Mp * (R + 4) + size_t(4) * Mp + size_t(2) * Mp + NW;
}

template <int R>
__host__ __device__ constexpr size_t neighbor_smem_floats(int Dp) {
  return size_t(NW) * NB_STAGES * NB_EDGES * NB_STRIDE + size_t(Dp) * (R + 4) + size_t(5) * Dp;
}

// ---- centre kernel ---------------------------------------------------------
//
// A unit of a warp's work is (member k, channel group cg of 8 channels in
// each of vv | s | unit, row tile rt of 16 live edges), in that nesting;
// warp w takes the channel groups w, w + NW, ... Lane (g, t) = (lane / 4,
// lane % 4) holds, in the mma's accumulator layout, edges 16 rt + g and
// 16 rt + g + 8 and channels 8 cg + 2t, 8 cg + 2t + 1.
template <int R, bool WANT_DW>
__global__ void __launch_bounds__(THREADS, WANT_DW ? 2 : 3) center_kernel(
    const float* __restrict__ phi, const float* __restrict__ vcat,
    const float* __restrict__ rbf, const float* __restrict__ envm,
    const int* __restrict__ nbr, const float* __restrict__ unit,
    const float* __restrict__ dw, const float* __restrict__ db,
    const float* __restrict__ gds, const float* __restrict__ gdv,
    float* __restrict__ g_rbf, float* __restrict__ g_envm,
    float* __restrict__ g_unit, float* __restrict__ gdw_part, int K, Layout L) {
  static_assert(R % 8 == 0 && R <= 24, "R must be 8, 16 or 24");
  constexpr int S = R + 4;            // floats a staged rbf row (col R: 1, for g_db)
  constexpr int KS = R / 8;           // k steps of the filter, n tiles of g_rbf
  constexpr int MT = (R + 16) / 16;   // m tiles of g_dw (R + 1 rows)
  const int n_pad = L.n_pad, M = L.M, F = L.F, F3 = 3 * F;
  const int i = blockIdx.x, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Mp = (M + 15) & ~15;

  extern __shared__ __align__(16) float smem[];
  float* s_ring = smem;                                   // NW x CT_STAGES x 16 x CT_STRIDE
  float* s_G = s_ring + NW * CT_STAGES * CT_ROWS * CT_STRIDE;  // NW x 16 x G_STRIDE
  float* s_acc = s_G + (WANT_DW ? NW * CT_ROWS * G_STRIDE : 0);  // NW x Mp x S
  float* s_rbf = s_acc + NW * Mp * S;                          // Mp x S
  float* s_env = s_rbf + Mp * S;                               // Mp
  float* s_unit = s_env + Mp;                                  // 3 x Mp
  int* s_slot = reinterpret_cast<int*>(s_unit + 3 * Mp);       // Mp: slot of live row
  int* s_row = s_slot + Mp;                                    // Mp: table row, -1 zeros
  int* s_cnt = s_row + Mp;                                     // NW

  const size_t e0 = (size_t(c) * n_pad + i) * M;

  // live slots in ascending order: a ballot per warp, warps in order
  int n_live = 0;
  for (int m0 = 0; m0 < M; m0 += THREADS) {
    const int m = m0 + tid;
    const bool lv = m < M && envm[e0 + m] != 0.f;
    const unsigned bal = __ballot_sync(FULL, lv);
    if (lane == 0) s_cnt[warp] = __popc(bal);
    __syncthreads();
    int off = n_live, total = 0;
    for (int w = 0; w < NW; ++w) {
      if (w < warp) off += s_cnt[w];
      total += s_cnt[w];
    }
    if (lv) s_slot[off + __popc(bal & ((1u << lane) - 1u))] = m;
    n_live += total;
    __syncthreads();
  }

  // dead slots: exact zeros in all three edge cotangents
  for (int m = tid; m < M; m += THREADS) {
    if (envm[e0 + m] != 0.f) continue;
    for (int r = 0; r < R; ++r) g_rbf[(e0 + m) * R + r] = 0.f;
    g_envm[e0 + m] = 0.f;
    for (int x = 0; x < 3; ++x) g_unit[((size_t(c) * 3 + x) * n_pad + i) * M + m] = 0.f;
  }
  float* part = WANT_DW ? gdw_part + (size_t(c) * n_pad + i) * K * (R + 1) * F3 : nullptr;
  if (n_live == 0) {
    if constexpr (WANT_DW) {
      for (size_t q = tid; q < size_t(K) * (R + 1) * F3; q += THREADS) part[q] = 0.f;
    }
    return;
  }

  const int Lp = (n_live + CT_ROWS - 1) & ~(CT_ROWS - 1);
  const int s_win = L.ws ? L.ws[i / L.n_blk] : 0;
  for (int q = tid; q < Lp * S; q += THREADS) {
    const int row = q / S, col = q - row * S;
    float v = 0.f;
    if (row < n_live) v = col < R ? rbf[(e0 + s_slot[row]) * R + col] : (col == R ? 1.f : 0.f);
    s_rbf[q] = v;
  }
  for (int q = tid; q < NW * Mp * S; q += THREADS) s_acc[q] = 0.f;
  for (int row = tid; row < Lp; row += THREADS) {
    float env = 0.f, ux = 0.f, uy = 0.f, uz = 0.f;
    int jrow = -1;
    if (row < n_live) {
      const int m = s_slot[row];
      env = envm[e0 + m];
      const int r = nbr[e0 + m];
      jrow = L.ws ? banded::window_row(r, s_win, n_pad, L.W) : r;
      ux = unit[((size_t(c) * 3 + 0) * n_pad + i) * M + m];
      uy = unit[((size_t(c) * 3 + 1) * n_pad + i) * M + m];
      uz = unit[((size_t(c) * 3 + 2) * n_pad + i) * M + m];
    }
    s_env[row] = env;
    s_row[row] = jrow;
    s_unit[row] = ux;
    s_unit[Mp + row] = uy;
    s_unit[2 * Mp + row] = uz;
  }
  __syncthreads();

  const int n_rt = Lp / CT_ROWS;
  const int n_cgw = (F / 8 - warp + NW - 1) / NW;
  const int n_units = K * n_cgw * n_rt;
  float* ring = s_ring + warp * CT_STAGES * CT_ROWS * CT_STRIDE;
  float* acc = s_acc + warp * Mp * S;

  // stage a unit's neighbour rows (16 edges x phi vv|s|u, vcat x|y|z x 8
  // channels) into a ring stage: 192 copies of 16 bytes, 6 a lane
  auto issue = [&](int k, int cg, int rt, int stage) {
    const size_t tplane = (size_t(c) * K + k) * L.n_tab;
    float* dst = ring + stage * CT_ROWS * CT_STRIDE;
#pragma unroll
    for (int p = 0; p < CT_ROWS * 12 / 32; ++p) {
      const int q = lane + 32 * p;
      const int row = q / 12, part12 = q - row * 12;
      const int typ = part12 >> 1, half = part12 & 1;
      const int r = s_row[rt * CT_ROWS + row];
      const float* src = (typ < 3 ? phi : vcat) +
                         (r >= 0 ? (tplane + r) * F3 + (typ % 3) * F + cg * 8 + half * 4 : 0);
      cp_async16(dst + row * CT_STRIDE + typ * 8 + half * 4, src, r >= 0);
    }
  };

  // per (k, cg): centre cotangents, biases and the filter's B fragments
  float gs[2], gx[2], gy[2], gz[2], bias[3][2];
  unsigned fbh[3][KS][2], fbl[3][KS][2];
  float dacc[MT][3][4];

  // unit (k, cg, rt) computes while unit (kn, cgn, rtn) is in flight; the
  // indices advance rt fastest, then cg, then k
  int k = 0, cg = warp, rt = 0, kn = 0, cgn = warp, rtn = 0;
  auto advance = [&](int& kk, int& cc, int& rr) {
    if (++rr == n_rt) {
      rr = 0;
      cc += NW;
      if (cc >= F / 8) { cc = warp; ++kk; }
    }
  };
  for (int u = 0; u < CT_STAGES - 1; ++u) {
    if (u < n_units) {
      issue(kn, cgn, rtn, u);
      advance(kn, cgn, rtn);
    }
    cp_async_commit();
  }
  for (int u = 0; u < n_units; ++u, advance(k, cg, rt)) {
    if (u + CT_STAGES - 1 < n_units) {
      issue(kn, cgn, rtn, (u + CT_STAGES - 1) % CT_STAGES);
      advance(kn, cgn, rtn);
    }
    cp_async_commit();
    cp_async_wait<CT_STAGES - 1>();
    __syncwarp();

    const int ch = cg * 8 + 2 * t;              // this lane's first channel
    const float* dwk = dw + size_t(k) * R * F3;
    if (rt == 0) {
      const size_t ci = (size_t(c) * K + k) * n_pad + i;
      const float2 s2 = *reinterpret_cast<const float2*>(gds + ci * F + ch);
      const float2 x2 = *reinterpret_cast<const float2*>(gdv + ci * F3 + ch);
      const float2 y2 = *reinterpret_cast<const float2*>(gdv + ci * F3 + F + ch);
      const float2 z2 = *reinterpret_cast<const float2*>(gdv + ci * F3 + 2 * F + ch);
      gs[0] = s2.x; gs[1] = s2.y; gx[0] = x2.x; gx[1] = x2.y;
      gy[0] = y2.x; gy[1] = y2.y; gz[0] = z2.x; gz[1] = z2.y;
#pragma unroll
      for (int T = 0; T < 3; ++T) {
        const float2 b2 = *reinterpret_cast<const float2*>(db + size_t(k) * F3 + T * F + ch);
        bias[T][0] = b2.x;
        bias[T][1] = b2.y;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          // B (r x channel): b0 = (r = 8ks + t, col g), b1 = (r = 8ks + t + 4, col g)
          split(dwk[(ks * 8 + t) * F3 + T * F + cg * 8 + g], fbh[T][ks][0], fbl[T][ks][0]);
          split(dwk[(ks * 8 + t + 4) * F3 + T * F + cg * 8 + g], fbh[T][ks][1], fbl[T][ks][1]);
        }
      }
      if constexpr (WANT_DW) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int T = 0; T < 3; ++T)
#pragma unroll
            for (int q = 0; q < 4; ++q) dacc[mt][T][q] = 0.f;
      }
    }

    // filter W_T (16 edges x 8 channels) = RBF . dw_T, per type T
    const int r0 = rt * CT_ROWS;
    float w[3][4];
#pragma unroll
    for (int T = 0; T < 3; ++T)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[T][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float a[4] = {s_rbf[(r0 + g) * S + ks * 8 + t], s_rbf[(r0 + g + 8) * S + ks * 8 + t],
                          s_rbf[(r0 + g) * S + ks * 8 + t + 4],
                          s_rbf[(r0 + g + 8) * S + ks * 8 + t + 4]};
      unsigned ah[4], al[4];
      split_all(a, ah, al);
#pragma unroll
      for (int T = 0; T < 3; ++T) mma3(w[T], ah, al, fbh[T][ks], fbl[T][ks]);
    }

    // elementwise, on the accumulator fragment: index 2 hr + q is edge
    // r0 + g + 8 hr, channel ch + q
    const float* st = ring + (u % CT_STAGES) * CT_ROWS * CT_STRIDE;
    float G[3][4], pe[2], pux[2], puy[2], puz[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = g + 8 * hr;
      const float env = s_env[r0 + row];
      const float ux = s_unit[r0 + row], uy = s_unit[Mp + r0 + row],
                  uz = s_unit[2 * Mp + r0 + row];
      const float* sr = st + row * CT_STRIDE + 2 * t;
      const float2 pv2 = *reinterpret_cast<const float2*>(sr);
      const float2 ps2 = *reinterpret_cast<const float2*>(sr + 8);
      const float2 pu2 = *reinterpret_cast<const float2*>(sr + 16);
      const float2 qx2 = *reinterpret_cast<const float2*>(sr + 24);
      const float2 qy2 = *reinterpret_cast<const float2*>(sr + 32);
      const float2 qz2 = *reinterpret_cast<const float2*>(sr + 40);
      pe[hr] = pux[hr] = puy[hr] = puz[hr] = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int idx = 2 * hr + q;
        const float pv = q ? pv2.y : pv2.x, ps = q ? ps2.y : ps2.x, pu = q ? pu2.y : pu2.x;
        const float qx = q ? qx2.y : qx2.x, qy = q ? qy2.y : qy2.x, qz = q ? qz2.y : qz2.x;
        const float pre_v = w[0][idx] + bias[0][q];
        const float pre_s = w[1][idx] + bias[1][q];
        const float pre_u = w[2][idx] + bias[2][q];
        const float g_cvv = gx[q] * qx + gy[q] * qy + gz[q] * qz;
        const float g_cu = gx[q] * ux + gy[q] * uy + gz[q] * uz;
        const float g_wv = g_cvv * pv, g_ws = gs[q] * ps, g_wu = g_cu * pu;
        G[0][idx] = g_wv * env;
        G[1][idx] = g_ws * env;
        G[2][idx] = g_wu * env;
        pe[hr] += g_wv * pre_v + g_ws * pre_s + g_wu * pre_u;
        const float c_u = pu * (pre_u * env);
        pux[hr] += gx[q] * c_u;
        puy[hr] += gy[q] * c_u;
        puz[hr] += gz[q] * c_u;
      }
    }

    // g_rbf (16 edges x R) = G (16 x 24 channels) . dw^T. The accumulator
    // fragment is the A operand with the k index permuted inside each
    // 8-wide step (k = t <-> channel 2t, k = t + 4 <-> channel 2t + 1), so
    // B is read in the same order.
    float dr[KS][4];
#pragma unroll
    for (int nt = 0; nt < KS; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) dr[nt][q] = 0.f;
#pragma unroll
    for (int T = 0; T < 3; ++T) {
      const float a[4] = {G[T][0], G[T][2], G[T][1], G[T][3]};
      unsigned ah[4], al[4];
      split_all(a, ah, al);
#pragma unroll
      for (int nt = 0; nt < KS; ++nt) {
        const float2 b2 =
            *reinterpret_cast<const float2*>(dwk + (nt * 8 + g) * F3 + T * F + ch);
        unsigned bh[2], bl[2];
        split(b2.x, bh[0], bl[0]);
        split(b2.y, bh[1], bl[1]);
        mma3(dr[nt], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float* ar = acc + (r0 + g + 8 * hr) * S;
#pragma unroll
      for (int nt = 0; nt < KS; ++nt) {
        ar[nt * 8 + 2 * t] += dr[nt][2 * hr];
        ar[nt * 8 + 2 * t + 1] += dr[nt][2 * hr + 1];
      }
      // g_envm, g_unit x | y | z: the quad's sum, lane t adds column R + t
      const float s0 = quad_sum(pe[hr]), s1 = quad_sum(pux[hr]);
      const float s2 = quad_sum(puy[hr]), s3 = quad_sum(puz[hr]);
      ar[R + t] += t == 0 ? s0 : t == 1 ? s1 : t == 2 ? s2 : s3;
    }

    if constexpr (WANT_DW) {
      // g_dw_k (R + 1 x 24 channels) += RBF^T (R + 1 x 16 edges) . G; row R
      // of RBF^T is the ones column, so row R of the result is g_db. G goes
      // through shared memory to reach the B operand's layout.
      float* sg = s_G + warp * CT_ROWS * G_STRIDE;
#pragma unroll
      for (int T = 0; T < 3; ++T)
#pragma unroll
        for (int idx = 0; idx < 4; ++idx)
          sg[(g + 8 * (idx >> 1)) * G_STRIDE + T * 8 + 2 * t + (idx & 1)] = G[T][idx];
      __syncwarp();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int e_lo = r0 + ks * 8 + t, e_hi = e_lo + 4;
        unsigned bh[3][2], bl[3][2];
#pragma unroll
        for (int T = 0; T < 3; ++T) {
          split(sg[(ks * 8 + t) * G_STRIDE + T * 8 + g], bh[T][0], bl[T][0]);
          split(sg[(ks * 8 + t + 4) * G_STRIDE + T * 8 + g], bh[T][1], bl[T][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int ra = mt * 16 + g, rb = ra + 8;
          const float a[4] = {ra < S ? s_rbf[e_lo * S + ra] : 0.f,
                              rb < S ? s_rbf[e_lo * S + rb] : 0.f,
                              ra < S ? s_rbf[e_hi * S + ra] : 0.f,
                              rb < S ? s_rbf[e_hi * S + rb] : 0.f};
          unsigned ah[4], al[4];
          split_all(a, ah, al);
#pragma unroll
          for (int T = 0; T < 3; ++T) mma3(dacc[mt][T], ah, al, bh[T], bl[T]);
        }
      }
      __syncwarp();
      if (rt == n_rt - 1) {
        float* out = part + size_t(k) * (R + 1) * F3;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int T = 0; T < 3; ++T)
#pragma unroll
            for (int idx = 0; idx < 4; ++idx) {
              const int r = mt * 16 + g + 8 * (idx >> 1);
              if (r <= R) out[r * F3 + T * F + ch + (idx & 1)] = dacc[mt][T][idx];
            }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' slices in warp order
  for (int q = tid; q < n_live * S; q += THREADS) {
    const int row = q / S, col = q - row * S;
    float v = s_acc[q];
    for (int w = 1; w < NW; ++w) v += s_acc[w * Mp * S + q];
    const int m = s_slot[row];
    if (col < R)
      g_rbf[(e0 + m) * R + col] = v;
    else if (col == R)
      g_envm[e0 + m] = v;
    else
      g_unit[((size_t(c) * 3 + (col - R - 1)) * n_pad + i) * M + m] = v;
  }
}

// ---- neighbour kernel ------------------------------------------------------
//
// A unit of a warp's work is (member k, channel tile ct of 16 channels in
// each of vv | s | unit, edge tile et of 8 incoming edges), in that
// nesting; warp w takes the channel tiles w, w + NW, ... Lane (g, t) holds,
// in the accumulator layout of W^T (16 channels x 8 edges), channels
// 16 ct + g and 16 ct + g + 8 and incoming edges 8 et + 2t, 8 et + 2t + 1.
template <int R>
__global__ void __launch_bounds__(THREADS, 3) neighbor_kernel(
    const float* __restrict__ phi, const float* __restrict__ vcat,
    const float* __restrict__ rbf, const float* __restrict__ envm,
    const float* __restrict__ unit, const float* __restrict__ dw,
    const float* __restrict__ db, const float* __restrict__ gds,
    const float* __restrict__ gdv, const int* __restrict__ rev,
    float* __restrict__ g_phi, float* __restrict__ g_vcat, int K, Layout L, int D) {
  constexpr int S = R + 4, KS = R / 8;
  const int n_pad = L.n_pad, M = L.M, F = L.F, F3 = 3 * F;
  const int j = blockIdx.x, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t E = size_t(n_pad) * M;
  const int Dp = (D + NB_EDGES - 1) & ~(NB_EDGES - 1);

  extern __shared__ __align__(16) float smem[];
  float* s_ring = smem;                                   // NW x NB_STAGES x 8 x NB_STRIDE
  float* s_rbf = s_ring + NW * NB_STAGES * NB_EDGES * NB_STRIDE;  // Dp x S
  float* s_env = s_rbf + Dp * S;                             // Dp
  float* s_unit = s_env + Dp;                                // 3 x Dp
  int* s_ci = reinterpret_cast<int*>(s_unit + 3 * Dp);       // Dp: centre row, -1 zeros

  // the reverse table lists the incoming edges first, ascending, then -1
  const int* rj = rev + (size_t(c) * L.n_tab + j) * D;
  int n_in = 0;
  for (int d0 = 0; d0 < D; d0 += THREADS) {
    const int d = d0 + tid;
    n_in += __syncthreads_count(d < D && rj[d] >= 0);
  }
  if (n_in == 0) {
    for (int q = tid; q < K * F3; q += THREADS) {
      const int k = q / F3, col = q - k * F3;
      const size_t row = ((size_t(c) * K + k) * L.n_tab + j) * F3;
      g_phi[row + col] = 0.f;
      g_vcat[row + col] = 0.f;
    }
    return;
  }

  const int Lp = (n_in + NB_EDGES - 1) & ~(NB_EDGES - 1);
  for (int q = tid; q < Lp * S; q += THREADS) {
    const int row = q / S, col = q - row * S;
    s_rbf[q] = row < n_in && col < R ? rbf[(size_t(c) * E + rj[row]) * R + col] : 0.f;
  }
  for (int row = tid; row < Lp; row += THREADS) {
    float env = 0.f, ux = 0.f, uy = 0.f, uz = 0.f;
    int ci = -1;
    if (row < n_in) {
      const int e = rj[row];
      const int i = e / M, m = e - i * M;
      env = envm[size_t(c) * E + e];
      ux = unit[((size_t(c) * 3 + 0) * n_pad + i) * M + m];
      uy = unit[((size_t(c) * 3 + 1) * n_pad + i) * M + m];
      uz = unit[((size_t(c) * 3 + 2) * n_pad + i) * M + m];
      ci = i;
    }
    s_env[row] = env;
    s_unit[row] = ux;
    s_unit[Dp + row] = uy;
    s_unit[2 * Dp + row] = uz;
    s_ci[row] = ci;
  }
  __syncthreads();

  const int n_et = Lp / NB_EDGES;
  const int n_ctw = (F / NB_CH - warp + NW - 1) / NW;
  const int n_units = K * n_ctw * n_et;
  float* ring = s_ring + warp * NB_STAGES * NB_EDGES * NB_STRIDE;

  // stage a unit's centre rows (8 edges x g_ds, g_dv x|y|z x 16 channels)
  // into a ring stage: 128 copies of 16 bytes, 4 a lane
  auto issue = [&](int k, int ct, int et, int stage) {
    const size_t cplane = (size_t(c) * K + k) * n_pad;
    float* dst = ring + stage * NB_EDGES * NB_STRIDE;
#pragma unroll
    for (int p = 0; p < NB_EDGES * 16 / 32; ++p) {
      const int q = lane + 32 * p;
      const int edge = q >> 4, typ = (q >> 2) & 3, quarter = q & 3;
      const int ci = s_ci[et * NB_EDGES + edge];
      const float* src = gds;
      if (ci >= 0)
        src = (typ == 0 ? gds + (cplane + ci) * F : gdv + (cplane + ci) * F3 + (typ - 1) * F) +
              ct * NB_CH + quarter * 4;
      cp_async16(dst + edge * NB_STRIDE + typ * NB_CH + quarter * 4, src, ci >= 0);
    }
  };

  // per (k, ct): the filter's A fragments (dw^T: channel x r), biases, and
  // row j's phi_vv and vcat at this lane's two channels; the sums
  unsigned fah[3][KS][4], fal[3][KS][4];
  float bias[3][2], pv[2], vx[2], vy[2], vz[2];
  float a_v[2], a_s[2], a_u[2], a_x[2], a_y[2], a_z[2];

  // unit (k, ct, et) computes while unit (kn, ctn, etn) is in flight; the
  // indices advance et fastest, then ct, then k
  int k = 0, ct = warp, et = 0, kn = 0, ctn = warp, etn = 0;
  auto advance = [&](int& kk, int& cc, int& ee) {
    if (++ee == n_et) {
      ee = 0;
      cc += NW;
      if (cc >= F / NB_CH) { cc = warp; ++kk; }
    }
  };
  for (int u = 0; u < NB_STAGES - 1; ++u) {
    if (u < n_units) {
      issue(kn, ctn, etn, u);
      advance(kn, ctn, etn);
    }
    cp_async_commit();
  }
  for (int u = 0; u < n_units; ++u, advance(k, ct, et)) {
    if (u + NB_STAGES - 1 < n_units) {
      issue(kn, ctn, etn, (u + NB_STAGES - 1) % NB_STAGES);
      advance(kn, ctn, etn);
    }
    cp_async_commit();
    cp_async_wait<NB_STAGES - 1>();
    __syncwarp();

    const int c0 = ct * NB_CH + g;               // this lane's first channel (second: + 8)
    const size_t jrow = ((size_t(c) * K + k) * L.n_tab + j) * F3;
    if (et == 0) {
      const float* dwk = dw + size_t(k) * R * F3;
#pragma unroll
      for (int T = 0; T < 3; ++T) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          // A (channel x r): a0 (c0, 8ks + t), a1 (c0 + 8, 8ks + t),
          // a2 (c0, 8ks + t + 4), a3 (c0 + 8, 8ks + t + 4)
          const float a[4] = {dwk[(ks * 8 + t) * F3 + T * F + c0],
                              dwk[(ks * 8 + t) * F3 + T * F + c0 + 8],
                              dwk[(ks * 8 + t + 4) * F3 + T * F + c0],
                              dwk[(ks * 8 + t + 4) * F3 + T * F + c0 + 8]};
          split_all(a, fah[T][ks], fal[T][ks]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) bias[T][h] = db[size_t(k) * F3 + T * F + c0 + 8 * h];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pv[h] = phi[jrow + c0 + 8 * h];
        vx[h] = vcat[jrow + c0 + 8 * h];
        vy[h] = vcat[jrow + F + c0 + 8 * h];
        vz[h] = vcat[jrow + 2 * F + c0 + 8 * h];
        a_v[h] = a_s[h] = a_u[h] = a_x[h] = a_y[h] = a_z[h] = 0.f;
      }
    }

    // W^T_T (16 channels x 8 edges) = dw_T^T . RBF^T, per type T
    const int e0 = et * NB_EDGES;
    float w[3][4];
#pragma unroll
    for (int T = 0; T < 3; ++T)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[T][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned bh[2], bl[2];
      split(s_rbf[(e0 + g) * S + ks * 8 + t], bh[0], bl[0]);
      split(s_rbf[(e0 + g) * S + ks * 8 + t + 4], bh[1], bl[1]);
#pragma unroll
      for (int T = 0; T < 3; ++T) mma3(w[T], fah[T][ks], fal[T][ks], bh, bl);
    }

    // fragment index 2h + q: channel c0 + 8h, incoming edge e0 + 2t + q;
    // each lane adds its edges in ascending order
    const float* st = ring + (u % NB_STAGES) * NB_EDGES * NB_STRIDE;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int le = e0 + 2 * t + q;
      const float env = s_env[le];
      const float ux = s_unit[le], uy = s_unit[Dp + le], uz = s_unit[2 * Dp + le];
      const float* sg = st + (2 * t + q) * NB_STRIDE;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 2 * h + q, cl = g + 8 * h;
        const float gs = sg[cl], gx = sg[NB_CH + cl], gy = sg[2 * NB_CH + cl],
                    gz = sg[3 * NB_CH + cl];
        const float w_v = (w[0][idx] + bias[0][h]) * env;
        const float w_s = (w[1][idx] + bias[1][h]) * env;
        const float w_u = (w[2][idx] + bias[2][h]) * env;
        a_v[h] += (gx * vx[h] + gy * vy[h] + gz * vz[h]) * w_v;
        a_s[h] += gs * w_s;
        a_u[h] += (gx * ux + gy * uy + gz * uz) * w_u;
        const float c_vv = pv[h] * w_v;
        a_x[h] += gx * c_vv;
        a_y[h] += gy * c_vv;
        a_z[h] += gz * c_vv;
      }
    }

    if (et == n_et - 1) {
      // the quad's four lanes hold the same channels, other edges: sum them
      // by a fixed tree; lane t writes 3 of the 12 sums
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float o[6] = {quad_sum(a_v[h]), quad_sum(a_s[h]), quad_sum(a_u[h]),
                            quad_sum(a_x[h]), quad_sum(a_y[h]), quad_sum(a_z[h])};
        const int col = c0 + 8 * h;
#pragma unroll
        for (int T = 0; T < 6; ++T) {
          if (((2 * T + h) & 3) != t) continue;
          if (T < 3)
            g_phi[jrow + T * F + col] = o[T];
          else
            g_vcat[jrow + (T - 3) * F + col] = o[T];
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

// ---- launches --------------------------------------------------------------

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// Bytes of dynamic shared memory of a centre block (neighbour == false) or
// a neighbour block at these sizes: what the launches below ask for.
template <int R>
size_t smem_bytes(int M, int D, bool want_dw, bool neighbour) {
  if (neighbour) return neighbor_smem_floats<R>((D + NB_EDGES - 1) & ~(NB_EDGES - 1)) * sizeof(float);
  const int Mp = (M + 15) & ~15;
  return (want_dw ? center_smem_floats<R, true>(Mp) : center_smem_floats<R, false>(Mp)) * sizeof(float);
}

// smem_bytes for a radial width R of 8, 16 or 24; 0 for another.
inline size_t smem_bytes(int R, int M, int D, bool want_dw, bool neighbour) {
  switch (R) {
    case 8: return smem_bytes<8>(M, D, want_dw, neighbour);
    case 16: return smem_bytes<16>(M, D, want_dw, neighbour);
    case 24: return smem_bytes<24>(M, D, want_dw, neighbour);
    default: return 0;
  }
}

template <int R, bool WANT_DW>
cudaError_t launch_center(const float* phi, const float* vcat, const float* rbf,
                          const float* envm, const int* nbr, const float* unit,
                          const float* dw, const float* db, const float* gds,
                          const float* gdv, float* g_rbf, float* g_envm,
                          float* g_unit, float* gdw_part, int C, int K, Layout L,
                          cudaStream_t stream) {
  const size_t shmem = smem_bytes<R>(L.M, 0, WANT_DW, false);
  cudaError_t err = allow_smem(center_kernel<R, WANT_DW>, shmem);
  if (err != cudaSuccess) return err;
  center_kernel<R, WANT_DW><<<dim3(L.n_pad, C), THREADS, shmem, stream>>>(
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
  const size_t shmem = smem_bytes<R>(L.M, D, false, true);
  err = allow_smem(neighbor_kernel<R>, shmem);
  if (err != cudaSuccess) return err;
  neighbor_kernel<R><<<dim3(L.n_tab, C), THREADS, shmem, stream>>>(
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
