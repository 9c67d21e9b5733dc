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
// split by who owns each output, on the pattern of the first-order
// backward (painn_message_bwd.cuh):
//
//   centre_kernel     a fixed grid of CENTRE_BLOCKS_PER_SM blocks an SM
//                     (centre_blocks()), block b owning a static,
//                     contiguous range of the C * n_pad (chain, centre)
//                     rows, one centre after another. Per centre: the
//                     per-edge d_rbf (C, E, R), d_envm (C, E) and d_unit
//                     (C, 3, n_pad, M), summed over the members, and the
//                     centre's d_gds and d_gdv; over its rows, the block's
//                     d_dw / d_db partial (K, R + 1, 3F), which the caller
//                     sums over the blocks in block order.
//   neighbour_kernel  one block per (table row j, chain c), the members
//                     inside: d_phi and d_vcat of row j, summed over the
//                     edges that read row j, listed by the reverse table.
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
// G and Z . c_dw of d_rbf vanish and the kernels skip them. With them, the
// c_dw fragments are read from L1 where they are used.
//
// Bound on an H100: operations, f32 (F (30R + 130) per live slot and
// member, ~29R F of them the radial products; chip_smoke.py [bwd2] prints
// the bound with every operation at the f32 rate and with the products at
// 3 TF32 passes). What holds the work back, and what the design does
// about it:
//
// - Dead slots. A slot is live when envm != 0 or c_envm != 0; at a slot
//   with both zero every term but d_envm's carries a zero factor. The
//   centre kernel compacts the live slots in ascending order (a ballot per
//   warp, warps in order) and computes those only; the neighbour kernel
//   walks the reverse table. Dead-slot contract, as the first-order
//   backward's: at a dead slot the kernel writes exact zeros to d_rbf,
//   d_unit AND d_envm. The plain version gives sum_{t,f} (A_t wpre_t + g_t
//   P_t G_t) for d_envm there; that value reaches only envm's inputs, the
//   positions, and force-loss training takes its gradient over the
//   parameters alone (ROADMAP Queue 3, tests/test_torch_bwd_contract.py).
//   The reverse-table contract: d_phi and d_vcat at an edge left out of the
//   table are c_envm wpre g_t and g_dv c_envm wpre P_vv, zero only where
//   c_envm is 0 too; so an edge may be left out only if envm == 0 and
//   c_envm == 0 there. Training meets both: the cotangent reaching g_envm
//   passes back through envm = envelope * mask.
// - The radial products run on the tensor cores as mma.sync m16n8k8 TF32
//   with the 3xTF32 split of tf32_mma.cuh (f32 accuracy). The centre kernel
//   tiles 16 live edges of its centre (the mma rows) by 8 channels of each
//   of the three types (the mma columns): W = RBF . dw and G = CRBF . dw
//   (+ RBF . c_dw) share the filter's B fragments, held in registers per
//   (member, channel group); the elementwise terms (Q, T, A, dwpre, Z, the
//   d_gds / d_gdv sums, the d_envm and d_unit summands) run on the
//   accumulator fragments; d_rbf = dwpre . dw^T (+ Z . c_dw^T) takes the
//   dwpre / Z fragments as its A operand with the k index permuted, as the
//   first-order backward does with G; d_dw += RBF^T . dwpre + CRBF^T . Z
//   takes dwpre and Z through the spent stage of the warp's ring in shared
//   memory (row R of RBF^T is ones, giving d_db). The neighbour kernel
//   computes W^T and G^T over tiles of 16 channels by 8 incoming edges, so
//   each thread's partial sums over edges stay in its own registers.
// - The per-edge sums (d_rbf, d_envm, d_unit over 3F channels and the
//   members). No per-edge shuffle reduction: d_rbf accumulates in the mma's
//   fragments, d_envm and d_unit are per-thread partials over two channels,
//   added across the quad, then into the warp's slice of shared memory;
//   the four warps' slices are added in warp order at the end of a centre.
// - The d_dw partials. A block adds each centre's tile sums into its own
//   partial (K, R + 1, 3F), every entry owned by one lane, and the caller
//   sums the partials of the blocks in block order: CENTRE_BLOCKS_PER_SM x
//   SMs partials (10 MB at the training shape), not one per centre. That
//   read-modify-write of the partial, once per (member, channel group) and
//   centre, costs ~50 us of the kernel at the training shape
//   (tools/port_profile.py --variants bwd2_noflush).
// - Row gathers. Each warp copies the neighbour rows phi[j], vcat[j],
//   c_phi[j], c_vcat[j] of its next tile (16 edges x 12 x 8 channels), or
//   the centre rows g_ds[i], g_dv[i] of its next tiles (neighbour kernel: 8
//   edges x 4 x 16 channels), into a cp.async ring while the current tile
//   computes; the staged rows are padded so that the fragment reads are
//   free of bank conflicts.
//
// Summation orders are fixed: the centre kernel sums a warp's units in
// order (members, then channel groups), then the warps in order; d_gds and
// d_gdv over a lane's edge rows, tile by tile, then the 8 lanes of a
// channel pair by a fixed butterfly; d_dw over the block's centres in
// order, each centre's tiles in order, then the blocks in order; the
// neighbour kernel each thread's edges (the reverse table's ascending
// order, two per tile), then the quad by a fixed tree. No float atomics,
// so launches repeat bitwise on a card (the d_dw bits depend on the SM
// count, which a card fixes).

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace msgbwd2 {

using namespace tf32mma;

struct Args {
  const float *phi, *vcat, *rbf, *envm;
  const int* nbr;
  const float *unit, *dw, *db, *gds, *gdv;
  const float *cphi, *cvcat, *crbf, *cenvm, *cunit, *cdw, *cdb;
  const int* rev;
  float *dphi, *dvcat, *drbf, *denvm, *dunit, *dgds, *dgdv, *ddw_part;
  int C, K, n_pad, M, F, D;
};

constexpr int NW = 4;                 // warps a block
constexpr int THREADS = NW * 32;
constexpr int CT_ROWS = 16;           // live edges a centre tile (mma rows)
constexpr int CT_STRIDE = 104;        // floats a staged neighbour row: 12 x 8 channels + 8 pad
constexpr int G_STRIDE = 56;          // floats a row of the dwpre | Z tile (2 x 24 + 8 pad)
constexpr int CT_STAGES = 2;          // depth of the centre kernel's cp.async ring
constexpr int NB_EDGES = 8;           // incoming edges a neighbour tile (mma columns)
constexpr int NB_CH = 16;             // channels a neighbour tile (mma rows)
constexpr int NB_STRIDE = 68;         // floats a staged centre row: 4 x 16 channels + 4 pad
constexpr int NB_STAGES = 3;          // depth of the neighbour kernel's cp.async ring
constexpr int CENTRE_BLOCKS_PER_SM = 2;
// resident neighbour blocks an SM the registers are cut for: with c_dw, without
constexpr int NB_CDW_BLOCKS_PER_SM = 2, NB_BLOCKS_PER_SM = 3;

static_assert(CT_ROWS * G_STRIDE <= CT_ROWS * CT_STRIDE, "the dwpre | Z tile fits a ring stage");

// Two floats of a read-only input (8-byte aligned).
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Element v[upper] of lane src's pair v.
__device__ __forceinline__ unsigned pick(const unsigned (&v)[2], int src, bool upper) {
  const unsigned lo = __shfl_sync(FULL, v[0], src), hi = __shfl_sync(FULL, v[1], src);
  return upper ? hi : lo;
}

template <int R>
__host__ __device__ constexpr size_t centre_smem_floats(int Mp) {
  return size_t(NW) * CT_STAGES * CT_ROWS * CT_STRIDE + size_t(NW + 2) * Mp * (R + 4) +
         size_t(10) * Mp + NW;
}

template <int R>
__host__ __device__ constexpr size_t neighbour_smem_floats(int Dp) {
  return size_t(NW) * NB_STAGES * NB_EDGES * NB_STRIDE + size_t(2) * Dp * (R + 4) +
         size_t(9) * Dp;
}

// ---- centre kernel ---------------------------------------------------------
//
// A unit of a warp's work is (member k, channel group cg of 8 channels in
// each of vv | s | unit, row tile rt of 16 live edges), in that nesting;
// warp w takes the channel groups w, w + NW, ... Lane (g, t) = (lane / 4,
// lane % 4) holds, in the mma's accumulator layout, edges 16 rt + g and
// 16 rt + g + 8 and channels 8 cg + 2t, 8 cg + 2t + 1.
template <int R, bool HAS_CDW>
__global__ void __launch_bounds__(THREADS, CENTRE_BLOCKS_PER_SM) centre_kernel(Args a) {
  static_assert(R % 8 == 0 && R <= 24, "R must be 8, 16 or 24");
  constexpr int S = R + 4;            // floats a staged rbf row (col R: 1 in rbf, 0 in c_rbf)
  constexpr int KS = R / 8;           // k steps of the filter, n tiles of d_rbf
  constexpr int MT = (R + 16) / 16;   // m tiles of d_dw (R + 1 rows)
  const int n_pad = a.n_pad, M = a.M, F = a.F, F3 = 3 * F, K = a.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Mp = (M + 15) & ~15;

  extern __shared__ __align__(16) float smem[];
  float* s_ring = smem;                                        // NW x CT_STAGES x 16 x CT_STRIDE
  float* s_acc = s_ring + NW * CT_STAGES * CT_ROWS * CT_STRIDE;  // NW x Mp x S
  float* s_rbf = s_acc + NW * Mp * S;                            // Mp x S
  float* s_crbf = s_rbf + Mp * S;                                // Mp x S
  float* s_env = s_crbf + Mp * S;                                // Mp
  float* s_cenv = s_env + Mp;                                    // Mp
  float* s_unit = s_cenv + Mp;                                   // 3 x Mp
  float* s_cunit = s_unit + 3 * Mp;                              // 3 x Mp
  int* s_slot = reinterpret_cast<int*>(s_cunit + 3 * Mp);        // Mp: slot of live row
  int* s_row = s_slot + Mp;                                      // Mp: table row, -1 zeros
  int* s_cnt = s_row + Mp;                                       // NW

  // this block's rows of the C x n_pad (chain, centre) rows, and its partial
  const int rows = a.C * n_pad;
  const int q0 = int((long long)blockIdx.x * rows / gridDim.x);
  const int q1 = int((long long)(blockIdx.x + 1) * rows / gridDim.x);
  float* part = a.ddw_part + size_t(blockIdx.x) * K * (R + 1) * F3;
  // each lane zeroes the partial entries it adds to below
  for (int k = 0; k < K; ++k)
    for (int cg = warp; cg < F / 8; cg += NW)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int T = 0; T < 3; ++T)
#pragma unroll
          for (int idx = 0; idx < 4; ++idx) {
            const int r = mt * 16 + g + 8 * (idx >> 1);
            if (r <= R) part[(size_t(k) * (R + 1) + r) * F3 + T * F + cg * 8 + 2 * t + (idx & 1)] = 0.f;
          }

  for (int q = q0; q < q1; ++q) {
    const int c = q / n_pad, i = q - c * n_pad;
    const size_t e0 = size_t(q) * M;
    __syncthreads();  // the previous centre's readers of the shared arrays are done

    // live slots (envm != 0 or c_envm != 0) in ascending order: a ballot
    // per warp, warps in order
    int n_live = 0;
    for (int m0 = 0; m0 < M; m0 += THREADS) {
      const int m = m0 + tid;
      const bool lv = m < M && (__ldg(a.envm + e0 + m) != 0.f || __ldg(a.cenvm + e0 + m) != 0.f);
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
      if (__ldg(a.envm + e0 + m) != 0.f || __ldg(a.cenvm + e0 + m) != 0.f) continue;
      for (int r = 0; r < R; ++r) a.drbf[(e0 + m) * R + r] = 0.f;
      a.denvm[e0 + m] = 0.f;
      for (int x = 0; x < 3; ++x) a.dunit[((size_t(c) * 3 + x) * n_pad + i) * M + m] = 0.f;
    }
    if (n_live == 0) {
      for (int u = tid; u < K * F; u += THREADS) {
        const int k = u / F, f = u - k * F;
        const size_t ci = (size_t(c) * K + k) * n_pad + i;
        a.dgds[ci * F + f] = 0.f;
        a.dgdv[ci * F3 + f] = 0.f;
        a.dgdv[ci * F3 + F + f] = 0.f;
        a.dgdv[ci * F3 + 2 * F + f] = 0.f;
      }
      continue;
    }

    // the live rows of rbf and c_rbf by asynchronous copies (all in flight
    // at once); column R of rbf is 1 (d_db), padding zeros
    const int Lp = (n_live + CT_ROWS - 1) & ~(CT_ROWS - 1);
    for (int p = tid; p < Lp * S; p += THREADS) {
      const int row = p / S, col = p - row * S;
      if (row < n_live && col < R) {
        const size_t o = (e0 + s_slot[row]) * R + col;
        cp_async4(s_rbf + p, a.rbf + o);
        cp_async4(s_crbf + p, a.crbf + o);
      } else {
        s_rbf[p] = row < n_live && col == R ? 1.f : 0.f;
        s_crbf[p] = 0.f;
      }
    }
    cp_async_commit();
    for (int p = tid; p < NW * Mp * S; p += THREADS) s_acc[p] = 0.f;
    for (int row = tid; row < Lp; row += THREADS) {
      float env = 0.f, cenv = 0.f, u[3] = {}, cu[3] = {};
      int jrow = -1;
      if (row < n_live) {
        const int m = s_slot[row];
        env = __ldg(a.envm + e0 + m);
        cenv = __ldg(a.cenvm + e0 + m);
        jrow = __ldg(a.nbr + e0 + m);
        for (int x = 0; x < 3; ++x) {
          const size_t ux = ((size_t(c) * 3 + x) * n_pad + i) * M + m;
          u[x] = __ldg(a.unit + ux);
          cu[x] = __ldg(a.cunit + ux);
        }
      }
      s_env[row] = env;
      s_cenv[row] = cenv;
      s_row[row] = jrow;
      for (int x = 0; x < 3; ++x) {
        s_unit[x * Mp + row] = u[x];
        s_cunit[x * Mp + row] = cu[x];
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    const int n_rt = Lp / CT_ROWS;
    const int n_cgw = (F / 8 - warp + NW - 1) / NW;
    const int n_units = K * n_cgw * n_rt;
    float* ring = s_ring + warp * CT_STAGES * CT_ROWS * CT_STRIDE;
    float* acc = s_acc + warp * Mp * S;

    // stage a unit's neighbour rows (16 edges x phi, vcat, c_phi, c_vcat,
    // each vv|s|u or x|y|z, x 8 channels) into a ring stage: 384 copies of
    // 16 bytes, 12 a lane
    auto issue = [&](int k, int cg, int rt, int stage) {
      const size_t tplane = (size_t(c) * K + k) * n_pad;
      float* dst = ring + stage * CT_ROWS * CT_STRIDE;
#pragma unroll
      for (int p = 0; p < CT_ROWS * 24 / 32; ++p) {
        const int qq = lane + 32 * p;
        const int row = qq / 24, part24 = qq - row * 24;
        const int typ = part24 >> 1, half = part24 & 1;
        const int r = s_row[rt * CT_ROWS + row];
        const float* table = typ < 3 ? a.phi : typ < 6 ? a.vcat : typ < 9 ? a.cphi : a.cvcat;
        const float* src =
            r >= 0 ? table + (tplane + r) * F3 + (typ % 3) * F + cg * 8 + half * 4 : a.phi;
        cp_async16(dst + row * CT_STRIDE + typ * 8 + half * 4, src, r >= 0);
      }
    };

    // per (k, cg): centre cotangents, biases, the filter's B fragments, the
    // d_dw tile sums and the d_gds / d_gdv sums of this lane's two channels
    float gs[2], gx[2], gy[2], gz[2], bias[3][2], cbias[3][2];
    unsigned fbh[3][KS][2], fbl[3][KS][2];
    float dacc[MT][3][4];
    float sgs[2], sgx[2], sgy[2], sgz[2];

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
      const float* dwk = a.dw + size_t(k) * R * F3;
      const float* cdwk = HAS_CDW ? a.cdw + size_t(k) * R * F3 : nullptr;
      const size_t ci = (size_t(c) * K + k) * n_pad + i;
      float* part_k = part + size_t(k) * (R + 1) * F3;
      if (rt == 0) {
        // every load first (read-only, so that they are in flight together)
        float bw[3][KS][2];
#pragma unroll
        for (int T = 0; T < 3; ++T)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            // B (r x channel): b0 = (r = 8ks + t, col g), b1 = (r = 8ks + t + 4, col g)
            bw[T][ks][0] = __ldg(dwk + (ks * 8 + t) * F3 + T * F + cg * 8 + g);
            bw[T][ks][1] = __ldg(dwk + (ks * 8 + t + 4) * F3 + T * F + cg * 8 + g);
          }
        const float2 s2 = ldg2(a.gds + ci * F + ch);
        const float2 x2 = ldg2(a.gdv + ci * F3 + ch);
        const float2 y2 = ldg2(a.gdv + ci * F3 + F + ch);
        const float2 z2 = ldg2(a.gdv + ci * F3 + 2 * F + ch);
        gs[0] = s2.x; gs[1] = s2.y; gx[0] = x2.x; gx[1] = x2.y;
        gy[0] = y2.x; gy[1] = y2.y; gz[0] = z2.x; gz[1] = z2.y;
#pragma unroll
        for (int T = 0; T < 3; ++T) {
          const float2 b2 = ldg2(a.db + size_t(k) * F3 + T * F + ch);
          bias[T][0] = b2.x;
          bias[T][1] = b2.y;
          cbias[T][0] = cbias[T][1] = 0.f;
          if constexpr (HAS_CDW) {
            const float2 c2 = ldg2(a.cdb + size_t(k) * F3 + T * F + ch);
            cbias[T][0] = c2.x;
            cbias[T][1] = c2.y;
          }
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            split(bw[T][ks][0], fbh[T][ks][0], fbl[T][ks][0]);
            split(bw[T][ks][1], fbh[T][ks][1], fbl[T][ks][1]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int T = 0; T < 3; ++T)
#pragma unroll
            for (int idx = 0; idx < 4; ++idx) dacc[mt][T][idx] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) sgs[h] = sgx[h] = sgy[h] = sgz[h] = 0.f;
      }

      // W_T = RBF . dw_T and G_T = CRBF . dw_T (+ RBF . c_dw_T), 16 edges x
      // 8 channels per type T
      const int r0 = rt * CT_ROWS;
      float w[3][4], G[3][4];
#pragma unroll
      for (int T = 0; T < 3; ++T)
#pragma unroll
        for (int idx = 0; idx < 4; ++idx) w[T][idx] = G[T][idx] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int o_lo = (r0 + g) * S + ks * 8 + t, o_hi = o_lo + 8 * S;
        const float ar[4] = {s_rbf[o_lo], s_rbf[o_hi], s_rbf[o_lo + 4], s_rbf[o_hi + 4]};
        const float ac[4] = {s_crbf[o_lo], s_crbf[o_hi], s_crbf[o_lo + 4], s_crbf[o_hi + 4]};
        unsigned ah[4], al[4], bh_[4], bl_[4];
        split_all(ar, ah, al);
        split_all(ac, bh_, bl_);
#pragma unroll
        for (int T = 0; T < 3; ++T) {
          mma3(w[T], ah, al, fbh[T][ks], fbl[T][ks]);
          mma3(G[T], bh_, bl_, fbh[T][ks], fbl[T][ks]);
          if constexpr (HAS_CDW) {
            unsigned ch_[2], cl_[2];
            split(__ldg(cdwk + (ks * 8 + t) * F3 + T * F + cg * 8 + g), ch_[0], cl_[0]);
            split(__ldg(cdwk + (ks * 8 + t + 4) * F3 + T * F + cg * 8 + g), ch_[1], cl_[1]);
            mma3(G[T], ah, al, ch_, cl_);
          }
        }
      }

      // elementwise, on the accumulator fragments: index 2 hr + q is edge
      // r0 + g + 8 hr, channel ch + q; dwpre goes to w, Z to G
      float* st = ring + (u % CT_STAGES) * CT_ROWS * CT_STRIDE;
      float pe[2], pux[2], puy[2], puz[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = g + 8 * hr, e = r0 + row;
        const float env = s_env[e], cenv = s_cenv[e];
        const float ux = s_unit[e], uy = s_unit[Mp + e], uz = s_unit[2 * Mp + e];
        const float cux = s_cunit[e], cuy = s_cunit[Mp + e], cuz = s_cunit[2 * Mp + e];
        const float* sr = st + row * CT_STRIDE + 2 * t;
        float2 v2[12];
#pragma unroll
        for (int y = 0; y < 12; ++y) v2[y] = *reinterpret_cast<const float2*>(sr + 8 * y);
        pe[hr] = pux[hr] = puy[hr] = puz[hr] = 0.f;
#pragma unroll
        for (int qc = 0; qc < 2; ++qc) {
          const int idx = 2 * hr + qc;
          float v[12];
#pragma unroll
          for (int y = 0; y < 12; ++y) v[y] = qc ? v2[y].y : v2[y].x;
          const float pv = v[0], ps = v[1], pu = v[2], qx = v[3], qy = v[4], qz = v[5];
          const float cpv = v[6], cps = v[7], cpu = v[8], cqx = v[9], cqy = v[10], cqz = v[11];
          const float pre_v = w[0][idx] + bias[0][qc];
          const float pre_s = w[1][idx] + bias[1][qc];
          const float pre_u = w[2][idx] + bias[2][qc];
          const float hv = G[0][idx] + cbias[0][qc];
          const float hs = G[1][idx] + cbias[1][qc];
          const float hu = G[2][idx] + cbias[2][qc];
          const float w_v = pre_v * env, w_s = pre_s * env, w_u = pre_u * env;
          const float gi_v = gx[qc] * qx + gy[qc] * qy + gz[qc] * qz;
          const float gi_u = gx[qc] * ux + gy[qc] * uy + gz[qc] * uz;
          const float h_v = hv * env + cenv * pre_v;
          const float h_s = hs * env + cenv * pre_s;
          const float h_u = hu * env + cenv * pre_u;
          const float q_v = cpv * w_v + h_v * pv;
          const float q_s = cps * w_s + h_s * ps;
          const float q_u = cpu * w_u + h_u * pu;
          const float t_v = gx[qc] * cqx + gy[qc] * cqy + gz[qc] * cqz;
          const float t_u = gx[qc] * cux + gy[qc] * cuy + gz[qc] * cuz;
          const float c_vv = pv * w_v, c_u = pu * w_u;
          sgs[qc] += q_s;
          sgx[qc] += q_v * qx + q_u * ux + cqx * c_vv + cux * c_u;
          sgy[qc] += q_v * qy + q_u * uy + cqy * c_vv + cuy * c_u;
          sgz[qc] += q_v * qz + q_u * uz + cqz * c_vv + cuz * c_u;
          const float a_v = gi_v * cpv + t_v * pv, a_s = gs[qc] * cps, a_u = gi_u * cpu + t_u * pu;
          const float gp_v = gi_v * pv, gp_s = gs[qc] * ps, gp_u = gi_u * pu;
          pe[hr] += a_v * pre_v + a_s * pre_s + a_u * pre_u + gp_v * hv + gp_s * hs + gp_u * hu;
          pux[hr] += gx[qc] * q_u;
          puy[hr] += gy[qc] * q_u;
          puz[hr] += gz[qc] * q_u;
          w[0][idx] = a_v * env + gp_v * cenv;     // dwpre
          w[1][idx] = a_s * env + gp_s * cenv;
          w[2][idx] = a_u * env + gp_u * cenv;
          G[0][idx] = gp_v * env;                  // Z
          G[1][idx] = gp_s * env;
          G[2][idx] = gp_u * env;
        }
      }

      // d_rbf (16 edges x R) = dwpre (16 x 24 channels) . dw^T (+ Z . c_dw^T).
      // The accumulator fragment is the A operand with the k index permuted
      // inside each 8-wide step (k = t <-> channel 2t, k = t + 4 <-> channel
      // 2t + 1), so B is (r = 8 nt + g; channels 2t, 2t + 1): the filter's B
      // fragments held by lanes (2t, g & 3) and (2t + 1, g & 3), element
      // g / 4, fetched by shuffles already split.
      float dr[KS][4];
#pragma unroll
      for (int nt = 0; nt < KS; ++nt)
#pragma unroll
        for (int idx = 0; idx < 4; ++idx) dr[nt][idx] = 0.f;
      const int src0 = 8 * t + (g & 3), src1 = src0 + 4;
      const bool upper = g >= 4;
#pragma unroll
      for (int T = 0; T < 3; ++T) {
        const float ad[4] = {w[T][0], w[T][2], w[T][1], w[T][3]};
        unsigned ah[4], al[4];
        split_all(ad, ah, al);
#pragma unroll
        for (int nt = 0; nt < KS; ++nt) {
          unsigned bh[2], bl[2];
          bh[0] = pick(fbh[T][nt], src0, upper);
          bh[1] = pick(fbh[T][nt], src1, upper);
          bl[0] = pick(fbl[T][nt], src0, upper);
          bl[1] = pick(fbl[T][nt], src1, upper);
          mma3(dr[nt], ah, al, bh, bl);
        }
        if constexpr (HAS_CDW) {
          const float az[4] = {G[T][0], G[T][2], G[T][1], G[T][3]};
          split_all(az, ah, al);
#pragma unroll
          for (int nt = 0; nt < KS; ++nt) {
            const float2 b2 = ldg2(cdwk + (nt * 8 + g) * F3 + T * F + ch);
            unsigned bh[2], bl[2];
            split(b2.x, bh[0], bl[0]);
            split(b2.y, bh[1], bl[1]);
            mma3(dr[nt], ah, al, bh, bl);
          }
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
        // d_envm, d_unit x | y | z: the quad's sum, lane t adds column R + t
        const float s0 = quad_sum(pe[hr]), s1 = quad_sum(pux[hr]);
        const float s2 = quad_sum(puy[hr]), s3 = quad_sum(puz[hr]);
        ar[R + t] += t == 0 ? s0 : t == 1 ? s1 : t == 2 ? s2 : s3;
      }

      // d_dw_k (R + 1 x 24 channels) += RBF^T (R + 1 x 16 edges) . dwpre +
      // CRBF^T . Z; row R of RBF^T is ones (d_db), of CRBF^T zeros. dwpre
      // and Z reach the B operand's layout through the spent ring stage.
      __syncwarp();
#pragma unroll
      for (int T = 0; T < 3; ++T)
#pragma unroll
        for (int idx = 0; idx < 4; ++idx) {
          const int o = (g + 8 * (idx >> 1)) * G_STRIDE + T * 8 + 2 * t + (idx & 1);
          st[o] = w[T][idx];
          st[o + 24] = G[T][idx];
        }
      __syncwarp();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int e_lo = r0 + ks * 8 + t, e_hi = e_lo + 4;
        unsigned dh[3][2], dl[3][2], zh[3][2], zl[3][2];
#pragma unroll
        for (int T = 0; T < 3; ++T) {
          const int o0 = (ks * 8 + t) * G_STRIDE + T * 8 + g, o1 = o0 + 4 * G_STRIDE;
          split(st[o0], dh[T][0], dl[T][0]);
          split(st[o1], dh[T][1], dl[T][1]);
          split(st[o0 + 24], zh[T][0], zl[T][0]);
          split(st[o1 + 24], zh[T][1], zl[T][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int ra = mt * 16 + g, rb = ra + 8;
          const float xr[4] = {ra < S ? s_rbf[e_lo * S + ra] : 0.f,
                               rb < S ? s_rbf[e_lo * S + rb] : 0.f,
                               ra < S ? s_rbf[e_hi * S + ra] : 0.f,
                               rb < S ? s_rbf[e_hi * S + rb] : 0.f};
          const float xc[4] = {ra < S ? s_crbf[e_lo * S + ra] : 0.f,
                               rb < S ? s_crbf[e_lo * S + rb] : 0.f,
                               ra < S ? s_crbf[e_hi * S + ra] : 0.f,
                               rb < S ? s_crbf[e_hi * S + rb] : 0.f};
          unsigned ah[4], al[4], ch4[4], cl4[4];
          split_all(xr, ah, al);
          split_all(xc, ch4, cl4);
#pragma unroll
          for (int T = 0; T < 3; ++T) {
            mma3(dacc[mt][T], ah, al, dh[T], dl[T]);
            mma3(dacc[mt][T], ch4, cl4, zh[T], zl[T]);
          }
        }
      }

      if (rt == n_rt - 1) {
        // the centre's d_dw tile sums into the block's partial: every load
        // first, so that they are in flight together, then the stores
        float2 old[MT][3][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int T = 0; T < 3; ++T)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = mt * 16 + g + 8 * hr;
              old[mt][T][hr] = r <= R ? *reinterpret_cast<const float2*>(
                                            part_k + size_t(r) * F3 + T * F + ch)
                                      : make_float2(0.f, 0.f);
            }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int T = 0; T < 3; ++T)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = mt * 16 + g + 8 * hr;
              if (r > R) continue;
              *reinterpret_cast<float2*>(part_k + size_t(r) * F3 + T * F + ch) =
                  make_float2(old[mt][T][hr].x + dacc[mt][T][2 * hr],
                              old[mt][T][hr].y + dacc[mt][T][2 * hr + 1]);
            }
        // d_gds, d_gdv: the 8 lanes of this channel pair by a fixed butterfly
#pragma unroll
        for (int qc = 0; qc < 2; ++qc)
#pragma unroll
          for (int x = 4; x < 32; x <<= 1) {
            sgs[qc] += __shfl_xor_sync(FULL, sgs[qc], x);
            sgx[qc] += __shfl_xor_sync(FULL, sgx[qc], x);
            sgy[qc] += __shfl_xor_sync(FULL, sgy[qc], x);
            sgz[qc] += __shfl_xor_sync(FULL, sgz[qc], x);
          }
        if (g == 0) {
          *reinterpret_cast<float2*>(a.dgds + ci * F + ch) = make_float2(sgs[0], sgs[1]);
          float* gv = a.dgdv + ci * F3 + ch;
          *reinterpret_cast<float2*>(gv) = make_float2(sgx[0], sgx[1]);
          *reinterpret_cast<float2*>(gv + F) = make_float2(sgy[0], sgy[1]);
          *reinterpret_cast<float2*>(gv + 2 * F) = make_float2(sgz[0], sgz[1]);
        }
      }
      __syncwarp();
    }
    cp_async_wait<0>();
    __syncthreads();

    // the warps' slices in warp order
    for (int p = tid; p < n_live * S; p += THREADS) {
      const int row = p / S, col = p - row * S;
      float v = s_acc[p];
      for (int w = 1; w < NW; ++w) v += s_acc[w * Mp * S + p];
      const int m = s_slot[row];
      if (col < R)
        a.drbf[(e0 + m) * R + col] = v;
      else if (col == R)
        a.denvm[e0 + m] = v;
      else
        a.dunit[((size_t(c) * 3 + (col - R - 1)) * n_pad + i) * M + m] = v;
    }
  }
}

// ---- neighbour kernel ------------------------------------------------------
//
// A unit of a warp's work is (member k, channel tile ct of 16 channels in
// each of vv | s | unit, edge tile et of 8 incoming edges), in that
// nesting; warp w takes the channel tiles w, w + NW, ... Lane (g, t) holds,
// in the accumulator layout of W^T (16 channels x 8 edges), channels
// 16 ct + g and 16 ct + g + 8 and incoming edges 8 et + 2t, 8 et + 2t + 1.
template <int R, bool HAS_CDW>
__global__ void __launch_bounds__(THREADS, HAS_CDW ? NB_CDW_BLOCKS_PER_SM : NB_BLOCKS_PER_SM)
    neighbour_kernel(Args a) {
  constexpr int S = R + 4, KS = R / 8;
  const int n_pad = a.n_pad, M = a.M, F = a.F, F3 = 3 * F, K = a.K, D = a.D;
  const int j = blockIdx.x, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t E = size_t(n_pad) * M;
  const int Dp = (D + NB_EDGES - 1) & ~(NB_EDGES - 1);

  extern __shared__ __align__(16) float smem[];
  float* s_ring = smem;                                   // NW x NB_STAGES x 8 x NB_STRIDE
  float* s_rbf = s_ring + NW * NB_STAGES * NB_EDGES * NB_STRIDE;  // Dp x S
  float* s_crbf = s_rbf + Dp * S;                            // Dp x S
  float* s_env = s_crbf + Dp * S;                            // Dp
  float* s_cenv = s_env + Dp;                                // Dp
  float* s_unit = s_cenv + Dp;                               // 3 x Dp
  float* s_cunit = s_unit + 3 * Dp;                          // 3 x Dp
  int* s_ci = reinterpret_cast<int*>(s_cunit + 3 * Dp);      // Dp: centre row, -1 zeros

  // the reverse table lists the incoming edges first, ascending, then -1
  const int* rj = a.rev + (size_t(c) * n_pad + j) * D;
  int n_in = 0;
  for (int d0 = 0; d0 < D; d0 += THREADS) {
    const int d = d0 + tid;
    n_in += __syncthreads_count(d < D && __ldg(rj + d) >= 0);
  }
  if (n_in == 0) {
    for (int p = tid; p < K * F3; p += THREADS) {
      const int k = p / F3, col = p - k * F3;
      const size_t row = ((size_t(c) * K + k) * n_pad + j) * F3;
      a.dphi[row + col] = 0.f;
      a.dvcat[row + col] = 0.f;
    }
    return;
  }

  const int Lp = (n_in + NB_EDGES - 1) & ~(NB_EDGES - 1);
  for (int row = tid; row < Lp; row += THREADS) {
    float env = 0.f, cenv = 0.f, u[3] = {}, cu[3] = {};
    int ci = -1;
    if (row < n_in) {
      const int e = __ldg(rj + row);
      const int i = e / M, m = e - i * M;
      env = __ldg(a.envm + size_t(c) * E + e);
      cenv = __ldg(a.cenvm + size_t(c) * E + e);
      for (int x = 0; x < 3; ++x) {
        const size_t ux = ((size_t(c) * 3 + x) * n_pad + i) * M + m;
        u[x] = __ldg(a.unit + ux);
        cu[x] = __ldg(a.cunit + ux);
      }
      ci = i;
    }
    s_env[row] = env;
    s_cenv[row] = cenv;
    for (int x = 0; x < 3; ++x) {
      s_unit[x * Dp + row] = u[x];
      s_cunit[x * Dp + row] = cu[x];
    }
    s_ci[row] = ci;
  }
  // the incoming edges' rows of rbf and c_rbf by asynchronous copies (all
  // in flight at once), padding zeros
  for (int p = tid; p < Lp * S; p += THREADS) {
    const int row = p / S, col = p - row * S;
    if (row < n_in && col < R) {
      const size_t o = (size_t(c) * E + __ldg(rj + row)) * R + col;
      cp_async4(s_rbf + p, a.rbf + o);
      cp_async4(s_crbf + p, a.crbf + o);
    } else {
      s_rbf[p] = s_crbf[p] = 0.f;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
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
      const int qq = lane + 32 * p;
      const int edge = qq >> 4, typ = (qq >> 2) & 3, quarter = qq & 3;
      const int ci = s_ci[et * NB_EDGES + edge];
      const float* src = a.gds;
      if (ci >= 0)
        src = (typ == 0 ? a.gds + (cplane + ci) * F : a.gdv + (cplane + ci) * F3 + (typ - 1) * F) +
              ct * NB_CH + quarter * 4;
      cp_async16(dst + edge * NB_STRIDE + typ * NB_CH + quarter * 4, src, ci >= 0);
    }
  };

  // per (k, ct): the filter's A fragments (dw^T: channel x r), biases, and
  // row j's phi_vv, vcat, c_phi_vv and c_vcat at this lane's two channels;
  // the sums
  unsigned fah[3][KS][4], fal[3][KS][4];
  float bias[3][2], cbias[3][2], pv[2], vx[2], vy[2], vz[2], cpv[2], cvx[2], cvy[2], cvz[2];
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
    const size_t jrow = ((size_t(c) * K + k) * n_pad + j) * F3;
    const float* cdwk = HAS_CDW ? a.cdw + size_t(k) * R * F3 : nullptr;
    if (et == 0) {
      const float* dwk = a.dw + size_t(k) * R * F3;
#pragma unroll
      for (int T = 0; T < 3; ++T) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          // A (channel x r): a0 (c0, 8ks + t), a1 (c0 + 8, 8ks + t),
          // a2 (c0, 8ks + t + 4), a3 (c0 + 8, 8ks + t + 4)
          const float av[4] = {__ldg(dwk + (ks * 8 + t) * F3 + T * F + c0),
                               __ldg(dwk + (ks * 8 + t) * F3 + T * F + c0 + 8),
                               __ldg(dwk + (ks * 8 + t + 4) * F3 + T * F + c0),
                               __ldg(dwk + (ks * 8 + t + 4) * F3 + T * F + c0 + 8)};
          split_all(av, fah[T][ks], fal[T][ks]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bias[T][h] = __ldg(a.db + size_t(k) * F3 + T * F + c0 + 8 * h);
          cbias[T][h] = HAS_CDW ? __ldg(a.cdb + size_t(k) * F3 + T * F + c0 + 8 * h) : 0.f;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t o = jrow + c0 + 8 * h;
        pv[h] = __ldg(a.phi + o);
        vx[h] = __ldg(a.vcat + o);
        vy[h] = __ldg(a.vcat + o + F);
        vz[h] = __ldg(a.vcat + o + 2 * F);
        cpv[h] = __ldg(a.cphi + o);
        cvx[h] = __ldg(a.cvcat + o);
        cvy[h] = __ldg(a.cvcat + o + F);
        cvz[h] = __ldg(a.cvcat + o + 2 * F);
        a_v[h] = a_s[h] = a_u[h] = a_x[h] = a_y[h] = a_z[h] = 0.f;
      }
    }

    // W^T_T = dw_T^T . RBF^T and G^T_T = dw_T^T . CRBF^T (+ c_dw_T^T .
    // RBF^T), 16 channels x 8 edges per type T
    const int e0 = et * NB_EDGES;
    float w[3][4], G[3][4];
#pragma unroll
    for (int T = 0; T < 3; ++T)
#pragma unroll
      for (int idx = 0; idx < 4; ++idx) w[T][idx] = G[T][idx] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned bh[2], bl[2], ch_[2], cl_[2];
      split(s_rbf[(e0 + g) * S + ks * 8 + t], bh[0], bl[0]);
      split(s_rbf[(e0 + g) * S + ks * 8 + t + 4], bh[1], bl[1]);
      split(s_crbf[(e0 + g) * S + ks * 8 + t], ch_[0], cl_[0]);
      split(s_crbf[(e0 + g) * S + ks * 8 + t + 4], ch_[1], cl_[1]);
#pragma unroll
      for (int T = 0; T < 3; ++T) {
        mma3(w[T], fah[T][ks], fal[T][ks], bh, bl);
        mma3(G[T], fah[T][ks], fal[T][ks], ch_, cl_);
        if constexpr (HAS_CDW) {
          const float av[4] = {__ldg(cdwk + (ks * 8 + t) * F3 + T * F + c0),
                               __ldg(cdwk + (ks * 8 + t) * F3 + T * F + c0 + 8),
                               __ldg(cdwk + (ks * 8 + t + 4) * F3 + T * F + c0),
                               __ldg(cdwk + (ks * 8 + t + 4) * F3 + T * F + c0 + 8)};
          unsigned ah[4], al[4];
          split_all(av, ah, al);
          mma3(G[T], ah, al, bh, bl);
        }
      }
    }

    // fragment index 2h + q: channel c0 + 8h, incoming edge e0 + 2t + q;
    // each lane adds its edges in ascending order
    const float* st = ring + (u % NB_STAGES) * NB_EDGES * NB_STRIDE;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int le = e0 + 2 * t + q;
      const float env = s_env[le], cenv = s_cenv[le];
      const float ux = s_unit[le], uy = s_unit[Dp + le], uz = s_unit[2 * Dp + le];
      const float cux = s_cunit[le], cuy = s_cunit[Dp + le], cuz = s_cunit[2 * Dp + le];
      const float* sg = st + (2 * t + q) * NB_STRIDE;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 2 * h + q, cl = g + 8 * h;
        const float gs = sg[cl], gx = sg[NB_CH + cl], gy = sg[2 * NB_CH + cl],
                    gz = sg[3 * NB_CH + cl];
        const float pre_v = w[0][idx] + bias[0][h];
        const float pre_s = w[1][idx] + bias[1][h];
        const float pre_u = w[2][idx] + bias[2][h];
        const float w_v = pre_v * env, w_u = pre_u * env;
        const float h_v = (G[0][idx] + cbias[0][h]) * env + cenv * pre_v;
        const float h_s = (G[1][idx] + cbias[1][h]) * env + cenv * pre_s;
        const float h_u = (G[2][idx] + cbias[2][h]) * env + cenv * pre_u;
        const float gi_v = gx * vx[h] + gy * vy[h] + gz * vz[h];
        const float gi_u = gx * ux + gy * uy + gz * uz;
        const float t_v = gx * cvx[h] + gy * cvy[h] + gz * cvz[h];
        const float t_u = gx * cux + gy * cuy + gz * cuz;
        a_v[h] += h_v * gi_v + t_v * w_v;
        a_s[h] += h_s * gs;
        a_u[h] += h_u * gi_u + t_u * w_u;
        const float q_v = cpv[h] * w_v + h_v * pv[h];
        a_x[h] += gx * q_v;
        a_y[h] += gy * q_v;
        a_z[h] += gz * q_v;
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
            a.dphi[jrow + T * F + col] = o[T];
          else
            a.dvcat[jrow + (T - 3) * F + col] = o[T];
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

// ---- launches --------------------------------------------------------------

// Blocks of the centre kernel, hence d_dw partials: CENTRE_BLOCKS_PER_SM
// for each SM of the current device.
inline int centre_blocks() {
  int dev = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return CENTRE_BLOCKS_PER_SM * n_sm;
}

// Bytes of dynamic shared memory of a centre block (neighbour == false) or
// a neighbour block at these sizes: what the launches below ask for.
template <int R>
size_t smem_bytes(int M, int D, bool neighbour) {
  if (neighbour) return neighbour_smem_floats<R>((D + NB_EDGES - 1) & ~(NB_EDGES - 1)) * sizeof(float);
  return centre_smem_floats<R>((M + 15) & ~15) * sizeof(float);
}

inline size_t smem_bytes(int R, int M, int D, bool neighbour) {
  switch (R) {
    case 8: return smem_bytes<8>(M, D, neighbour);
    case 16: return smem_bytes<16>(M, D, neighbour);
    case 24: return smem_bytes<24>(M, D, neighbour);
    default: return 0;
  }
}

template <int R, bool HAS_CDW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int blocks = centre_blocks();
  if (blocks <= 0) return cudaErrorInvalidValue;
  size_t shmem = smem_bytes<R>(a.M, a.D, false);
  cudaError_t err = cudaFuncSetAttribute(centre_kernel<R, HAS_CDW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(shmem));
  if (err != cudaSuccess) return err;
  centre_kernel<R, HAS_CDW><<<blocks, THREADS, shmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  shmem = smem_bytes<R>(a.M, a.D, true);
  err = cudaFuncSetAttribute(neighbour_kernel<R, HAS_CDW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(shmem));
  if (err != cudaSuccess) return err;
  neighbour_kernel<R, HAS_CDW><<<dim3(a.n_pad, a.C), THREADS, shmem, stream>>>(a);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_r(const Args& a, int has_cdw, cudaStream_t stream) {
  return has_cdw ? launch<R, true>(a, stream) : launch<R, false>(a, stream);
}

}  // namespace msgbwd2

// Launches both kernels for a radial width R of 8, 16 or 24 and returns the
// first CUDA error (a refused launch never runs). c_dw / c_db are read only
// when has_cdw is set. ddw_part holds painn_message_bwd2_blocks() partials
// of (K, R + 1, 3F).
extern "C" int painn_message_bwd2(
    const float* phi, const float* vcat, const float* rbf, const float* envm,
    const int* nbr, const float* unit, const float* dw, const float* db,
    const float* gds, const float* gdv, const float* cphi, const float* cvcat,
    const float* crbf, const float* cenvm, const float* cunit, const float* cdw,
    const float* cdb, const int* rev, float* dphi, float* dvcat, float* drbf,
    float* denvm, float* dunit, float* dgds, float* dgdv, float* ddw_part,
    int C, int K, int n_pad, int M, int R, int F, int D, int has_cdw,
    cudaStream_t stream) {
  if (F % msgbwd2::NB_CH != 0) return int(cudaErrorInvalidValue);
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

// The number of d_dw / d_db partials a launch on the current device writes
// (the centre kernel's blocks), for the wrapper that allocates them.
extern "C" int painn_message_bwd2_blocks() { return msgbwd2::centre_blocks(); }

// Bytes of dynamic shared memory that a centre block (neighbour = 0) or a
// neighbour block of the launch takes; 0 for an R it does not take.
extern "C" int painn_message_bwd2_smem(int R, int M, int D, int neighbour) {
  return int(msgbwd2::smem_bytes(R, M, D, neighbour != 0));
}
