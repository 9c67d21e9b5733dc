// Variant of csrc/painn_update_fused.cu for tools/port_profile.py --variants
// (upd_block_ring): one weight ring for the whole block, each k-slice
// staged once for all warps behind a block-wide barrier, the tile's rows
// loaded by plain loads and the epilogue reading them from shared memory.
// The sources' version gives each warp a ring of its own columns.
//
// PaiNN update block for the rigid MC path (the 1x1 trunk, the banded
// supercell trunk and the delta engine), batched over chains C and
// ensemble members K.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py, painn_update_fused
// (kernel _upd_kernel). The TPU kernel runs the six per-atom dots on the
// MXU as bf16 hi/lo splits over blocks of padded rows, every intermediate
// kept in VMEM; here the products run on the tensor cores at f32 accuracy
// (3xTF32, tf32_mma.cuh) over the alive rows only.
//
// Per row (atom) with s (F) and v_x (F) for x = 0, 1, 2:
//     Uv_x = v_x @ U,  Vv_x = v_x @ V
//     h    = silu([s, |Vv|] @ W0 + b0),  |Vv| = sqrt(sum_x Vv_x^2 + 1e-16)
//     a    = h @ W1 + b1 = a_vv | a_sv | a_ss
//     s'   = (s + a_sv * sum_x Uv_x Vv_x + a_ss) * alive
//     v'_x = (v_x + a_vv * Uv_x) * alive
//
// Bound on an H100: operations, 22 F^2 (the products) + ~30 F per alive
// row and member, against 4F floats of the row read and written. The
// design, by what held the first version back:
//
// - Dead rows. About half of the rows are dead or padding (alive == 0),
//   and the function gives them exact zeros whatever they hold. A first
//   kernel lists the alive rows of the (C, n_pad) mask in ascending order
//   (one block, a popcount of 64 flags a thread and a block-wide scan);
//   the update computes those only, packed into tiles of TM rows across
//   chains, and writes zeros to the others. A dead row's s and vcat are
//   never read.
// - The products on the tensor cores. A tile of TM rows of one member runs
//   three products as mma.sync m16n8k8 TF32 tiles with the 3xTF32 split:
//   [v_0; v_1; v_2] (3TM x F) . [U | V] (F x 2F), the three axes sharing U
//   and V; [s, |Vv|] (TM x 2F) . W0 (2F x F); h (TM x F) . W1 (F x 3F).
//   Warp w owns channels 16w .. 16w + 15 of every product, so a thread
//   holds Uv_x and Vv_x of the same (row, channel) for the three axes: |Vv|
//   and <Uv, Vv> are reduced in registers, Uv stays there for the epilogue,
//   and a_vv, a_sv, a_ss of the same (row, channel) meet it there. Only
//   |Vv| and h pass through shared memory, as the next product's operand.
// - The weights streamed, not re-fetched per 8 rows. 7F^2 floats a member
//   (458 KB at F = 128) do not fit in shared memory; k-slices of KS rows of
//   each weight panel run through a cp.async ring of NSTAGE slots, the
//   loads of later slices overlapping the products of the current one. A
//   block is persistent: it walks the (tile, member) items i, i + grid,
//   ..., and the ring runs on from one item into the next, so the next
//   item's first slices arrive during the current one's last product.
// - Shared memory (update_plan::smem_bytes): the tile's v rows (TM x (3F +
//   4)), [s, |Vv|] (TM x (2F + 4)), h (TM x (F + 4)) and the ring (NSTAGE x
//   KS x (3F + 8)); the row strides keep the fragment loads free of bank
//   conflicts. F = 128 (TM = 32, KS = 16): 175,360 bytes, one block of 8
//   warps an SM. F up to 256 takes TM = 16, KS = 8. A block that does not
//   fit is refused by the launch.
//
// F is a multiple of 16 up to 256. Every output is summed in one fixed
// order (the k-slices in order, a row's products independent of its tile
// neighbours), no atomics: launches repeat bitwise.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace update_plan {

constexpr int NSTAGE = 3;             // slots of the weight ring
constexpr int LIST_THREADS = 1024;    // the alive-row list: one block
constexpr int LIST_FLAGS = 64;        // flags a thread and round

// Rows a tile, weight rows a k-slice, for a width F: a warp a 16-channel
// slice (F / 16 warps); at F <= 128 tiles of 32 rows, above of 16 (the
// accumulators of 2F channels of 3TM rows fill a thread's registers).
inline int tile_rows(int F) { return F <= 128 ? 32 : 16; }
inline int slice_rows(int F) { return F <= 128 ? 16 : 8; }

// Bytes of dynamic shared memory of a block of the update at width F.
inline size_t smem_bytes(int F) {
  const int TM = tile_rows(F), KS = slice_rows(F);
  const size_t floats = size_t(TM) * (3 * F + 4) + size_t(TM) * (2 * F + 4) +
                        size_t(TM) * (F + 4) + size_t(NSTAGE) * KS * (3 * F + 8);
  return floats * sizeof(float) + size_t(TM) * (sizeof(int) + sizeof(float));
}

}  // namespace update_plan

namespace {

using namespace tf32mma;
using update_plan::LIST_FLAGS;
using update_plan::LIST_THREADS;
using update_plan::NSTAGE;

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// work[0] = the number of alive rows (alive != 0) of the N = C x n_pad
// mask, work[1 + j] = the flat index c * n_pad + row of the j-th, in
// ascending order.
__global__ void __launch_bounds__(LIST_THREADS) alive_list_kernel(
    const float* __restrict__ alive, int N, int* __restrict__ work) {
  __shared__ int s_warp[LIST_THREADS / 32];
  __shared__ int s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_base = 0;
  for (int base = 0; base < N; base += LIST_THREADS * LIST_FLAGS) {
    const int i0 = base + tid * LIST_FLAGS;
    unsigned long long bits = 0ull;
#pragma unroll
    for (int q = 0; q < LIST_FLAGS / 4; ++q) {
      const int i = i0 + 4 * q;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i + 3 < N) {
        a = __ldg(reinterpret_cast<const float4*>(alive + i));
      } else if (i < N) {
        a.x = alive[i];
        if (i + 1 < N) a.y = alive[i + 1];
        if (i + 2 < N) a.z = alive[i + 2];
      }
      bits |= (unsigned long long)((a.x != 0.f) | (a.y != 0.f) << 1 | (a.z != 0.f) << 2 |
                                   (a.w != 0.f) << 3)
              << (4 * q);
    }
    const int n = __popcll(bits);
    int x = n;                                   // inclusive scan over the block
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    int off = s_base + (warp ? s_warp[warp - 1] : 0) + x - n;
    while (bits) {
      const int b = __ffsll(bits) - 1;
      bits &= bits - 1;
      work[1 + off++] = i0 + b;
    }
    __syncthreads();
    if (tid == 0) s_base += s_warp[LIST_THREADS / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) work[0] = s_base;
}

// One k step of 8 on the fragments: for each of the MA row tiles (16 rows
// of stride AS from a_base + a_off[i], 8 columns) and each of the NB column
// tiles (columns b_col[j] .. + 7 of the ring slot's rows kk .. kk + 7,
// stride BS), acc[i][j] += A . B at 3xTF32. The B fragments are loaded and
// split once for all MA row tiles.
template <int MA, int NB>
__device__ __forceinline__ void tile_step(float (&acc)[MA][NB][4], const float* a_base, int AS,
                                          const int (&a_off)[MA], const float* slot, int BS,
                                          const int (&b_col)[NB], int kk, int g, int t) {
  unsigned bh[NB][2], bl[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    split(slot[(kk + t) * BS + b_col[j] + g], bh[j][0], bl[j][0]);
    split(slot[(kk + t + 4) * BS + b_col[j] + g], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MA; ++i) {
    const float* lo = a_base + a_off[i] + g * AS + t;
    const float* hi = lo + 8 * AS;
    const float a[4] = {lo[0], hi[0], lo[4], hi[4]};
    unsigned ah[4], al[4];
    split_all(a, ah, al);
#pragma unroll
    for (int j = 0; j < NB; ++j) mma3(acc[i][j], ah, al, bh[j], bl[j]);
  }
}

template <int TM, int KS>
__global__ void __launch_bounds__(TM == 32 ? 256 : 512, 1) update_kernel(
    const float* __restrict__ s, const float* __restrict__ vcat,
    const float* __restrict__ U, const float* __restrict__ V,
    const float* __restrict__ W0, const float* __restrict__ b0,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ alive, const int* __restrict__ work,
    float* __restrict__ s_out, float* __restrict__ v_out, int K, int n_pad, int F, int N) {
  constexpr int MT = TM / 16;          // row tiles of 16
  constexpr int KSTEPS = KS / 8;       // mma k steps a slice
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NT = blockDim.x, NW = NT >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int F2 = 2 * F, F3 = 3 * F;
  const int VS = F3 + 4, SVS = F2 + 4, HS = F + 4;     // shared row strides (floats)
  const int ch0 = 16 * warp;                           // this warp's channels
  const int count = work[0];
  const int n_items = (count + TM - 1) / TM * K;
  const int NQ1 = F / KS, NQ2 = F2 / KS, NQ = 4 * F / KS;   // slices of an item

  extern __shared__ __align__(16) float smem[];
  float* s_v = smem;                                   // TM x VS: v rows
  float* s_sv = s_v + TM * VS;                         // TM x SVS: [s, |Vv|]
  float* s_h = s_sv + TM * SVS;                        // TM x HS: h
  float* s_ring = s_h + TM * HS;                       // NSTAGE x KS x (3F + 8)
  int* s_row = reinterpret_cast<int*>(s_ring + NSTAGE * KS * (F3 + 8));   // TM flat rows
  float* s_am = reinterpret_cast<float*>(s_row + TM);                      // TM alive values
  const int slot_floats = KS * (F3 + 8);

  const int my_items =
      int(blockIdx.x) < n_items ? (n_items - 1 - int(blockIdx.x)) / int(gridDim.x) + 1 : 0;
  const int n_q = my_items * NQ;

  // slice q of this block's stream into ring slot q % NSTAGE: item q / NQ,
  // its slice j = q % NQ (P1: U | V rows, P2: W0 rows, P3: W1 rows), one
  // commit group whatever it holds
  auto issue = [&](int q) {
    if (q < n_q) {
      const int it = q / NQ, j = q - it * NQ;
      const int k = (int(blockIdx.x) + it * int(gridDim.x)) % K;
      float* dst = s_ring + (q % NSTAGE) * slot_floats;
      if (j < NQ1) {
        const int f0 = j * KS, c4 = F2 / 4, S = F2 + 8;
        const float* u = U + (size_t(k) * F + f0) * F;
        const float* v = V + (size_t(k) * F + f0) * F;
        for (int c = tid; c < KS * c4; c += NT) {
          const int r = c / c4, col = 4 * (c - r * c4);
          cp_async16(dst + r * S + col, col < F ? u + r * F + col : v + r * F + col - F, true);
        }
      } else if (j < NQ1 + NQ2) {
        const int f0 = (j - NQ1) * KS, c4 = F / 4, S = F + 8;
        const float* w0 = W0 + (size_t(k) * F2 + f0) * F;
        for (int c = tid; c < KS * c4; c += NT) {
          const int r = c / c4, col = 4 * (c - r * c4);
          cp_async16(dst + r * S + col, w0 + r * F + col, true);
        }
      } else {
        const int f0 = (j - NQ1 - NQ2) * KS, c4 = F3 / 4, S = F3 + 8;
        const float* w1 = W1 + (size_t(k) * F + f0) * F3;
        for (int c = tid; c < KS * c4; c += NT) {
          const int r = c / c4, col = 4 * (c - r * c4);
          cp_async16(dst + r * S + col, w1 + r * F3 + col, true);
        }
      }
    }
    cp_async_commit();
  };
  // wait for slice q, free the slot of slice q - 1 for slice q + NSTAGE - 1
  auto consume = [&](int q) -> const float* {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    issue(q + NSTAGE - 1);
    return s_ring + (q % NSTAGE) * slot_floats;
  };

  for (int q = 0; q < NSTAGE - 1; ++q) issue(q);
  int q = 0;
  for (int it = 0; it < my_items; ++it) {
    const int w = int(blockIdx.x) + it * int(gridDim.x);
    const int tile = w / K, k = w - tile * K;
    const int r0 = tile * TM, nr = min(TM, count - r0);

    // ---- the tile's rows: v into s_v, s into s_sv[:, :F]; padding rows zero
    __syncthreads();                  // the previous item's epilogue is done
    for (int r = warp; r < TM; r += NW) {
      float4* dv = reinterpret_cast<float4*>(s_v + r * VS);
      float4* dsv = reinterpret_cast<float4*>(s_sv + r * SVS);
      if (r < nr) {
        const int flat = work[1 + r0 + r];
        const int c = flat / n_pad;
        const size_t gr = (size_t(c) * K + k) * n_pad + (flat - c * n_pad);
        const float4* src_s = reinterpret_cast<const float4*>(s + gr * F);
        const float4* src_v = reinterpret_cast<const float4*>(vcat + gr * F3);
        for (int i = lane; i < F / 4; i += 32) dsv[i] = __ldg(src_s + i);
        for (int i = lane; i < F3 / 4; i += 32) dv[i] = __ldg(src_v + i);
        if (lane == 0) {
          s_row[r] = flat;
          s_am[r] = alive[flat];
        }
      } else {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = lane; i < F / 4; i += 32) dsv[i] = z;
        for (int i = lane; i < F3 / 4; i += 32) dv[i] = z;
      }
    }

    // ---- P1: [Uv_x | Vv_x] = v_x . [U | V]; acc1[x MT + mt][j]: row tile
    // mt of axis x (columns x F + f of the v rows), j = U columns ch0, ch0 +
    // 8, then V columns ch0, ch0 + 8
    float acc1[3 * MT][4][4];
#pragma unroll
    for (int i = 0; i < 3 * MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[i][j][e] = 0.f;
    {
      int offs[3 * MT];
#pragma unroll
      for (int i = 0; i < 3 * MT; ++i) offs[i] = (i / MT) * F + (i % MT) * 16 * VS;
      const int b_col[4] = {ch0, ch0 + 8, F + ch0, F + ch0 + 8};
      for (int j = 0; j < NQ1; ++j, ++q) {
        const float* slot = consume(q);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          tile_step<3 * MT, 4>(acc1, s_v + j * KS + ks * 8, VS, offs, slot, F2 + 8, b_col,
                               ks * 8, g, t);
      }
    }
    // |Vv| into s_sv[:, F:], <Uv, Vv> and Uv kept: element e of a fragment
    // is row mt 16 + g + 8 (e >> 1), channel ch0 + 8 h + 2t + (e & 1)
    float uv[3][MT][2][4], inner[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sq = 0.f, in = 0.f;
#pragma unroll
          for (int x = 0; x < 3; ++x) {
            const float u = acc1[x * MT + mt][h][e], vv = acc1[x * MT + mt][2 + h][e];
            uv[x][mt][h][e] = u;
            sq += vv * vv;
            in += u * vv;
          }
          inner[mt][h][e] = in;
          const int r = mt * 16 + g + 8 * (e >> 1), ch = ch0 + 8 * h + 2 * t + (e & 1);
          s_sv[r * SVS + F + ch] = sqrtf(sq + 1e-16f);
        }

    // ---- P2: h = silu([s, |Vv|] . W0 + b0) into s_h
    {
      float acc2[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[mt][h][e] = 0.f;
      int offs[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) offs[mt] = mt * 16 * SVS;
      const int b_col[2] = {ch0, ch0 + 8};
      for (int j = 0; j < NQ2; ++j, ++q) {
        const float* slot = consume(q);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          tile_step<MT, 2>(acc2, s_sv + j * KS + ks * 8, SVS, offs, slot, F + 8, b_col, ks * 8,
                           g, t);
      }
      const float* b0k = b0 + size_t(k) * F;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + g + 8 * (e >> 1), ch = ch0 + 8 * h + 2 * t + (e & 1);
            s_h[r * HS + ch] = silu(acc2[mt][h][e] + __ldg(b0k + ch));
          }
    }

    // ---- P3: a = h . W1 + b1 (a_vv | a_sv | a_ss), then the epilogue
    {
      float acc3[MT][6][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc3[mt][j][e] = 0.f;
      int offs[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) offs[mt] = mt * 16 * HS;
      const int b_col[6] = {ch0, ch0 + 8, F + ch0, F + ch0 + 8, F2 + ch0, F2 + ch0 + 8};
      for (int j = 0; j < NQ1; ++j, ++q) {
        const float* slot = consume(q);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          tile_step<MT, 6>(acc3, s_h + j * KS + ks * 8, HS, offs, slot, F3 + 8, b_col, ks * 8, g,
                           t);
      }
      const float* b1k = b1 + size_t(k) * F3;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = mt * 16 + g + 8 * hr;
            if (r >= nr) continue;
            const int ch = ch0 + 8 * h + 2 * t;
            const float am = s_am[r];
            const int flat = s_row[r], c = flat / n_pad;
            const size_t gr = (size_t(c) * K + k) * n_pad + (flat - c * n_pad);
            float so[2], vo[3][2];
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              const int e = 2 * hr + p;
              const float a_vv = acc3[mt][h][e] + __ldg(b1k + ch + p);
              const float a_sv = acc3[mt][2 + h][e] + __ldg(b1k + F + ch + p);
              const float a_ss = acc3[mt][4 + h][e] + __ldg(b1k + F2 + ch + p);
              so[p] = (s_sv[r * SVS + ch + p] + a_sv * inner[mt][h][e] + a_ss) * am;
#pragma unroll
              for (int x = 0; x < 3; ++x)
                vo[x][p] = (s_v[r * VS + x * F + ch + p] + a_vv * uv[x][mt][h][e]) * am;
            }
            *reinterpret_cast<float2*>(s_out + gr * F + ch) = make_float2(so[0], so[1]);
#pragma unroll
            for (int x = 0; x < 3; ++x)
              *reinterpret_cast<float2*>(v_out + gr * F3 + x * F + ch) =
                  make_float2(vo[x][0], vo[x][1]);
          }
    }
  }
  cp_async_wait<0>();

  // ---- dead rows: exact zeros for every member, a warp a row
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = int(blockIdx.x) * NW + warp; i < N; i += int(gridDim.x) * NW) {
    if (alive[i] != 0.f) continue;
    const int c = i / n_pad;
    for (int kk = 0; kk < K; ++kk) {
      const size_t gr = (size_t(c) * K + kk) * n_pad + (i - c * n_pad);
      float4* so = reinterpret_cast<float4*>(s_out + gr * F);
      float4* vo = reinterpret_cast<float4*>(v_out + gr * F3);
      for (int j = lane; j < F / 4; j += 32) so[j] = z;
      for (int j = lane; j < F3 / 4; j += 32) vo[j] = z;
    }
  }
}

template <int TM, int KS>
cudaError_t launch(const float* s, const float* vcat, const float* U, const float* V,
                   const float* W0, const float* b0, const float* W1, const float* b1,
                   const float* alive, int* work, float* s_out, float* v_out, int C, int K,
                   int n_pad, int F, cudaStream_t stream) {
  const int threads = 2 * F, N = C * n_pad;     // a warp a 16-channel slice
  const size_t shmem = update_plan::smem_bytes(F);
  cudaError_t err = cudaFuncSetAttribute(update_kernel<TM, KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(shmem));
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, update_kernel<TM, KS>,
                                                           threads, shmem)) != cudaSuccess)
    return err;
  // persistent blocks, at most one for each tile of the worst case (every row alive)
  const long long most = (long long)((N + TM - 1) / TM) * K;
  const int blocks = int(max(1LL, min(most, (long long)n_sm * max(per_sm, 1))));
  alive_list_kernel<<<1, LIST_THREADS, 0, stream>>>(alive, N, work);
  update_kernel<TM, KS><<<blocks, threads, shmem, stream>>>(s, vcat, U, V, W0, b0, W1, b1, alive,
                                                           work, s_out, v_out, K, n_pad, F, N);
  return cudaGetLastError();
}

}  // namespace

// Launches the update for F a multiple of 16 up to 256 and returns
// cudaGetLastError() (a refused launch never runs). work is scratch of C x
// n_pad + 1 ints: the alive rows' list.
extern "C" int painn_update_fused(
    const float* s, const float* vcat, const float* U, const float* V,
    const float* W0, const float* b0, const float* W1, const float* b1,
    const float* alive, int* work, float* s_out, float* v_out, int C, int K, int n_pad,
    int F, cudaStream_t stream) {
  if (F < 16 || F > 256 || F % 16) return int(cudaErrorInvalidValue);
  if (F <= 128)
    return int(launch<32, 16>(s, vcat, U, V, W0, b0, W1, b1, alive, work, s_out, v_out, C, K,
                              n_pad, F, stream));
  return int(launch<16, 8>(s, vcat, U, V, W0, b0, W1, b1, alive, work, s_out, v_out, C, K,
                           n_pad, F, stream));
}

// Rows a tile and bytes of dynamic shared memory of a block at width F,
// for chip_smoke.py.
extern "C" int painn_update_fused_tile_rows(int F) { return update_plan::tile_rows(F); }
extern "C" int painn_update_fused_smem(int F) { return int(update_plan::smem_bytes(F)); }
