// PaiNN update block for the rigid MC path, batched over chains C and
// ensemble members K.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py, painn_update_fused
// (kernel _upd_kernel). The TPU kernel runs the six per-atom dots on the
// MXU as bf16 hi/lo splits; here they are f32 multiply-adds on the CUDA
// cores, with every intermediate kept on chip as there.
//
// Per row (atom) with s (F) and v_x (F) for x = 0, 1, 2:
//     Uv_x = v_x @ U,  Vv_x = v_x @ V
//     h    = silu([s, |Vv|] @ W0 + b0),  |Vv| = sqrt(sum_x Vv_x^2 + 1e-16)
//     a    = h @ W1 + b1 = a_vv | a_sv | a_ss
//     s'   = (s + a_sv * sum_x Uv_x Vv_x + a_ss) * alive
//     v'_x = (v_x + a_vv * Uv_x) * alive
//
// Bound on an H100: operations, 2 * (6F^2 + 2F^2 + 3F^2) per row against
// 4F floats of row input. The weights (7F^2 floats per member, 460 KB at
// F = 128) are what the card moves most: every block reads them from L2.
//
// Design: one block per (tile of ROWS rows, member k, chain c), one thread
// per output channel g. The tile's s and vcat rows are staged in shared
// memory and read as broadcasts; each weight element is loaded once per
// block (coalesced across g) and used for all ROWS rows, so the L2 weight
// traffic is 1/ROWS of a row-per-block design. Uv and Vv stay in registers
// of the thread that owns channel g; |Vv| and h pass through shared memory
// to the next matrix-vector product. No atomics: deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__global__ void update_kernel(
    const float* __restrict__ s, const float* __restrict__ vcat,
    const float* __restrict__ U, const float* __restrict__ V,
    const float* __restrict__ W0, const float* __restrict__ b0,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ alive, float* __restrict__ s_out,
    float* __restrict__ v_out, int K, int n_pad, int F) {
  const int row0 = blockIdx.x * ROWS, k = blockIdx.y, c = blockIdx.z;
  const int g = threadIdx.x;
  const int F3 = 3 * F;
  const int rows = min(ROWS, n_pad - row0);

  extern __shared__ float smem[];
  float* sh_s = smem;                    // ROWS * F
  float* sh_v = sh_s + ROWS * F;         // ROWS * 3F
  float* sh_n = sh_v + ROWS * F3;        // ROWS * F   |Vv|
  float* sh_h = sh_n + ROWS * F;         // ROWS * F   h

  const size_t base = (size_t(c) * K + k) * n_pad + row0;
  for (int t = g; t < rows * F; t += blockDim.x) sh_s[t] = s[base * F + t];
  for (int t = g; t < rows * F3; t += blockDim.x) sh_v[t] = vcat[base * F3 + t];
  __syncthreads();

  const float* Uk = U + size_t(k) * F * F;
  const float* Vk = V + size_t(k) * F * F;
  float uv[3][ROWS], vv[3][ROWS];
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) uv[x][r] = vv[x][r] = 0.f;
  for (int f = 0; f < F; ++f) {
    const float u = Uk[f * F + g], w = Vk[f * F + g];
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float q = sh_v[r * F3 + x * F + f];
        uv[x][r] = fmaf(q, u, uv[x][r]);
        vv[x][r] = fmaf(q, w, vv[x][r]);
      }
  }
  float inner[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float sq = 0.f, in = 0.f;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      sq += vv[x][r] * vv[x][r];
      in += uv[x][r] * vv[x][r];
    }
    inner[r] = in;
    sh_n[r * F + g] = sqrtf(sq + 1e-16f);
  }
  __syncthreads();

  // h = silu([s, |Vv|] @ W0 + b0)
  const float* W0k = W0 + size_t(k) * 2 * F * F;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int f = 0; f < F; ++f) {
    const float w = W0k[f * F + g];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(sh_s[r * F + f], w, acc[r]);
  }
  for (int f = 0; f < F; ++f) {
    const float w = W0k[(F + f) * F + g];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(sh_n[r * F + f], w, acc[r]);
  }
  const float bias0 = b0[size_t(k) * F + g];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) sh_h[r * F + g] = silu(acc[r] + bias0);
  __syncthreads();

  // a = h @ W1 + b1, three channels per thread
  const float* W1k = W1 + size_t(k) * F * F3;
  float a_vv[ROWS], a_sv[ROWS], a_ss[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) a_vv[r] = a_sv[r] = a_ss[r] = 0.f;
  for (int f = 0; f < F; ++f) {
    const float wv = W1k[f * F3 + g], wsv = W1k[f * F3 + F + g],
                wss = W1k[f * F3 + 2 * F + g];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float hv = sh_h[r * F + f];
      a_vv[r] = fmaf(hv, wv, a_vv[r]);
      a_sv[r] = fmaf(hv, wsv, a_sv[r]);
      a_ss[r] = fmaf(hv, wss, a_ss[r]);
    }
  }
  const float* b1k = b1 + size_t(k) * F3;
  const float bvv = b1k[g], bsv = b1k[F + g], bss = b1k[2 * F + g];

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rows) break;
    const float am = alive[size_t(c) * n_pad + row0 + r];
    const size_t row = base + r;
    s_out[row * F + g] =
        (sh_s[r * F + g] + (a_sv[r] + bsv) * inner[r] + (a_ss[r] + bss)) * am;
#pragma unroll
    for (int x = 0; x < 3; ++x)
      v_out[row * F3 + x * F + g] =
          (sh_v[r * F3 + x * F + g] + (a_vv[r] + bvv) * uv[x][r]) * am;
  }
}

}  // namespace

extern "C" int painn_update_fused(
    const float* s, const float* vcat, const float* U, const float* V,
    const float* W0, const float* b0, const float* W1, const float* b1,
    const float* alive, float* s_out, float* v_out, int C, int K, int n_pad,
    int F, cudaStream_t stream) {
  const dim3 grid((n_pad + ROWS - 1) / ROWS, K, C);
  const size_t shmem = size_t(ROWS) * 6 * F * sizeof(float);
  update_kernel<<<grid, F, shmem, stream>>>(s, vcat, U, V, W0, b0, W1, b1,
                                            alive, s_out, v_out, K, n_pad, F);
  return int(cudaGetLastError());
}
