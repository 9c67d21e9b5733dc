// The fused EAM pair pass (row 13 of PERF.md's kernel table), batched over
// chains C: rho (C, N) and ep (C, N) from slot positions pos (C, N, 3), alive
// (C, N) as 0/1 floats, and a static candidate table of M neighbours a slot
// (kernel_j (N, M): the neighbour slot, or -1 for padding; shift (N, M, 3)).
//
// Replaces: surface_sampling_tpu/ops/pallas_eam.py, make_pallas_eam_energy
// -> batched_rho_ep (inner kernel). Per pair (i, m), j = kernel_j[i, m]:
//   r = sqrt(max(|pos_i - (pos_j + shift)|^2, 1e-12)), live when j >= 0,
//   alive_i + alive_j > 1.5 and r < cutoff;
//   u = (clip(r, r_lo, r_hi) - mid) / half, wall = 100 (q^2 + q^4) with
//   q = 8 max(r_lo - r, 0);
//   rho_i += cheb_rho(u) + wall, ep_i += (cheb_z2r(u) + wall) / r,
// two degree-24 Chebyshev series by Clenshaw in f32; ep is halved at the
// end. Dead and masked pairs add nothing (the TPU kernel multiplies their
// finite terms by 0).
//
// Bound: operations. A live pair costs ~175 f32 operations (two 24-step
// Clenshaw recurrences, r, u, the wall, one division) against 12 bytes of
// positions read per slot, so the kernel is far above the card's
// operations-per-byte line. The TPU kernel routes the pair endpoints and
// the per-atom sum through dense 0/1 (N, N*M) matrices on the MXU; here a
// block stages the candidate table (49 kB at Cu(100) 2x2x2), the 2 x 25
// coefficients and the positions of its chains in shared memory once, and
// a warp takes one (chain, centre) row at a time: lanes stride over the M
// pairs, gather the neighbour by index, evaluate both series interleaved
// from coefficients held in registers, and a shuffle tree sums the lanes
// in a fixed order, so results repeat bitwise and no float atomics are
// needed. Rows of dead centres cost one test.

#include <cuda_runtime.h>

namespace {

constexpr int DEG = 24;
constexpr int NC = DEG + 1;
constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int N_SCAL = 5;        // cutoff, r_lo, r_hi, mid, half after the coefficients
constexpr int COEF_PAD = 2 * NC + 8;

__global__ void __launch_bounds__(NT)
rho_ep_kernel(const float* __restrict__ pos, const float* __restrict__ alive,
              const int* __restrict__ kernel_j, const float* __restrict__ shift,
              const float* __restrict__ operand, float* __restrict__ rho_out,
              float* __restrict__ ep_out, int C, int N, int M, int cpb) {
  extern __shared__ float smem[];
  const int P = N * M;
  float* s_shift = smem;                                   // 3 P
  int* s_j = reinterpret_cast<int*>(s_shift + 3 * P);      // P
  float* s_coef = reinterpret_cast<float*>(s_j + P);       // 2 NC + N_SCAL (padded)
  float* s_pos = s_coef + COEF_PAD;                        // cpb N 3
  float* s_alive = s_pos + size_t(cpb) * N * 3;            // cpb N

  const int c0 = blockIdx.x * cpb;
  const int nc = min(cpb, C - c0);
  for (int t = threadIdx.x; t < 3 * P; t += NT) s_shift[t] = shift[t];
  for (int t = threadIdx.x; t < P; t += NT) s_j[t] = kernel_j[t];
  for (int t = threadIdx.x; t < 2 * NC + N_SCAL; t += NT) s_coef[t] = operand[t];
  for (int t = threadIdx.x; t < nc * N * 3; t += NT) s_pos[t] = pos[size_t(c0) * N * 3 + t];
  for (int t = threadIdx.x; t < nc * N; t += NT) s_alive[t] = alive[size_t(c0) * N + t];
  __syncthreads();

  float cr[NC], cz[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    cr[k] = s_coef[k];
    cz[k] = s_coef[NC + k];
  }
  const float cutoff = s_coef[2 * NC + 0];
  const float r_lo = s_coef[2 * NC + 1];
  const float r_hi = s_coef[2 * NC + 2];
  const float mid = s_coef[2 * NC + 3];
  const float half = s_coef[2 * NC + 4];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = warp; row < nc * N; row += NWARP) {
    const int c = row / N;
    const int i = row - c * N;
    const float a_i = s_alive[row];
    float rho = 0.f, ep = 0.f;
    if (a_i > 0.f) {
      const float* pc = s_pos + size_t(c) * N * 3;
      const float* ac = s_alive + size_t(c) * N;
      const float xi = pc[3 * i], yi = pc[3 * i + 1], zi = pc[3 * i + 2];
      for (int m = lane; m < M; m += 32) {
        const int p = i * M + m;
        const int j = s_j[p];
        if (j < 0 || !(a_i + ac[j] > 1.5f)) continue;
        const float dx = xi - (pc[3 * j] + s_shift[3 * p]);
        const float dy = yi - (pc[3 * j + 1] + s_shift[3 * p + 1]);
        const float dz = zi - (pc[3 * j + 2] + s_shift[3 * p + 2]);
        const float r = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f));
        if (!(r < cutoff)) continue;
        const float u = (fminf(fmaxf(r, r_lo), r_hi) - mid) / half;
        const float two_u = 2.f * u;
        float b1r = 0.f, b2r = 0.f, b1z = 0.f, b2z = 0.f;
#pragma unroll
        for (int k = NC - 1; k > 0; --k) {
          const float tr = cr[k] + two_u * b1r - b2r;
          const float tz = cz[k] + two_u * b1z - b2z;
          b2r = b1r;
          b1r = tr;
          b2z = b1z;
          b1z = tz;
        }
        const float q = 8.f * fmaxf(r_lo - r, 0.f);
        const float q2 = q * q;
        const float w = 100.f * (q2 + q2 * q2);
        rho += (cr[0] + u * b1r - b2r) + w;
        ep += ((cz[0] + u * b1z - b2z) + w) / r;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        rho += __shfl_down_sync(0xffffffffu, rho, off);
        ep += __shfl_down_sync(0xffffffffu, ep, off);
      }
    }
    if (lane == 0) {
      const size_t o = size_t(c0 + c) * N + i;
      rho_out[o] = rho;
      ep_out[o] = 0.5f * ep;
    }
  }
}

}  // namespace

extern "C" int eam_rho_ep(const float* pos, const float* alive, const int* kernel_j,
                          const float* shift, const float* operand, float* rho, float* ep,
                          int C, int N, int M, int cpb, cudaStream_t stream) {
  if (C < 1 || N < 1 || M < 1 || cpb < 1) return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (size_t(4) * N * M + COEF_PAD + size_t(cpb) * N * 4);
  if (smem > 232448) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rho_ep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int blocks = (C + cpb - 1) / cpb;
  rho_ep_kernel<<<blocks, NT, smem, stream>>>(pos, alive, kernel_j, shift, operand, rho, ep, C,
                                              N, M, cpb);
  return int(cudaGetLastError());
}
