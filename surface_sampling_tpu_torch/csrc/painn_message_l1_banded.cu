// Banded layer-1 PaiNN message for the supercell rigid trunk, batched over
// chains C and ensemble members K.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py,
// painn_message_l1_banded (kernel _msg_kernel_l1_banded). Slots are in the
// routing band's spatial order; the species table arrives extended by a
// halo (its rows [0, halo) appended after row n_pad - 1) and nbr carries
// each neighbour's sorted rank. For a centre of block b = i / n_blk the
// window starts at s = win_start[b]; the neighbour of rank r is row
// s + ((r - s) mod n_pad) of the extended table when (r - s) mod n_pad < W,
// and otherwise reads the zero row T (the TPU kernel's one-hot router over
// W columns matches nothing there). The host builds the band so that every
// selected edge lies in its window.
//
// Per edge e = (i, m), neighbour row j, for channel f of F:
//     w_s = (rbf[e] . dw2[:, f]     + db2[f])     * envm[e]
//     w_u = (rbf[e] . dw2[:, F + f] + db2[F + f]) * envm[e]
//     ds[i, f]      += philt[species[j], f]     * w_s
//     dv[i, x*F+f]  += philt[species[j], F + f] * w_u * unit[x, i, m]
//
// Bound on an H100: operations, as painn_message_l1.cu (2 * E * R * 2F
// multiply-adds of the radial filter per chain and member). The window
// removes no work: a neighbour's species is read by index.
//
// Design: as painn_message_l1.cu. One block per (sorted centre i, member k,
// chain c), one thread per channel; the centre's M edge rows and each
// edge's species are staged in shared memory, the thread's 2R dist_embed
// weights sit in registers. No atomics: deterministic.

#include <cuda_runtime.h>

#include "painn_band.cuh"

namespace {

template <int R>
__global__ void message_l1_banded_kernel(
    const int* __restrict__ species, const float* __restrict__ philt,
    const float* __restrict__ rbf, const float* __restrict__ envm,
    const int* __restrict__ nbr, const float* __restrict__ unit,
    const float* __restrict__ dw2, const float* __restrict__ db2,
    const int* __restrict__ win_start, float* __restrict__ ds,
    float* __restrict__ dv, int K, int n_pad, int n_ext, int M, int F, int T1,
    int n_blk, int W) {
  const int i = blockIdx.x, k = blockIdx.y, c = blockIdx.z;
  const int f = threadIdx.x;
  const int s = win_start[i / n_blk];

  extern __shared__ float smem[];
  float* s_rbf = smem;                  // M * R
  float* s_env = s_rbf + M * R;         // M
  float* s_unit = s_env + M;            // 3 * M
  int* s_sp = reinterpret_cast<int*>(s_unit + 3 * M);  // M

  const size_t e0 = (size_t(c) * n_pad + i) * M;       // first edge of centre i
  for (int t = f; t < M * R; t += blockDim.x) s_rbf[t] = rbf[e0 * R + t];
  for (int t = f; t < M; t += blockDim.x) {
    s_env[t] = envm[e0 + t];
    const int row = banded::window_row(nbr[e0 + t], s, n_pad, W);
    s_sp[t] = row >= 0 ? species[size_t(c) * n_ext + row] : T1 - 1;
    for (int x = 0; x < 3; ++x)
      s_unit[x * M + t] = unit[((size_t(c) * 3 + x) * n_pad + i) * M + t];
  }
  __syncthreads();
  if (f >= F) return;

  const float* dwk = dw2 + size_t(k) * R * 2 * F;
  float ws[R], wu[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ws[r] = dwk[r * 2 * F + f];
    wu[r] = dwk[r * 2 * F + F + f];
  }
  const float bs = db2[size_t(k) * 2 * F + f];
  const float bu = db2[size_t(k) * 2 * F + F + f];
  const float* ph = philt + size_t(k) * T1 * 2 * F;

  float acc_s = 0.f, acc_x = 0.f, acc_y = 0.f, acc_z = 0.f;
  for (int m = 0; m < M; ++m) {
    const float* q = s_rbf + m * R;
    float ts = 0.f, tu = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ts = fmaf(q[r], ws[r], ts);
      tu = fmaf(q[r], wu[r], tu);
    }
    const float e = s_env[m];
    ts = (ts + bs) * e;
    tu = (tu + bu) * e;
    const float* row = ph + size_t(s_sp[m]) * 2 * F;
    const float cs = row[f] * ts;
    const float cu = row[F + f] * tu;
    acc_s += cs;
    acc_x += cu * s_unit[m];
    acc_y += cu * s_unit[M + m];
    acc_z += cu * s_unit[2 * M + m];
  }
  const size_t row_out = (size_t(c) * K + k) * n_pad + i;
  ds[row_out * F + f] = acc_s;
  float* dvr = dv + row_out * 3 * F;
  dvr[f] = acc_x;
  dvr[F + f] = acc_y;
  dvr[2 * F + f] = acc_z;
}

template <int R>
void launch(const int* species, const float* philt, const float* rbf,
            const float* envm, const int* nbr, const float* unit,
            const float* dw2, const float* db2, const int* win_start,
            float* ds, float* dv, int C, int K, int n_pad, int n_ext, int M,
            int F, int T1, int n_blk, int W, cudaStream_t stream) {
  const dim3 grid(n_pad, K, C);
  const size_t shmem = size_t(M) * (R + 4) * sizeof(float) + size_t(M) * sizeof(int);
  message_l1_banded_kernel<R><<<grid, F, shmem, stream>>>(
      species, philt, rbf, envm, nbr, unit, dw2, db2, win_start, ds, dv, K,
      n_pad, n_ext, M, F, T1, n_blk, W);
}

}  // namespace

extern "C" int painn_message_l1_banded(
    const int* species_ext, const float* philt, const float* rbf,
    const float* envm, const int* nbr, const float* unit, const float* dw2,
    const float* db2, const int* win_start, float* ds, float* dv, int C, int K,
    int n_pad, int n_ext, int M, int R, int F, int T1, int n_blk, int W,
    cudaStream_t stream) {
  switch (R) {
    case 8: launch<8>(species_ext, philt, rbf, envm, nbr, unit, dw2, db2, win_start, ds, dv, C, K, n_pad, n_ext, M, F, T1, n_blk, W, stream); break;
    case 16: launch<16>(species_ext, philt, rbf, envm, nbr, unit, dw2, db2, win_start, ds, dv, C, K, n_pad, n_ext, M, F, T1, n_blk, W, stream); break;
    case 24: launch<24>(species_ext, philt, rbf, envm, nbr, unit, dw2, db2, win_start, ds, dv, C, K, n_pad, n_ext, M, F, T1, n_blk, W, stream); break;
    case 32: launch<32>(species_ext, philt, rbf, envm, nbr, unit, dw2, db2, win_start, ds, dv, C, K, n_pad, n_ext, M, F, T1, n_blk, W, stream); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
