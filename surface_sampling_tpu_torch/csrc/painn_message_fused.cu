// General PaiNN message block (layers 2+) for the rigid MC path, batched
// over chains C and ensemble members K.
//
// Replaces: surface_sampling_tpu/ops/pallas_painn.py, painn_message_fused
// -> _message_pallas (kernel _msg_kernel). The TPU kernel routes the
// neighbour rows of phi and vcat through one-hot MXU matmuls (bf16 hi/lo
// splits) because TPU gathers serialize; here each neighbour row is loaded
// by index, coalesced across the channel threads.
//
// Per edge e = (i, m), neighbour j = nbr[e], for channel f of F:
//     w_t = (rbf[e] . dw[:, tF + f] + db[tF + f]) * envm[e]    t = vv, s, unit
//     c_t = phi[j, tF + f] * w_t
//     ds[i, f]     += c_s
//     dv[i, x*F+f] += c_unit * unit[x, i, m] + c_vv * vcat[j, x*F + f]
//
// Bound on an H100: operations. Per (chain, member) the radial filter is
// 2 * E * R * 3F multiply-adds (E = n_pad * M) plus ~16 F operations per
// edge for the products and sums, against phi and vcat tables of
// 2 * n_pad * 3F floats that stay in L2 while a (member, chain) is worked.
//
// Design: one block per (centre i, member k, chain c), one thread per
// channel f. The centre's M edge rows (rbf, envelope, neighbour index,
// unit vector) are staged once in shared memory and read as broadcasts;
// thread f keeps its three dist_embed columns (3R floats) in registers.
// The six neighbour-row loads per edge are 4-byte loads by consecutive
// threads, i.e. coalesced 128-byte lines. Each thread owns its outputs:
// no atomics, deterministic sums.

#include <cuda_runtime.h>

namespace {

template <int R>
__global__ void message_kernel(
    const float* __restrict__ phi, const float* __restrict__ vcat,
    const float* __restrict__ rbf, const float* __restrict__ envm,
    const int* __restrict__ nbr, const float* __restrict__ unit,
    const float* __restrict__ dw, const float* __restrict__ db,
    float* __restrict__ ds, float* __restrict__ dv, int K, int n_pad, int M,
    int F) {
  const int i = blockIdx.x, k = blockIdx.y, c = blockIdx.z;
  const int f = threadIdx.x;
  const int F3 = 3 * F;

  extern __shared__ float smem[];
  float* s_rbf = smem;                  // M * R
  float* s_env = s_rbf + M * R;         // M
  float* s_unit = s_env + M;            // 3 * M
  int* s_nbr = reinterpret_cast<int*>(s_unit + 3 * M);  // M

  const size_t e0 = (size_t(c) * n_pad + i) * M;
  for (int t = f; t < M * R; t += blockDim.x) s_rbf[t] = rbf[e0 * R + t];
  for (int t = f; t < M; t += blockDim.x) {
    s_env[t] = envm[e0 + t];
    s_nbr[t] = nbr[e0 + t];
    for (int x = 0; x < 3; ++x)
      s_unit[x * M + t] = unit[((size_t(c) * 3 + x) * n_pad + i) * M + t];
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

  const size_t plane = (size_t(c) * K + k) * n_pad;   // first row of (c, k)
  const float* phik = phi + plane * F3;
  const float* vk = vcat + plane * F3;

  float acc_s = 0.f, acc_x = 0.f, acc_y = 0.f, acc_z = 0.f;
  for (int m = 0; m < M; ++m) {
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
    const size_t j = size_t(s_nbr[m]) * F3;
    const float c_vv = phik[j + f] * tv;
    const float c_s = phik[j + F + f] * ts;
    const float c_u = phik[j + 2 * F + f] * tu;
    acc_s += c_s;
    acc_x += c_u * s_unit[m] + c_vv * vk[j + f];
    acc_y += c_u * s_unit[M + m] + c_vv * vk[j + F + f];
    acc_z += c_u * s_unit[2 * M + m] + c_vv * vk[j + 2 * F + f];
  }
  const size_t row_out = plane + i;
  ds[row_out * F + f] = acc_s;
  float* dvr = dv + row_out * F3;
  dvr[f] = acc_x;
  dvr[F + f] = acc_y;
  dvr[2 * F + f] = acc_z;
}

template <int R>
void launch(const float* phi, const float* vcat, const float* rbf,
            const float* envm, const int* nbr, const float* unit,
            const float* dw, const float* db, float* ds, float* dv, int C,
            int K, int n_pad, int M, int F, cudaStream_t stream) {
  const dim3 grid(n_pad, K, C);
  const size_t shmem = size_t(M) * (R + 4) * sizeof(float) + size_t(M) * sizeof(int);
  message_kernel<R><<<grid, F, shmem, stream>>>(
      phi, vcat, rbf, envm, nbr, unit, dw, db, ds, dv, K, n_pad, M, F);
}

}  // namespace

extern "C" int painn_message_fused(
    const float* phi, const float* vcat, const float* rbf, const float* envm,
    const int* nbr, const float* unit, const float* dw, const float* db,
    float* ds, float* dv, int C, int K, int n_pad, int M, int R, int F,
    cudaStream_t stream) {
  switch (R) {
    case 8: launch<8>(phi, vcat, rbf, envm, nbr, unit, dw, db, ds, dv, C, K, n_pad, M, F, stream); break;
    case 16: launch<16>(phi, vcat, rbf, envm, nbr, unit, dw, db, ds, dv, C, K, n_pad, M, F, stream); break;
    case 24: launch<24>(phi, vcat, rbf, envm, nbr, unit, dw, db, ds, dv, C, K, n_pad, M, F, stream); break;
    case 32: launch<32>(phi, vcat, rbf, envm, nbr, unit, dw, db, ds, dv, C, K, n_pad, M, F, stream); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
