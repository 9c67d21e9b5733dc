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
// the per-atom sum through dense 0/1 (N, N*M) matrices on the MXU; here
// pairs are gathered by index. The design, by what holds the work back:
//
// - Dead pairs. At the Cu(100) shape of the MC path ~11% of the candidate
//   slots are live (padding, dead slots, pairs beyond the cutoff), so a
//   lane per candidate would run the two series mostly for nothing, and
//   even the distance costs more than the tests that rule most candidates
//   out. A warp takes one chain at a time and walks its alive centres (a
//   ballot of the staged aliveness: a dead centre costs nothing but its
//   zero outputs, written while staging). For each, two compactions: the
//   candidates whose neighbour is valid and alive (j >= 0, alive_i +
//   alive_j > 1.5: one table load and one shared read a candidate, the
//   loads of two chunks of 32 issued together) are listed by ballots in
//   ascending slot order; then the listed ones, 32 at a time, compute r
//   and append the live ones (r < cutoff) to the warp's ring in shared
//   memory. Whenever 32 wait, the warp evaluates both series on them, a
//   live pair a lane, and writes the two terms back in place; the pairs of
//   several centres share a round. A dead pair's shift and a dead
//   neighbour's position are never read, and a dead centre's position
//   neither.
// - Fixed-order sums. A centre whose terms are all evaluated (a queue of
//   pending centres, oldest first) is summed from the ring: lane l adds its
//   terms l, l + 32, ... in ascending slot order, then a fixed butterfly.
//   A centre's bits depend only on its own live pairs, not on the rounds
//   they shared or the warp: launches repeat bitwise, with no float
//   atomics.
// - Latency and issue slots. The chain's positions and aliveness are
//   staged in the warp's shared memory (one coalesced pass), so a candidate
//   costs one global load (its neighbour index, read through L1: the table
//   is 49 kB at Cu(100) 2x2x2, shared by every chain) and shared ones, and a
//   listed one its shift. The recurrences read their 50 coefficients as constant-bank
//   operands (__constant__, copied from the operand array on the launch's
//   stream before each launch), not registers, so that many warps fit an
//   SM. A block takes cpb chains, a warp each.
//
// The ring of a warp holds at least M + 64 entries (a power of two): a
// centre's terms (at most M) stay in it until they are summed, and at most
// 31 entries appended after the oldest pending centre's last, plus a chunk
// of 32 being appended, lie beside them. The queue: a centre is pushed when
// fewer than 32 entries wait, so the pending centres' ends are distinct and
// lie within 31 of each other (32 at most). The coefficients in constant
// memory are one set a device: launches on several streams at once would
// race for them (the port runs one stream).

#include <cuda_runtime.h>

namespace {

constexpr int DEG = 24;
constexpr int NC = DEG + 1;
constexpr int NWARP = 16;        // warps a block (fewer when their shared memory would not fit)
constexpr int U = 2;             // chunks of 32 candidates whose loads are issued together
constexpr int QCAP = 32;         // pending centres a warp (at most 32 are ever pending)
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;

// Entries of a warp's ring for M candidates a centre.
int ring_entries(int M) {
  int cap = 64;
  while (cap < M + 64) cap <<= 1;
  return cap;
}

// Shared memory of one warp: its ring (float2 entries), its queue of
// pending centres (row, first entry, end entry), its chain's N positions
// and aliveness (x, y, z, alive) and its centre's listed candidates (slot,
// neighbour).
__host__ __device__ constexpr size_t warp_smem_bytes(int cap, int N, int M) {
  return size_t(cap) * sizeof(float2) + 3 * QCAP * sizeof(int) + 4 * size_t(N) * sizeof(float) +
         2 * size_t(M) * sizeof(int);
}

// The operand array: rho's coefficients, z2r's, then cutoff, r_lo, r_hi,
// mid and half.
constexpr int N_OPERAND = 2 * NC + 5;
__constant__ float c_op[N_OPERAND];
__device__ __forceinline__ float cr(int k) { return c_op[k]; }
__device__ __forceinline__ float cz(int k) { return c_op[NC + k]; }
__device__ __forceinline__ float cutoff() { return c_op[2 * NC]; }
__device__ __forceinline__ float r_lo() { return c_op[2 * NC + 1]; }
__device__ __forceinline__ float r_hi() { return c_op[2 * NC + 2]; }
__device__ __forceinline__ float mid() { return c_op[2 * NC + 3]; }
__device__ __forceinline__ float half() { return c_op[2 * NC + 4]; }

// rho and ep terms of a live pair at distance r.
__device__ __forceinline__ float2 pair_terms(float r) {
  const float u = (fminf(fmaxf(r, r_lo()), r_hi()) - mid()) / half();
  const float two_u = 2.f * u;
  float b1r = 0.f, b2r = 0.f, b1z = 0.f, b2z = 0.f;
#pragma unroll
  for (int k = NC - 1; k > 0; --k) {
    const float tr = cr(k) + two_u * b1r - b2r;
    const float tz = cz(k) + two_u * b1z - b2z;
    b2r = b1r;
    b1r = tr;
    b2z = b1z;
    b1z = tz;
  }
  const float q = 8.f * fmaxf(r_lo() - r, 0.f);
  const float q2 = q * q;
  const float w = 100.f * (q2 + q2 * q2);
  return make_float2((cr(0) + u * b1r - b2r) + w, ((cz(0) + u * b1z - b2z) + w) / r);
}

// A warp's ring and queue, and its place in them: entries [0, tail) were
// appended, [0, done) evaluated; centres [qh, qt) of the queue wait for
// their sums. All warp-uniform.
struct Warp {
  float2* ring;
  int mask;              // ring entries - 1
  int *q_i, *q_start, *q_end;
  int tail, done, qh, qt;
};

// Evaluate entries [done, done + n) of the ring, a pair a lane.
__device__ __forceinline__ void evaluate(Warp& w, int n) {
  const int lane = threadIdx.x & 31;
  if (lane < n) {
    float2* e = w.ring + ((w.done + lane) & w.mask);
    *e = pair_terms(e->x);
  }
  __syncwarp();
  w.done += n;
}

// Sum every pending centre (a (chain, centre) row) whose terms are all
// evaluated, oldest first.
__device__ __forceinline__ void retire(Warp& w, float* __restrict__ rho_out,
                                       float* __restrict__ ep_out) {
  const int lane = threadIdx.x & 31;
  while (w.qh < w.qt) {
    const int slot = w.qh % QCAP;
    const int end = w.q_end[slot];
    if (end > w.done) break;
    float sr = 0.f, se = 0.f;
    for (int k = w.q_start[slot] + lane; k < end; k += 32) {
      const float2 v = w.ring[k & w.mask];
      sr += v.x;
      se += v.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sr += __shfl_xor_sync(FULL, sr, off);
      se += __shfl_xor_sync(FULL, se, off);
    }
    if (lane == 0) {
      rho_out[w.q_i[slot]] = sr;
      ep_out[w.q_i[slot]] = 0.5f * se;
    }
    ++w.qh;
  }
  __syncwarp();
}

// Block b takes chains b cpb .. (b + 1) cpb - 1, warp w chains w, w +
// n_warps, ...
__global__ void __launch_bounds__(NWARP * 32)
rho_ep_kernel(const float* __restrict__ pos, const float* __restrict__ alive,
              const int* __restrict__ kernel_j, const float* __restrict__ shift,
              float* __restrict__ rho_out, float* __restrict__ ep_out, int C, int N, int M,
              int cpb, int cap) {
  extern __shared__ __align__(16) float smem[];
  const int n_warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  char* mine = reinterpret_cast<char*>(smem) + warp * warp_smem_bytes(cap, N, M);
  Warp w;
  w.ring = reinterpret_cast<float2*>(mine);
  w.mask = cap - 1;
  w.q_i = reinterpret_cast<int*>(w.ring + cap);
  w.q_start = w.q_i + QCAP;
  w.q_end = w.q_start + QCAP;
  float* s_x = reinterpret_cast<float*>(w.q_end + QCAP);
  float* s_y = s_x + N;
  float* s_z = s_y + N;
  float* s_a = s_z + N;
  int* s_m = reinterpret_cast<int*>(s_a + N);
  int* s_j = s_m + M;

  const int c_end = min(C, int(blockIdx.x + 1) * cpb);
  for (int c = int(blockIdx.x) * cpb + warp; c < c_end; c += n_warps) {
    const int row0 = c * N;
    // stage the chain; a dead centre's outputs are zeros
    for (int t = lane; t < N; t += 32) {
      const float a = __ldg(alive + row0 + t);
      s_x[t] = __ldg(pos + 3 * (row0 + t));
      s_y[t] = __ldg(pos + 3 * (row0 + t) + 1);
      s_z[t] = __ldg(pos + 3 * (row0 + t) + 2);
      s_a[t] = a;
      if (!(a > 0.f)) {
        rho_out[row0 + t] = 0.f;
        ep_out[row0 + t] = 0.f;
      }
    }
    __syncwarp();
    w.tail = w.done = w.qh = w.qt = 0;
    for (int i0 = 0; i0 < N; i0 += 32) {
      for (unsigned todo = __ballot_sync(FULL, i0 + lane < N && s_a[i0 + lane] > 0.f); todo;
           todo &= todo - 1) {
        const int i = i0 + __ffs(todo) - 1;
        const float a_i = s_a[i];
        // the candidates with a valid, alive neighbour, in slot order (U
        // chunks' table loads in flight together)
        int n_list = 0;
        for (int m0 = 0; m0 < M; m0 += 32 * U) {
          int j[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int m = m0 + 32 * u + lane;
            j[u] = m < M ? __ldg(kernel_j + i * M + m) : -1;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const bool keep = j[u] >= 0 && a_i + s_a[j[u]] > 1.5f;
            const unsigned bal = __ballot_sync(FULL, keep);
            if (keep) {
              const int k = n_list + __popc(bal & below);
              s_m[k] = m0 + 32 * u + lane;
              s_j[k] = j[u];
            }
            n_list += __popc(bal);
          }
        }
        __syncwarp();
        // their distances, 32 at a time; the live ones into the ring
        const float xi = s_x[i], yi = s_y[i], zi = s_z[i];
        const int start = w.tail;
        for (int k0 = 0; k0 < n_list; k0 += 32) {
          const int k = k0 + lane;
          bool live = false;
          float r = 0.f;
          if (k < n_list) {
            const int j = s_j[k], p = i * M + s_m[k];
            const float dx = xi - (s_x[j] + __ldg(shift + 3 * p));
            const float dy = yi - (s_y[j] + __ldg(shift + 3 * p + 1));
            const float dz = zi - (s_z[j] + __ldg(shift + 3 * p + 2));
            r = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f));
            live = r < cutoff();
          }
          const unsigned bal = __ballot_sync(FULL, live);
          if (live) w.ring[(w.tail + __popc(bal & below)) & w.mask].x = r;
          w.tail += __popc(bal);
          __syncwarp();
          while (w.tail - w.done >= 32) {
            evaluate(w, 32);
            retire(w, rho_out, ep_out);
          }
        }
        if (w.tail > start) {
          if (lane == 0) {
            const int slot = w.qt % QCAP;
            w.q_i[slot] = row0 + i;
            w.q_start[slot] = start;
            w.q_end[slot] = w.tail;
          }
          ++w.qt;
          __syncwarp();
        } else if (lane == 0) {   // an alive centre without live pairs
          rho_out[row0 + i] = 0.f;
          ep_out[row0 + i] = 0.f;
        }
      }
    }
    if (w.tail > w.done) evaluate(w, w.tail - w.done);
    retire(w, rho_out, ep_out);
  }
}

}  // namespace

// cpb: chains a block (its warps take one each in turn). Returns
// cudaGetLastError() of the launch; cudaErrorInvalidValue for shapes it
// does not take.
extern "C" int eam_rho_ep(const float* pos, const float* alive, const int* kernel_j,
                          const float* shift, const float* operand, float* rho, float* ep,
                          int C, int N, int M, int cpb, cudaStream_t stream) {
  if (C < 1 || N < 1 || M < 1 || cpb < 1 || (long long)N * M >= (1LL << 31) / 3 ||
      (long long)C * N >= (1LL << 31))
    return int(cudaErrorInvalidValue);
  const int cap = ring_entries(M);
  const size_t fit = MAX_SMEM / warp_smem_bytes(cap, N, M);
  const int n_warps = fit < size_t(NWARP) ? int(fit) : NWARP;
  if (n_warps < 1) return int(cudaErrorInvalidValue);
  const size_t smem = n_warps * warp_smem_bytes(cap, N, M);
  cudaError_t err = cudaFuncSetAttribute(
      rho_ep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  err = cudaMemcpyToSymbolAsync(c_op, operand, sizeof(float) * N_OPERAND, 0,
                                cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return int(err);
  const int blocks = (C + cpb - 1) / cpb;
  rho_ep_kernel<<<blocks, n_warps * 32, smem, stream>>>(pos, alive, kernel_j, shift, rho, ep, C,
                                                        N, M, cpb, cap);
  return int(cudaGetLastError());
}
