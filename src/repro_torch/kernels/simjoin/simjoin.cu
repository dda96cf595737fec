// Blocked L1 similarity-join kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of repro/kernels/simjoin/simjoin.py:
//   * simjoin_dense_kernel  <- simjoin_block_counts        (simjoin.py:73)
//   * simjoin_pruned_kernel <- simjoin_pruned_block_counts (simjoin.py:108)
//
// Both count, per 128x128 block pair of two coordinate-major int32 sets
// (a: (k, d, Na), b: (k, d, Nb), padded with +2^20 / -2^20 sentinels so pad
// cells never match), the cell pairs with sum_k |a_ki - b_kj| <= eps; in
// self-join mode only global i < j counts. The pruned kernel walks a
// host-built (k, P, 3) list of (block_i, block_j, valid) rows instead of
// the full grid; a row with valid == 0 writes 0 and loads no tile (the TPU
// kernel loads arbitrary blocks there and multiplies the count away).
//
// What bounds it: integer ALU work. Each cell pair costs 3d + 1 int32
// operations (subtract, absolute value, add per dimension, then the
// compare; the self-join mask adds one more) against 2 * d * 128 * 4 bytes
// of input per block pair, so every tile is reused 128 times from shared
// memory and device memory is far from the limit. The design keeps each thread's
// a-cell in registers and streams b-cells from shared memory as warp-wide
// broadcasts (all 32 lanes of a warp read the same b-cell), so the inner
// loop is ALU-only. No tensor-core path exists for |a - b|. Speed work
// (several block pairs per CTA, packed 16-bit differences) is left for
// later; this version is written to be plainly right.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;          // cells per block (the TPU kernel's BLOCK)
constexpr int kThreads = 256;        // two threads per a-row of the block
constexpr int kColsPerThread = kBlock * kBlock / kThreads;   // 64
constexpr int kWarps = kThreads / 32;

// One block pair's match count, valid in thread 0 on return. a and b point
// at the task's (d, n) coordinate-major sets; bi / bj select the blocks.
template <int D>
__device__ int block_pair_count(const int32_t* __restrict__ a, int64_t na,
                                const int32_t* __restrict__ b, int64_t nb,
                                int64_t bi, int64_t bj, int eps, int same) {
  __shared__ int32_t sa[D][kBlock];
  __shared__ int32_t sb[D][kBlock];
  __shared__ int warp_sums[kWarps];
  const int tid = threadIdx.x;
  for (int idx = tid; idx < D * kBlock; idx += kThreads) {
    const int k = idx / kBlock;
    const int c = idx % kBlock;
    sa[k][c] = a[k * na + bi * kBlock + c];
    sb[k][c] = b[k * nb + bj * kBlock + c];
  }
  __syncthreads();

  const int r = tid % kBlock;                  // this thread's a-cell
  const int c0 = (tid / kBlock) * kColsPerThread;
  int32_t ar[D];
#pragma unroll
  for (int k = 0; k < D; ++k) ar[k] = sa[k][r];
  const int64_t gi = bi * kBlock + r;
  const int64_t gj0 = bj * kBlock + c0;
  int count = 0;
#pragma unroll 8
  for (int c = 0; c < kColsPerThread; ++c) {
    int32_t dist = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) dist += abs(ar[k] - sb[k][c0 + c]);
    bool hit = dist <= eps;
    if (same) hit = hit && (gi < gj0 + c);
    count += hit ? 1 : 0;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = count;
  __syncthreads();
  int total = 0;
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  }
  return total;
}

// Grid (Nb/128, Na/128, k): one CTA per block pair of each task.
// out: (k, Na/128, Nb/128) int32.
template <int D>
__global__ void __launch_bounds__(kThreads)
simjoin_dense_kernel(const int32_t* __restrict__ a,
                     const int32_t* __restrict__ b, int32_t* __restrict__ out,
                     int64_t na, int64_t nb, int eps, int same) {
  const int64_t bj = blockIdx.x;
  const int64_t bi = blockIdx.y;
  const int64_t t = blockIdx.z;
  const int cnt = block_pair_count<D>(a + t * D * na, na, b + t * D * nb, nb,
                                      bi, bj, eps, same);
  if (threadIdx.x == 0)
    out[(t * gridDim.y + bi) * gridDim.x + bj] = cnt;
}

// Grid (P, k): one CTA per row of each task's (P, 3) pair list.
// out: (k, P) int32, count * valid (0 for pad rows).
template <int D>
__global__ void __launch_bounds__(kThreads)
simjoin_pruned_kernel(const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b,
                      const int32_t* __restrict__ pairs,
                      int32_t* __restrict__ out, int64_t na, int64_t nb,
                      int64_t n_pairs, int eps, int same) {
  const int64_t p = blockIdx.x;
  const int64_t t = blockIdx.y;
  const int32_t* row = pairs + (t * n_pairs + p) * 3;
  const int valid = row[2];
  if (valid == 0) {                  // uniform across the CTA: no barrier hit
    if (threadIdx.x == 0) out[t * n_pairs + p] = 0;
    return;
  }
  const int cnt = block_pair_count<D>(a + t * D * na, na, b + t * D * nb, nb,
                                      row[0], row[1], eps, same);
  if (threadIdx.x == 0) out[t * n_pairs + p] = cnt * valid;
}

}  // namespace

extern "C" {

const char* simjoin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch the dense grid on `stream`; returns cudaGetLastError() (0 = ok).
int simjoin_dense_launch(const int32_t* a, const int32_t* b, int32_t* out,
                         int64_t k, int64_t d, int64_t na, int64_t nb,
                         int eps, int same, void* stream) {
  const dim3 grid(static_cast<unsigned>(nb / kBlock),
                  static_cast<unsigned>(na / kBlock),
                  static_cast<unsigned>(k));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: simjoin_dense_kernel<1><<<grid, kThreads, 0, s>>>(a, b, out, na, nb, eps, same); break;
    case 2: simjoin_dense_kernel<2><<<grid, kThreads, 0, s>>>(a, b, out, na, nb, eps, same); break;
    case 3: simjoin_dense_kernel<3><<<grid, kThreads, 0, s>>>(a, b, out, na, nb, eps, same); break;
    case 4: simjoin_dense_kernel<4><<<grid, kThreads, 0, s>>>(a, b, out, na, nb, eps, same); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the pair-list grid on `stream`; returns cudaGetLastError().
int simjoin_pruned_launch(const int32_t* a, const int32_t* b,
                          const int32_t* pairs, int32_t* out, int64_t k,
                          int64_t d, int64_t na, int64_t nb, int64_t n_pairs,
                          int eps, int same, void* stream) {
  const dim3 grid(static_cast<unsigned>(n_pairs), static_cast<unsigned>(k));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: simjoin_pruned_kernel<1><<<grid, kThreads, 0, s>>>(a, b, pairs, out, na, nb, n_pairs, eps, same); break;
    case 2: simjoin_pruned_kernel<2><<<grid, kThreads, 0, s>>>(a, b, pairs, out, na, nb, n_pairs, eps, same); break;
    case 3: simjoin_pruned_kernel<3><<<grid, kThreads, 0, s>>>(a, b, pairs, out, na, nb, n_pairs, eps, same); break;
    case 4: simjoin_pruned_kernel<4><<<grid, kThreads, 0, s>>>(a, b, pairs, out, na, nb, n_pairs, eps, same); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
