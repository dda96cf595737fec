// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_attention
// (src/repro/kernels/paged_attention/paged_attention.py:71, _paged_kernel
// :25-68): q (B, H, D) attends over KV pages (NP, PS, Hk, D) that a
// (B, MAXP) int32 page table names, position p of request b live when
// p < seq_lens[b]; fp32 running max / denominator / accumulator carried
// across the cache; output in q's dtype.
//
// One CTA of 128 threads per (kv head, request). It holds the rep = H / Hk
// query heads of its GQA group (pre-scaled by 1/sqrt(D)) in shared memory
// and walks its own row of the page table in chunks of 32 positions: the
// chunk's K and V rows are gathered from their pages into shared memory
// (fp32), one warp per query head scores the 32 positions (one lane per
// position), updates the head's running max and denominator and writes the
// weights, then all threads fold the weighted V rows into the fp32
// accumulator. The TPU grid steps over every page in order; here the loop
// inside the CTA plays that role, and the chunking does not follow page
// boundaries, so the arithmetic is the same for any page size.
//
// Positions at or past seq_len weigh exp(-1e30 - m) = 0 once a live score
// set the running max m (position 0 is live whenever seq_len > 0), so the
// CTA stops at min(seq_len, MAXP * PS). With seq_len <= 0 every score is
// -1e30 and the reference attends uniformly over all MAXP * PS positions;
// the CTA then walks all of them, which gives the same result.
//
// What bounds it on this card: bytes. Each live position costs 2 * D
// elements of K and V read once, against 4 * rep * D flops, far below the
// 295 flops per byte at which the tensor cores would bound it. The host
// checks that every table entry lies in [0, NP), so no gather leaves the
// page pool. One CTA per (request, kv head) leaves most SMs idle at small
// batch; splitting the sequence across CTAs is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;        // positions per step: one per lane
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f; // the reference's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr size_t smem_floats(int rep, int D) {
  // q, K (padded by one column), V, weights, accumulator, m, l, corr.
  return static_cast<size_t>(rep) * D + kChunk * (D + 1) + kChunk * D +
         static_cast<size_t>(rep) * kChunk + static_cast<size_t>(rep) * D +
         3 * static_cast<size_t>(rep);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int32_t* __restrict__ table,
             const int32_t* __restrict__ seq_lens, T* __restrict__ out, int H,
             int Hk, int PS, int maxp, float sm_scale) {
  extern __shared__ float smem[];
  const int rep = H / Hk;
  float* qs = smem;                        // [rep][D]
  float* ks = qs + rep * D;                // [kChunk][D + 1]
  float* vs = ks + kChunk * (D + 1);       // [kChunk][D]
  float* ps = vs + kChunk * D;             // [rep][kChunk]
  float* acc = ps + rep * kChunk;          // [rep][D]
  float* ms = acc + rep * D;               // [rep]
  float* ls = ms + rep;                    // [rep]
  float* corr = ls + rep;                  // [rep]

  const int g = blockIdx.x;                // kv head
  const int b = blockIdx.y;                // request
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const T* qb = q + (static_cast<int64_t>(b) * H + g * rep) * D;
  const int32_t* row = table + static_cast<int64_t>(b) * maxp;

  for (int idx = tid; idx < rep * D; idx += kThreads) {
    qs[idx] = to_f(qb[idx]) * sm_scale;
    acc[idx] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }

  const int total = maxp * PS;
  const int sl = seq_lens[b];
  const int n_pos = sl > 0 ? min(sl, total) : total;

  for (int t0 = 0; t0 < n_pos; t0 += kChunk) {
    const int n = min(kChunk, n_pos - t0);
    __syncthreads();   // the previous chunk's K, V and weights are consumed
    for (int idx = tid; idx < n * D; idx += kThreads) {
      const int j = idx / D, c = idx % D;
      const int t = t0 + j;
      const int64_t page = row[t / PS];
      const int64_t base = ((page * PS + t % PS) * Hk + g) * D;
      ks[j * (D + 1) + c] = to_f(kp[base + c]);
      vs[j * D + c] = to_f(vp[base + c]);
    }
    __syncthreads();

    for (int r = warp; r < rep; r += kWarps) {
      float s = kNegInf;
      if (lane < n) {
        const float* qr = qs + r * D;
        const float* kr = ks + lane * (D + 1);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = t0 + lane < sl ? dot : kNegInf;
      }
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = lane < n ? expf(s - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      ps[r * kChunk + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr[r] = c;
        ls[r] = ls[r] * c + psum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < rep * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      float a = acc[idx] * corr[r];
      const float* pr = ps + r * kChunk;
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], vs[j * D + c], a);
      acc[idx] = a;
    }
  }
  __syncthreads();

  T* ob = out + (static_cast<int64_t>(b) * H + g * rep) * D;
  for (int idx = tid; idx < rep * D; idx += kThreads)
    ob[idx] = from_f<T>(acc[idx] / fmaxf(ls[idx / D], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp,
           const int32_t* table, const int32_t* seq_lens, void* out, int B,
           int H, int Hk, int PS, int maxp, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(H / Hk, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hk, B);
  paged_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, seq_lens, static_cast<T*>(out), H,
      Hk, PS, maxp, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* kp, const void* vp,
             const int32_t* table, const int32_t* seq_lens, void* out, int B,
             int H, int Hk, int PS, int maxp, float sm_scale,
             cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, kp, vp, table, seq_lens, out, B, H, Hk, PS, maxp, sm_scale, s);
    case 64: return launch<T, 64>(q, kp, vp, table, seq_lens, out, B, H, Hk, PS, maxp, sm_scale, s);
    case 128: return launch<T, 128>(q, kp, vp, table, seq_lens, out, B, H, Hk, PS, maxp, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one CTA needs for a GQA group of `rep` heads.
int64_t paged_smem_bytes(int rep, int D) {
  return static_cast<int64_t>(sizeof(float) * smem_floats(rep, D));
}

// Launch the decode kernel on `stream`; dtype 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() (0 = ok).
int paged_launch(const void* q, const void* kp, const void* vp,
                 const int32_t* table, const int32_t* seq_lens, void* out,
                 int dtype, int B, int H, int Hk, int PS, int maxp, int D,
                 float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, kp, vp, table, seq_lens, out, B, H, Hk, PS,
                           maxp, sm_scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, kp, vp, table, seq_lens, out, B, H,
                                   Hk, PS, maxp, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
