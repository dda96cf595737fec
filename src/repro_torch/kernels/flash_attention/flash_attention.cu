// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/flash_attention.py:61, _flash_kernel
// :22-58): q (B, H, Sq, D) against k, v (B, Hk, Sk, D) with H % Hk == 0
// (GQA: query head h reads kv head h / (H / Hk), never an expanded copy),
// online softmax over key tiles in fp32, causal mask on global indices
// with q_offset (query i sees keys j <= i + q_offset), output in q's dtype.
//
// One CTA of 256 threads per (query tile of 64 rows, head, batch). It
// stages its query tile (pre-scaled by 1/sqrt(D)) in shared memory once,
// then walks key tiles of 64 rows up to the causal live bound: the last
// key a live query row of the tile can see (the TPU kernel's nk_live skip).
// Per tile: S = Q K^T as a 16 x 16 thread grid of 4 x 4 micro-tiles, the
// masked running max / denominator update per row (16 lanes of a half warp
// share a row and reduce with shuffles), P written to shared memory, then
// O += P V with each thread owning 4 rows x D/16 columns of the fp32
// accumulator in registers. Row and column padding: query rows >= Sq load
// zeros and are not stored; key columns >= Sk score -1e30. Masked scores
// use the finite -1e30 of the reference, never -inf, so no NaN arises: key
// 0 is live for every row, so every row's running max is a real score
// after the first tile and masked entries weigh exp(-1e30 - m) = 0.
//
// What bounds it on this card: at the prefill shape (B 2, S 4096, H 24,
// D 128, causal) it does about 2.1e11 flops on 134 MB of input and output,
// so the tensor cores (989 TFLOP/s bf16) bound it, not HBM. This first
// version computes in fp32 on the CUDA cores (67 TFLOP/s) from shared
// memory, so it sits far above that bound; the tensor-core path (wgmma
// with K/V streamed by TMA) is later work. The result does not depend on
// the TPU kernel's bq / bk: this kernel tiles by its own 64 x 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBK = 64;           // key rows per tile
constexpr int kThreads = 256;     // a 16 x 16 grid of threads
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

template <int D>
constexpr size_t smem_bytes() {
  // Q and K padded by one column (conflict-free column reads), V, and P.
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Hk,
                 int Sq, int Sk, int causal, int q_offset, float sm_scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int kCols = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);        // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);        // [kBK][D]
  float* Ps = Vs + kBK * D;              // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // column lane: key column / output column
  const int ty = tid / 16;   // row lane: rows ty + 16 i, i < 4
  const T* qb = q + (static_cast<int64_t>(b) * H + h) * Sq * D;
  const T* kb = k + (static_cast<int64_t>(b) * Hk + hk) * Sk * D;
  const T* vb = v + (static_cast<int64_t>(b) * Hk + hk) * Sk * D;
  T* ob = o + (static_cast<int64_t>(b) * H + h) * Sq * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = q0 + r;
    Qs[r * (D + 1) + c] =
        gr < Sq ? to_f(qb[static_cast<int64_t>(gr) * D + c]) * sm_scale
                : 0.f;
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // Keys past the last one a stored row of this tile can see are masked
  // for every row: skip their tiles.
  int kv_end = Sk;
  if (causal) {
    const int last_q = min(q0 + kBQ, Sq) - 1 + q_offset;
    kv_end = min(Sk, last_q + 1);
  }
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int gk = k0 + r;
      const bool in = gk < Sk;
      const int64_t off = static_cast<int64_t>(gk) * D + c;
      Ks[r * (D + 1) + c] = in ? to_f(kb[off]) : 0.f;
      Vs[r * D + c] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = kj < Sk && (!causal || kj <= qi);
        if (!live) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * (kBK + 1) + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (kBK + 1) + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ob[static_cast<int64_t>(gr) * D + tx + 16 * c] =
          from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hk, int Sq, int Sk, int causal, int q_offset,
           float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hk, Sq, Sk, causal,
      q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int Hk, int Sq, int Sk, int causal, int q_offset,
             float sm_scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hk, Sq, Sk, causal, q_offset, sm_scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hk, Sq, Sk, causal, q_offset, sm_scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hk, Sq, Sk, causal, q_offset, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch the forward on `stream`; dtype 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() (0 = ok).
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     int dtype, int B, int H, int Hk, int Sq, int Sk, int D,
                     int causal, int q_offset, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, H, Hk, Sq, Sk, causal, q_offset,
                           sm_scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hk, Sq, Sk, causal,
                                   q_offset, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
