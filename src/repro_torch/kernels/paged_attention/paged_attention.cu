// Paged single-token decode attention for Hopper (sm_90a), split along the
// sequence (flash-decoding) and combined inside the same launch.
//
// Replaces the Pallas TPU kernel paged_attention
// (src/repro/kernels/paged_attention/paged_attention.py:71, _paged_kernel
// :25-68): q (B, H, D) attends over KV pages (NP, PS, Hk, D) that a
// (B, MAXP) int32 page table names, position p of request b live when
// p < seq_lens[b]; fp32 running max / denominator / accumulator carried
// across the cache; output in q's dtype.
//
// One thread-block cluster of n_split CTAs (at most 8, the portable size)
// per (request, kv head, chunk of at most R query heads of its GQA group).
// The n_pos positions a request visits are cut into n_eff = min(n_split,
// ceil(n_pos / min_len)) contiguous ranges of ceil(n_pos / n_eff); CTA s of
// the cluster takes range s (ranges past n_eff are empty). Inside a CTA of
// 128 threads, a group of kL lanes shares one position: each lane loads
// its 16-byte slices of the K and V rows that the page table names (every
// row read once for all the CTA's query heads), the lanes
// reduce the dot products with shuffles, and every group of lanes keeps
// its own fp32 (m, l, acc) per query head with an online softmax over its
// positions, several rows' loads in flight at once. The groups merge by
// shuffles, the warps through shared memory, and the CTAs of the cluster
// through distributed shared memory: after a cluster barrier, CTA s
// combines a slice of the outputs from every CTA's partial in rank order,
// so the result does not depend on scheduling, and no float atomics are
// used. A second cluster barrier keeps every partial alive until read.
//
// Positions at or past seq_len are never visited: they would weigh
// exp(-1e30 - m) = 0 once a live score set the running max m. With
// seq_len <= 0 every score is -1e30 and the reference attends uniformly
// over all MAXP * PS positions; the kernel then visits all of them with
// score -1e30, which gives the same result.
//
// What bounds it on this card: bytes. Each live position costs 2 * D
// elements of K and V read once, against 4 * rep * D flops, far below the
// 295 flops per byte at which the tensor cores would bound it; at decode
// sizes the launch and one trip to HBM set the floor, so the design aims
// at filling the SMs (the host picks n_split from B * Hk) with many loads
// in flight. The host checks that every table entry lies in [0, NP), so no
// gather leaves the page pool.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_dims.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

// 16 bytes of T from global memory, as floats into f[0 ..].
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// How the lanes of a warp cover a head row of D elements of T: kV
// vectors of 16 bytes a lane, kL lanes a position (a power of two, so the
// positions of a warp step tile its 32 lanes). D = 16 is 2 vectors in
// bf16 and 4 in fp32, so 16 or 8 positions share a warp step. A row of
// kVec vectors that kL lanes do not split evenly (D = 80 and 192 in
// bf16: 10 and 24 vectors over 16 and 32 lanes; D = 80 in fp32: 20 over
// 32; likewise 48, 96, 112, 144, 160, 176) leaves the last lanes'
// vectors past the row: they load nothing, hold zeros and store nothing.
// fp32 above D = 128 (36 to 48 vectors) takes two a lane.
template <typename T, int D>
struct Lanes {
  static constexpr int kE = 16 / sizeof(T);   // elements per vector
  static constexpr int kVec = D / kE;         // vectors per row
  static constexpr int kV = (kVec + 31) / 32; // vectors per lane
  static constexpr int kNeed = (kVec + kV - 1) / kV;
  static constexpr int kL = kNeed <= 1 ? 1 : kNeed <= 2 ? 2 : kNeed <= 4 ? 4
                            : kNeed <= 8 ? 8 : kNeed <= 16 ? 16 : 32;
  static constexpr int kEL = kV * kE;         // elements per lane
  static_assert(D % kE == 0 && kVec <= 32 * kV, "head dim");
};

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp,
                   const int32_t* __restrict__ table,
                   const int32_t* __restrict__ seq_lens, T* __restrict__ out,
                   int H, int Hk, int PS, int maxp, int n_chunks, int min_len,
                   float sm_scale) {
  using LN = Lanes<T, D>;
  constexpr int kE = LN::kE;           // elements per vector
  constexpr int kV = LN::kV;           // vectors per lane
  constexpr int kL = LN::kL;           // lanes per position
  constexpr int kEL = LN::kEL;         // elements per lane
  constexpr int kP = 32 / kL;          // positions per warp step
  constexpr int kU = R >= 8 ? 2 : 4;   // steps whose loads are in flight
  __shared__ float w_acc[kWarps][R][D];
  __shared__ float w_m[kWarps][R], w_l[kWarps][R];
  __shared__ float c_acc[R][D];   // this CTA's partial, read by the cluster
  __shared__ float c_m[R], c_l[R];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n_split = gridDim.x;
  const int g = blockIdx.y / n_chunks;          // kv head
  const int b = blockIdx.z;                     // request
  const int rep = H / Hk;
  const int h0 = g * rep + (blockIdx.y % n_chunks) * R;
  const int nr = min(R, g * rep + rep - h0);    // query heads of this CTA
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane / kL, sub = lane % kL;
  // Vector v of this lane is vector sub + kL v of the row (its elements
  // kE (sub + kL v) ..), and lies in the row when below kVec.
  bool vin[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) vin[v] = sub + kL * v < LN::kVec;

  float qr[R][kEL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      float* x = &qr[r][v * kE];
      if (r < nr && vin[v]) {
        load16(q + (static_cast<int64_t>(b) * H + h0 + r) * D +
                   (sub + kL * v) * kE, x);
#pragma unroll
        for (int e = 0; e < kE; ++e) x[e] *= sm_scale;
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) x[e] = 0.f;
      }
    }

  const int total = maxp * PS;
  const int sl = seq_lens[b];
  const bool live = sl > 0;
  const int n_pos = live ? min(sl, total) : total;
  const int n_eff = min(n_split, (n_pos + min_len - 1) / min_len);
  const int len = (n_pos + n_eff - 1) / n_eff;
  const int p_begin = split * len;
  const int p_end = min(n_pos, p_begin + len);

  float m[R], l[R], acc[R][kEL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kEL; ++e) acc[r][e] = 0.f;
  }
  const int32_t* row = table + static_cast<int64_t>(b) * maxp;
  constexpr int kStep = kWarps * kP;
  // The loop bound is uniform in the warp, so every lane takes part in
  // the shuffles; a lane past p_end loads nothing and updates nothing.
  for (int p0 = p_begin + warp * kP; p0 < p_end; p0 += kU * kStep) {
    float kf[kU][kEL], vf[kU][kEL];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int p = p0 + u * kStep + slot;
      const int64_t page = p < p_end ? row[p / PS] : 0;
      const int64_t off = ((page * PS + p % PS) * Hk + g) * D;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        float* kx = &kf[u][v * kE];
        float* vx = &vf[u][v * kE];
        if (p < p_end && vin[v]) {
          const int64_t at = off + (sub + kL * v) * kE;
          load16(kp + at, kx);
          load16(vp + at, vx);
        } else {
#pragma unroll
          for (int e = 0; e < kE; ++e) kx[e] = vx[e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const bool in = p0 + u * kStep + slot < p_end;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nr) continue;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kEL; ++e) dot = fmaf(qr[r][e], kf[u][e], dot);
#pragma unroll
        for (int o = kL / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (!in) continue;
        const float s = live ? dot : kNegInf;
        const float mn = fmaxf(m[r], s);
        const float c = expf(m[r] - mn), pw = expf(s - mn);
        l[r] = l[r] * c + pw;
        m[r] = mn;
#pragma unroll
        for (int e = 0; e < kEL; ++e)
          acc[r][e] = fmaf(pw, vf[u][e], acc[r][e] * c);
      }
    }
  }

  // Merge the lane groups of the warp (a butterfly: every group ends with
  // the same sums), then the warps in shared memory, in a fixed order.
#pragma unroll
  for (int o = kL; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], m2);
      const float c1 = expf(m[r] - mn), c2 = expf(m2 - mn);
#pragma unroll
      for (int e = 0; e < kEL; ++e) {
        const float a2 = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = acc[r][e] * c1 + a2 * c2;
      }
      l[r] = l[r] * c1 + l2 * c2;
      m[r] = mn;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int v = 0; v < kV; ++v)
        if (vin[v])
#pragma unroll
          for (int e = 0; e < kE; ++e)
            w_acc[warp][r][(sub + kL * v) * kE + e] = acc[r][v * kE + e];
      if (sub == 0) {
        w_m[warp][r] = m[r];
        w_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float mm = w_m[0][r], ll = w_l[0][r], a = w_acc[0][r][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float mn = fmaxf(mm, w_m[w][r]);
      const float c1 = expf(mm - mn), c2 = expf(w_m[w][r] - mn);
      a = a * c1 + w_acc[w][r][d] * c2;
      ll = ll * c1 + w_l[w][r] * c2;
      mm = mn;
    }
    c_acc[r][d] = a;
    if (d == 0) {
      c_m[r] = mm;
      c_l[r] = ll;
    }
  }

  // Combine the cluster's partials: CTA `split` writes outputs split,
  // split + n_split, ... (in units of kThreads), reading every CTA's
  // partial in rank order.
  cluster.sync();
  for (int idx = split * kThreads + threadIdx.x; idx < nr * D;
       idx += n_split * kThreads) {
    const int r = idx / D, d = idx % D;
    float mm = kNegInf, ll = 0.f, a = 0.f;
    for (int c = 0; c < n_split; ++c) {
      const float* rm = cluster.map_shared_rank(&c_m[0], c);
      const float* rl = cluster.map_shared_rank(&c_l[0], c);
      const float* ra = cluster.map_shared_rank(&c_acc[0][0], c);
      const float m2 = rm[r];
      const float mn = fmaxf(mm, m2);
      const float c1 = expf(mm - mn), c2 = expf(m2 - mn);
      a = a * c1 + ra[r * D + d] * c2;
      ll = ll * c1 + rl[r] * c2;
      mm = mn;
    }
    store(out + (static_cast<int64_t>(b) * H + h0 + r) * D + d,
          a / fmaxf(ll, 1e-30f));
  }
  cluster.sync();   // no CTA leaves while another may read its partial
}

template <typename T, int D, int R>
int launch(const void* q, const void* kp, const void* vp,
           const int32_t* table, const int32_t* seq_lens, void* out, int B,
           int H, int Hk, int PS, int maxp, int n_split, int min_len,
           float sm_scale, cudaStream_t stream) {
  const int rep = H / Hk;
  const int n_chunks = (rep + R - 1) / R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hk * n_chunks, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_split_kernel<T, D, R>, static_cast<const T*>(q),
      static_cast<const T*>(kp), static_cast<const T*>(vp), table, seq_lens,
      static_cast<T*>(out), H, Hk, PS, maxp, n_chunks, min_len, sm_scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Query heads per CTA for a GQA group of `rep`: 1, 2, 4 or 8 (larger
// groups take several CTAs of 8).
inline int heads_per_cta(int rep) {
  return rep <= 1 ? 1 : rep <= 2 ? 2 : rep <= 4 ? 4 : 8;
}

template <typename T, int D>
int launch_r(const void* q, const void* kp, const void* vp,
             const int32_t* table, const int32_t* seq_lens, void* out, int B,
             int H, int Hk, int PS, int maxp, int n_split, int min_len,
             float sm_scale, cudaStream_t s) {
#define REPRO_PAGED_ARGS q, kp, vp, table, seq_lens, out, B, H, Hk, PS, maxp, n_split, min_len, sm_scale, s
  switch (heads_per_cta(H / Hk)) {
    case 1: return launch<T, D, 1>(REPRO_PAGED_ARGS);
    case 2: return launch<T, D, 2>(REPRO_PAGED_ARGS);
    case 4: return launch<T, D, 4>(REPRO_PAGED_ARGS);
    default: return launch<T, D, 8>(REPRO_PAGED_ARGS);
  }
}

template <typename T>
int launch_d(int D, const void* q, const void* kp, const void* vp,
             const int32_t* table, const int32_t* seq_lens, void* out, int B,
             int H, int Hk, int PS, int maxp, int n_split, int min_len,
             float sm_scale, cudaStream_t s) {
  switch (D) {
#define REPRO_ARM(d) case d: return launch_r<T, d>(REPRO_PAGED_ARGS);
    REPRO_HEAD_DIMS(REPRO_ARM)
#undef REPRO_ARM
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_PAGED_ARGS
}

}  // namespace

extern "C" {

const char* paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch the decode kernel on `stream`; dtype 0 = float32, 1 = bfloat16.
// n_split CTAs (1..8, one cluster) per (request, kv head, head chunk);
// each request's positions go to min(n_split, ceil(n_pos / min_len)) of
// them. Returns cudaGetLastError() (0 = ok).
int paged_launch(const void* q, const void* kp, const void* vp,
                 const int32_t* table, const int32_t* seq_lens, void* out,
                 int dtype, int B, int H, int Hk, int PS, int maxp, int D,
                 float sm_scale, int n_split, int min_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || n_split > kMaxSplits || min_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_d<float>(D, q, kp, vp, table, seq_lens, out, B, H, Hk, PS,
                           maxp, n_split, min_len, sm_scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, kp, vp, table, seq_lens, out, B, H,
                                   Hk, PS, maxp, n_split, min_len, sm_scale,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
