// AdamW with global-norm clipping as one pass over each parameter, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's adamw_update
// (src/repro/train/optimizer.py) is plain JAX, which XLA fuses into a few
// passes on the TPU. Eager PyTorch runs each of its elementwise ops as a
// pass of its own (about 25 a leaf in fp32, plus three for the norm), so
// this source does the fusion by hand.
//
// What bounds it on this card: bytes. A parameter costs about 16 flops
// against 24 bytes moved (bf16 p and g, fp32 m and v: g read for the norm,
// then p, g, m, v read and p, m, v written), far below the point where
// arithmetic would limit it, so the design moves each byte once, in
// 16-byte vectors, with streaming loads and stores (__ldcs / __stcs: no
// byte is read twice in a pass, so none is worth keeping in L2).
//
// Four kernels, each over a batch of at most kMaxLeaves leaves whose
// table (pointers, element counts, decay flags) travels in the kernel's
// parameters, so no table is copied to the device:
//   * adamw_sumsq_kernel<G>: each leaf is cut into chunks of kChunk
//     elements; a block takes chunks in a grid-stride loop and writes each
//     chunk's fp32 sum of squares to its slot of a partials buffer (a
//     chunk's sum does not depend on which block took it, and no atomics
//     are used, so the bits repeat from run to run);
//   * adamw_leaf_sums_kernel: one block a leaf sums that leaf's partials in
//     a fixed order (in double) into its slot of the per-leaf sums;
//   * adamw_finalize_kernel: one thread sums the per-leaf sums in leaf
//     order and writes the step count, the learning rate, the norm, the
//     clip scale and the two bias corrections, each with the fp32 ops (in
//     their order) that the plain version's 0-dim PyTorch ops use. Nothing
//     is read back to the host;
//   * adamw_update_kernel<P, G, M>: the chunks again, each element updated
//     in fp32 registers in the plain loop's order of operations, with
//     explicitly rounded intrinsics so nvcc fuses no multiply-add that the
//     plain version rounds twice; p is stored in its own dtype and m, v in
//     theirs, rounded to nearest even as Tensor.copy_ rounds. A leaf whose
//     pointers are not all 16-byte aligned, and the ragged tail of the
//     others, take the same arithmetic one element at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLeaves = 64;     // leaves a launch takes (parameters < 4 KB)
constexpr int kThreads = 256;
constexpr int kVec = 8;            // elements per vector step
constexpr int64_t kChunk = 32768;  // elements per chunk, a multiple of kVec

// One batch of leaves. chunk0[i] is leaf i's first chunk; chunk0[count]
// the batch's number of chunks. slot[i] is leaf i's index in the tree.
struct Leaves {
  const void* g[kMaxLeaves];
  void* p[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int chunk0[kMaxLeaves + 1];
  int slot[kMaxLeaves];
  unsigned long long decay;        // bit i: leaf i is decayed
  int count;
};

// The constants of the update, as the plain loop's Python scalars round
// to fp32: b1, 1 - b1, b2, 1 - b2, eps, weight decay.
struct Coef {
  float b1, omb1, b2, omb2, eps, wd;
};

// The learning-rate schedule and clipping, as fp32 (see finalize).
struct Schedule {
  float peak_lr, min_lr, half_range, pi, b1, b2, clip;
  int warmup, warmup_div, total_div;
};

__device__ __forceinline__ int find_leaf(const Leaves& L, int c) {
  int lo = 0, hi = L.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.chunk0[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

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

// 8 elements at p (16-byte aligned) into fp32, streaming.
__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[kVec]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    memcpy(&h, &w[i], sizeof(h));
    const float2 f = __bfloat1622float2(h);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1,
         make_float4(x[4], x[5], x[6], x[7]));
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    memcpy(&w[i], &h, sizeof(h));
  }
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// The elements [begin, end) of chunk c of leaf `leaf`: end - begin is
// kChunk but for a leaf's last chunk; the vector part ends at vend.
struct Span {
  int64_t begin, vend, end;
};
__device__ __forceinline__ Span chunk_span(const Leaves& L, int leaf, int c,
                                           bool vectors) {
  Span s;
  s.begin = static_cast<int64_t>(c - L.chunk0[leaf]) * kChunk;
  s.end = s.begin + kChunk < L.n[leaf] ? s.begin + kChunk : L.n[leaf];
  s.vend = vectors ? s.begin + (s.end - s.begin) / kVec * kVec : s.begin;
  return s;
}

// Sum over the block of one float per thread; thread 0 gets it. The tree
// is fixed, so the bits do not depend on timing.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) smem[warp] = x;
  __syncthreads();
  T total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += smem[w];
  __syncthreads();
  return total;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const Leaves L, float* __restrict__ partials) {
  __shared__ float smem[kThreads / 32];
  const int total = L.chunk0[L.count];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int leaf = find_leaf(L, c);
    const G* g = static_cast<const G*>(L.g[leaf]);
    const Span s = chunk_span(L, leaf, c, aligned16(g));
    float acc = 0.f;
    for (int64_t i = s.begin + threadIdx.x * kVec; i < s.vend;
         i += kThreads * kVec) {
      float x[kVec];
      load8(g + i, x);
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc = __fmaf_rn(x[k], x[k], acc);
    }
    for (int64_t i = s.vend + threadIdx.x; i < s.end; i += kThreads) {
      const float x = to_f(g[i]);
      acc = __fmaf_rn(x, x, acc);
    }
    const float sum = block_sum(acc, smem);
    if (threadIdx.x == 0) partials[c] = sum;
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_leaf_sums_kernel(const Leaves L, const float* __restrict__ partials,
                       float* __restrict__ sums) {
  __shared__ double smem[kThreads / 32];
  const int leaf = blockIdx.x;
  double acc = 0.0;
  for (int c = L.chunk0[leaf] + threadIdx.x; c < L.chunk0[leaf + 1];
       c += kThreads)
    acc += partials[c];
  const double sum = block_sum(acc, smem);
  if (threadIdx.x == 0) sums[L.slot[leaf]] = static_cast<float>(sum);
}

// count_out = count + 1; lr by the warmup + cosine schedule; the norm
// sqrt(sum of the per-leaf sums); scal = {clip scale, lr, 1 - b1^count,
// 1 - b2^count}. The fp32 ops mirror the plain version's 0-dim ops: a
// Python scalar enters as fp32, a division by a Python scalar is a
// product with its fp32 reciprocal (as PyTorch computes it), and
// `clip / x` is `reciprocal(x) * clip` (Tensor.__rtruediv__).
__global__ void adamw_finalize_kernel(const float* __restrict__ sumsq,
                                      int n_sums,
                                      const int32_t* __restrict__ count,
                                      int32_t* __restrict__ count_out,
                                      float* __restrict__ lr_out,
                                      float* __restrict__ gnorm_out,
                                      float* __restrict__ scal,
                                      const Schedule s) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  double acc = 0.0;
  for (int i = 0; i < n_sums; ++i) acc += sumsq[i];
  const float gnorm = __fsqrt_rn(static_cast<float>(acc));
  const int32_t c = count[0] + 1;
  const float step = static_cast<float>(c);
  const float warm = __fmul_rn(__fmul_rn(step, s.peak_lr),
                               __fdiv_rn(1.0f, static_cast<float>(
                                                   s.warmup_div)));
  float t = __fmul_rn(__fsub_rn(step, static_cast<float>(s.warmup)),
                      __fdiv_rn(1.0f, static_cast<float>(s.total_div)));
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float cosine = __fadd_rn(
      __fmul_rn(__fadd_rn(cosf(__fmul_rn(t, s.pi)), 1.0f), s.half_range),
      s.min_lr);
  const float lr = step < static_cast<float>(s.warmup) ? warm : cosine;
  const float scale = fminf(
      __fmul_rn(__fdiv_rn(1.0f, fmaxf(gnorm, 1e-12f)), s.clip), 1.0f);
  count_out[0] = c;
  lr_out[0] = lr;
  gnorm_out[0] = gnorm;
  scal[0] = scale;
  scal[1] = lr;
  scal[2] = __fsub_rn(1.0f, powf(s.b1, step));
  scal[3] = __fsub_rn(1.0f, powf(s.b2, step));
}

// One element, in the plain loop's order:
//   g32 = g * scale; m = m * b1 + (1 - b1) * g32;
//   v = v * b2 + (1 - b2) * g32^2;
//   step = (m / bc1) / (sqrt(v / bc2) + eps) [+ wd * p]; p = p - lr * step.
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m,
                                           float& v, bool decay, float scale,
                                           float lr, float bc1, float bc2,
                                           const Coef& k) {
  const float g32 = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(k.omb1, g32));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(k.omb2, __fmul_rn(g32, g32)));
  float step = __fdiv_rn(__fdiv_rn(m, bc1),
                         __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), k.eps));
  if (decay) step = __fadd_rn(step, __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, step));
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const Leaves L, const float* __restrict__ scal,
                    const Coef k) {
  const float scale = scal[0], lr = scal[1], bc1 = scal[2], bc2 = scal[3];
  const int total = L.chunk0[L.count];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int leaf = find_leaf(L, c);
    P* p = static_cast<P*>(L.p[leaf]);
    const G* g = static_cast<const G*>(L.g[leaf]);
    M* m = static_cast<M*>(L.m[leaf]);
    M* v = static_cast<M*>(L.v[leaf]);
    const bool decay = (L.decay >> leaf) & 1ull;
    const bool vectors =
        aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v);
    const Span s = chunk_span(L, leaf, c, vectors);
    for (int64_t i = s.begin + threadIdx.x * kVec; i < s.vend;
         i += kThreads * kVec) {
      float xp[kVec], xg[kVec], xm[kVec], xv[kVec];
      load8(p + i, xp);
      load8(g + i, xg);
      load8(m + i, xm);
      load8(v + i, xv);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        adamw_elem(xp[e], xg[e], xm[e], xv[e], decay, scale, lr, bc1, bc2, k);
      store8(p + i, xp);
      store8(m + i, xm);
      store8(v + i, xv);
    }
    for (int64_t i = s.vend + threadIdx.x; i < s.end; i += kThreads) {
      float xp = to_f(p[i]), xm = to_f(m[i]), xv = to_f(v[i]);
      adamw_elem(xp, to_f(g[i]), xm, xv, decay, scale, lr, bc1, bc2, k);
      p[i] = from_f<P>(xp);
      m[i] = from_f<M>(xm);
      v[i] = from_f<M>(xv);
    }
  }
}

// The batch of `n` leaves described by `table`, an (7, n) int64 array on
// the host: rows g, p, m, v (pointers), element counts, slots, decay flags.
int make_leaves(const int64_t* table, int n, Leaves* L) {
  if (n < 1 || n > kMaxLeaves) return -1;
  int64_t chunks = 0;
  L->count = n;
  L->decay = 0;
  for (int i = 0; i < n; ++i) {
    L->g[i] = reinterpret_cast<const void*>(table[i]);
    L->p[i] = reinterpret_cast<void*>(table[n + i]);
    L->m[i] = reinterpret_cast<void*>(table[2 * n + i]);
    L->v[i] = reinterpret_cast<void*>(table[3 * n + i]);
    L->n[i] = table[4 * n + i];
    L->slot[i] = static_cast<int>(table[5 * n + i]);
    if (table[6 * n + i]) L->decay |= 1ull << i;
    if (L->n[i] < 0) return -1;
    L->chunk0[i] = static_cast<int>(chunks);
    chunks += (L->n[i] + kChunk - 1) / kChunk;
    if (chunks >= (int64_t{1} << 31)) return -1;
  }
  L->chunk0[n] = static_cast<int>(chunks);
  return 0;
}

// Resident blocks of `kernel` on the current device, at most `work`.
template <typename K>
int grid_for(K kernel, int work) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                0);
  const int grid = sms * (per_sm > 0 ? per_sm : 1);
  return work < grid ? (work > 0 ? work : 1) : grid;
}

template <typename G>
int sumsq_launch(const Leaves& L, float* partials, float* sums,
                 cudaStream_t s) {
  const int total = L.chunk0[L.count];
  adamw_sumsq_kernel<G><<<grid_for(adamw_sumsq_kernel<G>, total), kThreads,
                          0, s>>>(L, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adamw_leaf_sums_kernel<<<L.count, kThreads, 0, s>>>(L, partials, sums);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G, typename M>
int update_launch(const Leaves& L, const float* scal, const Coef& k,
                  cudaStream_t s) {
  const int total = L.chunk0[L.count];
  adamw_update_kernel<P, G, M>
      <<<grid_for(adamw_update_kernel<P, G, M>, total), kThreads, 0, s>>>(
          L, scal, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G>
int update_m(int m_dtype, const Leaves& L, const float* scal, const Coef& k,
             cudaStream_t s) {
  if (m_dtype == 0) return update_launch<P, G, float>(L, scal, k, s);
  if (m_dtype == 1) return update_launch<P, G, __nv_bfloat16>(L, scal, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename P>
int update_g(int g_dtype, int m_dtype, const Leaves& L, const float* scal,
             const Coef& k, cudaStream_t s) {
  if (g_dtype == 0) return update_m<P, float>(m_dtype, L, scal, k, s);
  if (g_dtype == 1)
    return update_m<P, __nv_bfloat16>(m_dtype, L, scal, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[0] = leaves a launch takes, out[1] = elements a chunk holds.
int adamw_limits(int64_t* out) {
  out[0] = kMaxLeaves;
  out[1] = kChunk;
  return 0;
}

// Sums of squares of a batch of gradients (dtype 0 = float32, 1 =
// bfloat16; rows p, m, v of `table` unused): two launches, the chunk
// partials into `partials` (the batch's number of chunks of floats), then
// each leaf's sum into sums[slot]. Returns cudaGetLastError() (0 = ok).
int adamw_sumsq_launch(const int64_t* table, int n, int g_dtype,
                       float* partials, float* sums, void* stream) {
  Leaves L;
  if (make_leaves(table, n, &L) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0) return sumsq_launch<float>(L, partials, sums, s);
  if (g_dtype == 1) return sumsq_launch<__nv_bfloat16>(L, partials, sums, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One thread: the step count, learning rate, norm and the update's four
// scalars (see adamw_finalize_kernel) from the n_sums sums of squares.
int adamw_finalize_launch(const float* sumsq, int n_sums,
                          const int32_t* count, int32_t* count_out,
                          float* lr_out, float* gnorm_out, float* scal,
                          float peak_lr, float min_lr, float half_range,
                          float pi, float b1, float b2, float clip,
                          int warmup, int warmup_div, int total_div,
                          void* stream) {
  const Schedule sched{peak_lr, min_lr, half_range, pi, b1, b2, clip,
                       warmup, warmup_div, total_div};
  adamw_finalize_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      sumsq, n_sums, count, count_out, lr_out, gnorm_out, scal, sched);
  return static_cast<int>(cudaGetLastError());
}

// The update of a batch of leaves whose params, grads and moments have
// the dtypes p_dtype, g_dtype, m_dtype (0 = float32, 1 = bfloat16), with
// the scalars `scal` that adamw_finalize_launch wrote.
int adamw_update_launch(const int64_t* table, int n, int p_dtype,
                        int g_dtype, int m_dtype, const float* scal,
                        float b1, float omb1, float b2, float omb2, float eps,
                        float wd, void* stream) {
  Leaves L;
  if (make_leaves(table, n, &L) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Coef k{b1, omb1, b2, omb2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0) return update_g<float>(g_dtype, m_dtype, L, scal, k, s);
  if (p_dtype == 1)
    return update_g<__nv_bfloat16>(g_dtype, m_dtype, L, scal, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
