// Flash-attention backward for Hopper (sm_90a): a delta kernel and two
// gradient kernels a call, for float32 and bfloat16 inputs.
//
// The TPU side has no Pallas backward: the reference differentiates its
// blockwise attention through the custom VJP _blockwise_bwd
// (src/repro/models/attention.py:150), a scan over key blocks that
// recomputes each block's probabilities from the forward's (out, lse).
// These kernels compute the same gradients (the flash-attention-2
// backward) for q (B, H, Sq, D) against k, v (B, Hk, Sk, D) with
// H % Hk == 0 (GQA), causal on global indices with q_offset or not:
//
//   delta_i = sum_d dout_id out_id
//   p_ij    = exp(q_i . k_j / sqrt(D) - lse_i)      (0 where masked)
//   dp_ij   = dout_i . v_j
//   ds_ij   = p_ij (dp_ij - delta_i) / sqrt(D)
//   dv_j = sum_i p_ij dout_i,  dk_j = sum_i ds_ij q_i,  dq_i = sum_j ds_ij k_j
//
// with dk and dv summed over the H / Hk query heads of kv head j's group.
// Sums are fp32 and the gradients are stored in the inputs' dtype.
//
// What bounds it on this card: at the training shape (B 2, S 4096, H 24,
// Hk 8, D 128, causal) the backward needs 8 D flops per live (query, key)
// pair, about 4.1e11, on 0.27 GB of inputs and outputs: the tensor cores
// (989 TFLOP/s bf16), not HBM, bound it.
//
// Design. No float atomics, so a result is the same bit for bit from run
// to run (training resumes bit-exactly). Three kernels on one stream:
//   flash_bwd_delta_kernel: one warp per query row, delta_i in fp32.
//   dK/dV: one CTA per (key tile of 64, kv head, batch). K and V stay in
//     shared memory; the CTA walks every query head of its GQA group and
//     every query tile that sees one of its keys, recomputes S and dP,
//     and accumulates dK and dV in registers. Each kv head's dK and dV are
//     written once, directly: no expanded (B, S, H, D) buffer and no
//     reduction pass.
//   dQ: one CTA per (query tile of 64, head, batch); Q, dO, lse and delta
//     stay in shared memory, the CTA walks the key tiles its rows can see,
//     recomputes S and dP and accumulates dQ in registers.
// The tiles that do the most causal work are launched first.
//   bfloat16 (flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel): the
//     products on the tensor cores with mma.sync (see namespace mma);
//     P and dS are rounded to bf16 as operands of the dV, dK and dQ
//     products, as the forward rounds P for P V.
//   float32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): fp32 on the CUDA
//     cores, for the reference's fp32 tolerance, as the forward's fp32
//     kernel: 256 threads as a 16 x 16 grid of 4 x 4 micro tiles over fp32
//     tiles padded by one column, P and dS through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kB = 64;         // rows per query tile and per key tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// cudaFuncSetAttribute once per kernel instantiation and device.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t smem,
                          bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return err;
}

// Rows [r0, r0 + kB) of a (rows, D) matrix into a [kB][D + 1] fp32 tile;
// rows >= n read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n) {
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int g = r0 + r;
    dst[r * (D + 1) + c] =
        g < n ? to_f32(src[static_cast<int64_t>(g) * D + c]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two [kB][D + 1]
// tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ------------------------------------------------------------- delta

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(g[d]), to_f32(o[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// -------------------------------------------------------------- dK, dV

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO tiles; P and dS tiles; lse and delta of the query tile.
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Hk, int Sq, int Sk,
                      int causal, int q_offset, float sm_scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                    // [kB][D + 1]
  float* Vs = Ks + kB * (D + 1);
  float* Qs = Vs + kB * (D + 1);
  float* Gs = Qs + kB * (D + 1);       // dO
  float* Ps = Gs + kB * (D + 1);       // [kB query][kB + 1 key]
  float* Ss = Ps + kB * (kB + 1);      // dS, same layout
  float* Ls = Ss + kB * (kB + 1);      // lse of the query tile
  float* Ds = Ls + kB;                 // delta of the query tile

  const int bhk = blockIdx.x;          // b * Hk + hk
  const int b = bhk / Hk;
  const int hk = bhk - b * Hk;
  const int k0 = blockIdx.y * kB;      // the heaviest (first) key tiles first
  const int rep = H / Hk;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t kv_off = static_cast<int64_t>(bhk) * Sk * D;

  load_tile<T, D>(Ks, k + kv_off, k0, Sk);
  load_tile<T, D>(Vs, v + kv_off, k0, Sk);

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // Query rows that see key k0 or later: i + q_offset >= k0.
  const int q_first = causal ? max(0, k0 - q_offset) / kB * kB : 0;
  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    const T* qh = q + bh * Sq * D;
    const T* gh = dout + bh * Sq * D;
    for (int q0 = q_first; q0 < Sq; q0 += kB) {
      __syncthreads();   // the previous tile's Q, dO, P, dS are consumed
      load_tile<T, D>(Qs, qh, q0, Sq);
      load_tile<T, D>(Gs, gh, q0, Sq);
      if (tid < kB) {
        const int g = q0 + tid;
        Ls[tid] = g < Sq ? lse[bh * Sq + g] : 0.f;
        Ds[tid] = g < Sq ? delta[bh * Sq + g] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<D>(s, Qs, Ks, ty, tx);   // rows: queries, cols: keys
      tile_dot<D>(dp, Gs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qi = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int kj = k0 + c;
          const bool live =
              qi < Sq && kj < Sk && (!causal || kj <= qi + q_offset);
          const float p = live ? expf(s[i][j] * sm_scale - Ls[r]) : 0.f;
          Ps[r * (kB + 1) + c] = p;
          Ss[r * (kB + 1) + c] = p * (dp[i][j] - Ds[r]) * sm_scale;
        }
      }
      __syncthreads();

      // dV[key][d] += sum_i P[i][key] dO[i][d]; dK likewise with dS, Q.
#pragma unroll 2
      for (int i = 0; i < kB; ++i) {
        float g[kCols], qv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          g[c] = Gs[i * (D + 1) + tx + 16 * c];
          qv[c] = Qs[i * (D + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = Ps[i * (kB + 1) + ty + 16 * r];
          const float ds = Ss[i * (kB + 1) + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dv_acc[r][c] = fmaf(p, g[c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(ds, qv[c], dk_acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + ty + 16 * r;
    if (kj >= Sk) continue;
    const int64_t off = kv_off + static_cast<int64_t>(kj) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[off + tx + 16 * c] = from_f32<T>(dk_acc[r][c]);
      dv[off + tx + 16 * c] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

// ------------------------------------------------------------------ dQ

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles; the dS tile; lse and delta of the query tile.
  return sizeof(float) * (4 * kB * (D + 1) + kB * (kB + 1) + 2 * kB);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Hk, int Sq, int Sk, int causal, int q_offset,
                    float sm_scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kB][D + 1]
  float* Gs = Qs + kB * (D + 1);       // dO
  float* Ks = Gs + kB * (D + 1);
  float* Vs = Ks + kB * (D + 1);
  float* Ss = Vs + kB * (D + 1);       // dS: [kB query][kB + 1 key]
  float* Ls = Ss + kB * (kB + 1);
  float* Ds = Ls + kB;

  const int bh = blockIdx.x;           // b * H + h
  const int b = bh / H;
  const int hk = (bh - b * H) / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;   // the heaviest first
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t q_off = static_cast<int64_t>(bh) * Sq * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * Hk + hk) * Sk * D;

  load_tile<T, D>(Qs, q + q_off, q0, Sq);
  load_tile<T, D>(Gs, dout + q_off, q0, Sq);
  if (tid < kB) {
    const int g = q0 + tid;
    Ls[tid] = g < Sq ? lse[static_cast<int64_t>(bh) * Sq + g] : 0.f;
    Ds[tid] = g < Sq ? delta[static_cast<int64_t>(bh) * Sq + g] : 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  // Keys past the last one a row of this tile can see are masked for
  // every row: skip their tiles.
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(q0 + kB, Sq) + q_offset);
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();   // the previous tile's K, V and dS are consumed
    load_tile<T, D>(Ks, k + kv_off, k0, Sk);
    load_tile<T, D>(Vs, v + kv_off, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, Qs, Ks, ty, tx);
    tile_dot<D>(dp, Gs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        const bool live =
            qi < Sq && kj < Sk && (!causal || kj <= qi + q_offset);
        const float p = live ? expf(s[i][j] * sm_scale - Ls[r]) : 0.f;
        Ss[r * (kB + 1) + c] = p * (dp[i][j] - Ds[r]) * sm_scale;
      }
    }
    __syncthreads();

    // dQ[row][d] += sum_j dS[row][j] K[j][d].
#pragma unroll 2
    for (int j = 0; j < kB; ++j) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = Ks[j * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = Ss[(ty + 16 * r) * (kB + 1) + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(ds, kv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= Sq) continue;
    const int64_t off = q_off + static_cast<int64_t>(qi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[off + tx + 16 * c] = from_f32<T>(acc[r][c]);
  }
}

// ------------------------------------------- bf16: the tensor cores

// The bf16 kernels compute the same gradients with mma.sync m16n8k16
// (bf16 operands, fp32 accumulators) on tiles kept bf16 in shared
// memory. One CTA of 4 warps per 64-row tile; each warp owns 16 rows of
// the CTA's tile and walks the other side 16 rows (a "chunk") at a time.
// S and dP come out of the tensor cores in the accumulator layout, are
// turned into P and dS in registers, and are rounded to bf16 as the A
// operand of the next product (the accumulator layout of two 8-column
// tiles is the A layout of one 16-deep step), so P and dS never touch
// shared memory. Operands whose rows run along the reduction (dO and Q
// for dV and dK, K for dQ) are read with ldmatrix.trans. Rows are padded
// by 8 elements (16 bytes) so the fragment loads are free of bank
// conflicts.
namespace mma {

constexpr int kBlk = 64;               // rows per CTA tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

template <int D>
struct Layout {
  static constexpr int kStride = D + 8;           // bf16 per tile row
  static constexpr int kTile = kBlk * kStride;    // bf16 per tile
  // Four bf16 tiles, then lse * log2(e) and delta of the query tile.
  static constexpr size_t kSmem = 4 * kTile * sizeof(bf16) +
                                  2 * kBlk * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment at rows m0.., columns k0.. of a [rows][kStride] tile
// whose reduction dim is contiguous.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int m0, int k0, int lane) {
  constexpr int S = Layout<D>::kStride;
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = tile + (m0 + g) * S + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * S);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * S + 8);
}

// The B fragment (16 deep, 8 wide) at rows n0.. (the fragment's columns),
// columns k0.. of a tile whose reduction dim is contiguous.
template <int D>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* tile, int n0, int k0,
                                       int lane) {
  constexpr int S = Layout<D>::kStride;
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = tile + (n0 + g) * S + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// The B fragment at rows k0 .. k0 + 15 (the reduction), columns n0 ..
// n0 + 7 of a tile stored along rows: ldmatrix.trans, lanes 0-15 naming
// the 16 rows.
template <int D>
__device__ __forceinline__ void load_b_trans(uint32_t& b0, uint32_t& b1,
                                             const bf16* tile, int k0,
                                             int n0, int lane) {
  constexpr int S = Layout<D>::kStride;
  const uint32_t addr = smem_u32(tile + (k0 + (lane & 15)) * S + n0);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

// Rows [r0, r0 + kBlk) of a (rows, D) bf16 matrix into a padded tile in
// 16-byte vectors; rows >= n are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int n) {
  constexpr int S = Layout<D>::kStride;
  constexpr int kVec = D / 8;   // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < kBlk * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 8;
    const int g = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (g < n)
      val = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(g) * D +
                                            c);
    *reinterpret_cast<uint4*>(dst + r * S + c) = val;
  }
}

// lse (in base 2) and delta of query rows [q0, q0 + kBlk).
__device__ __forceinline__ void load_rows(float* ls, float* ds,
                                          const float* lse,
                                          const float* delta, int64_t base,
                                          int q0, int Sq) {
  for (int r = threadIdx.x; r < kBlk; r += kThreads) {
    const int g = q0 + r;
    ls[r] = g < Sq ? lse[base + g] * kLog2e : 0.f;
    ds[r] = g < Sq ? delta[base + g] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                          int Hk, int Sq, int Sk, int causal, int q_offset,
                          float sm_scale) {
  using L = Layout<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + L::kTile;
  bf16* Qs = Vs + L::kTile;
  bf16* Gs = Qs + L::kTile;     // dO
  float* Ls = reinterpret_cast<float*>(Gs + L::kTile);
  float* Ds = Ls + kBlk;

  const int bhk = blockIdx.x;
  const int b = bhk / Hk;
  const int hk = bhk - b * Hk;
  const int k0 = blockIdx.y * kBlk;    // the heaviest (first) key tiles first
  const int rep = H / Hk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kr = 16 * warp;            // this warp's key rows in the tile
  const float scale_log2 = sm_scale * kLog2e;
  const int64_t kv_off = static_cast<int64_t>(bhk) * Sk * D;

  load_tile<D>(Ks, k + kv_off, k0, Sk);
  load_tile<D>(Vs, v + kv_off, k0, Sk);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int q_first = causal ? max(0, k0 - q_offset) / kBlk * kBlk : 0;
  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    for (int q0 = q_first; q0 < Sq; q0 += kBlk) {
      __syncthreads();   // the previous tiles are consumed
      load_tile<D>(Qs, q + bh * Sq * D, q0, Sq);
      load_tile<D>(Gs, dout + bh * Sq * D, q0, Sq);
      load_rows(Ls, Ds, lse, delta, bh * Sq, q0, Sq);
      __syncthreads();
#pragma unroll 1
      for (int c = 0; c < kBlk; c += 16) {
        // Every query of the chunk is before every key of this warp.
        if (causal && q0 + c + 15 + q_offset < k0 + kr) continue;
        float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t a[4], b0, b1;
          load_a<D>(a, Ks, kr, kk, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            load_b<D>(b0, b1, Qs, c + 8 * nt, kk, lane);
            mma16816(s[nt], a, b0, b1);
          }
          load_a<D>(a, Vs, kr, kk, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            load_b<D>(b0, b1, Gs, c + 8 * nt, kk, lane);
            mma16816(dp[nt], a, b0, b1);
          }
        }
        // s[nt][e]: key row kr + g + 8 (e / 2), query column
        // c + 8 nt + 2 t + e % 2 of the tiles.
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + kr + g + 8 * (e >> 1);
            const int ql = c + 8 * nt + 2 * t + (e & 1);
            const int qi = q0 + ql;
            const bool live =
                qi < Sq && kj < Sk && (!causal || kj <= qi + q_offset);
            const float p =
                live ? exp2f(fmaf(s[nt][e], scale_log2, -Ls[ql])) : 0.f;
            s[nt][e] = p;
            dp[nt][e] = p * (dp[nt][e] - Ds[ql]) * sm_scale;
          }
        const uint32_t pa[4] = {pack(s[0][0], s[0][1]), pack(s[0][2], s[0][3]),
                                pack(s[1][0], s[1][1]), pack(s[1][2], s[1][3])};
        const uint32_t da[4] = {pack(dp[0][0], dp[0][1]),
                                pack(dp[0][2], dp[0][3]),
                                pack(dp[1][0], dp[1][1]),
                                pack(dp[1][2], dp[1][3])};
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b0, b1;
          load_b_trans<D>(b0, b1, Gs, c, 8 * n, lane);
          mma16816(dv_acc[n], pa, b0, b1);
          load_b_trans<D>(b0, b1, Qs, c, 8 * n, lane);
          mma16816(dk_acc[n], da, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = k0 + kr + g + 8 * half;
    if (kj >= Sk) continue;
    const int64_t off = kv_off + static_cast<int64_t>(kj) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
          __floats2bfloat162_rn(dk_acc[n][2 * half], dk_acc[n][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int Hk, int Sq, int Sk,
                        int causal, int q_offset, float sm_scale) {
  using L = Layout<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + L::kTile;     // dO
  bf16* Ks = Gs + L::kTile;
  bf16* Vs = Ks + L::kTile;
  float* Ls = reinterpret_cast<float*>(Vs + L::kTile);
  float* Ds = Ls + kBlk;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hk = (bh - b * H) / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlk;   // the heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int qr = 16 * warp;            // this warp's query rows in the tile
  const float scale_log2 = sm_scale * kLog2e;
  const int64_t q_off = static_cast<int64_t>(bh) * Sq * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * Hk + hk) * Sk * D;

  load_tile<D>(Qs, q + q_off, q0, Sq);
  load_tile<D>(Gs, dout + q_off, q0, Sq);
  load_rows(Ls, Ds, lse, delta, static_cast<int64_t>(bh) * Sq, q0, Sq);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(q0 + kBlk, Sq) + q_offset);
  for (int k0 = 0; k0 < kv_end; k0 += kBlk) {
    __syncthreads();   // the previous key tile is consumed
    load_tile<D>(Ks, k + kv_off, k0, Sk);
    load_tile<D>(Vs, v + kv_off, k0, Sk);
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kBlk; c += 16) {
      // Every key of the chunk is after every query of this warp.
      if (causal && k0 + c > q0 + qr + 15 + q_offset) continue;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4], b0, b1;
        load_a<D>(a, Qs, qr, kk, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          load_b<D>(b0, b1, Ks, c + 8 * nt, kk, lane);
          mma16816(s[nt], a, b0, b1);
        }
        load_a<D>(a, Gs, qr, kk, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          load_b<D>(b0, b1, Vs, c + 8 * nt, kk, lane);
          mma16816(dp[nt], a, b0, b1);
        }
      }
      // s[nt][e]: query row qr + g + 8 (e / 2), key column
      // c + 8 nt + 2 t + e % 2 of the tiles.
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qr + g + 8 * (e >> 1);
          const int qi = q0 + ql;
          const int kj = k0 + c + 8 * nt + 2 * t + (e & 1);
          const bool live =
              qi < Sq && kj < Sk && (!causal || kj <= qi + q_offset);
          const float p =
              live ? exp2f(fmaf(s[nt][e], scale_log2, -Ls[ql])) : 0.f;
          dp[nt][e] = p * (dp[nt][e] - Ds[ql]) * sm_scale;
        }
      const uint32_t da[4] = {pack(dp[0][0], dp[0][1]), pack(dp[0][2], dp[0][3]),
                              pack(dp[1][0], dp[1][1]),
                              pack(dp[1][2], dp[1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_trans<D>(b0, b1, Ks, c, 8 * n, lane);
        mma16816(acc[n], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + qr + g + 8 * half;
    if (qi >= Sq) continue;
    const int64_t off = q_off + static_cast<int64_t>(qi) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

}  // namespace mma

// ------------------------------------------------------------- launch

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int Hk, int Sq, int Sk,
           int causal, int q_offset, float sm_scale, cudaStream_t stream) {
  static bool dkdv_set[kMaxDevices] = {};
  static bool dq_set[kMaxDevices] = {};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * H * Sq;
  const int64_t delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_delta_kernel<T, D>
      <<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(out), gt, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    constexpr size_t smem = mma::Layout<D>::kSmem;
    constexpr int blk = mma::kBlk;
    err = set_smem_once(mma::flash_bwd_dkdv_mma_kernel<D>, smem, dkdv_set);
    if (err == cudaSuccess)
      err = set_smem_once(mma::flash_bwd_dq_mma_kernel<D>, smem, dq_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    mma::flash_bwd_dkdv_mma_kernel<D>
        <<<dim3(B * Hk, (Sk + blk - 1) / blk), mma::kThreads, smem, stream>>>(
            qt, kt, vt, gt, lse, delta, static_cast<T*>(dk),
            static_cast<T*>(dv), H, Hk, Sq, Sk, causal, q_offset, sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    mma::flash_bwd_dq_mma_kernel<D>
        <<<dim3(B * H, (Sq + blk - 1) / blk), mma::kThreads, smem, stream>>>(
            qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), H, Hk, Sq, Sk,
            causal, q_offset, sm_scale);
  } else {
    constexpr size_t dkdv_smem = dkdv_smem_bytes<D>();
    constexpr size_t dq_smem = dq_smem_bytes<D>();
    err = set_smem_once(flash_bwd_dkdv_kernel<T, D>, dkdv_smem, dkdv_set);
    if (err == cudaSuccess)
      err = set_smem_once(flash_bwd_dq_kernel<T, D>, dq_smem, dq_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkdv_kernel<T, D>
        <<<dim3(B * Hk, (Sk + kB - 1) / kB), kThreads, dkdv_smem, stream>>>(
            qt, kt, vt, gt, lse, delta, static_cast<T*>(dk),
            static_cast<T*>(dv), H, Hk, Sq, Sk, causal, q_offset, sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_kernel<T, D>
        <<<dim3(B * H, (Sq + kB - 1) / kB), kThreads, dq_smem, stream>>>(
            qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), H, Hk, Sq, Sk,
            causal, q_offset, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one CTA of the dK/dV kernel (which = 0) or the
// dQ kernel (which = 1) at head dim D; dtype 0 = float32 (the CUDA-core
// kernels), 1 = bfloat16 (the tensor-core kernels, one size for both).
int64_t flash_bwd_smem_bytes(int dtype, int which, int D) {
  if (dtype == 1) {
    switch (D) {
      case 32: return mma::Layout<32>::kSmem;
      case 64: return mma::Layout<64>::kSmem;
      case 128: return mma::Layout<128>::kSmem;
    }
    return -1;
  }
  switch (D) {
    case 32: return which == 0 ? dkdv_smem_bytes<32>() : dq_smem_bytes<32>();
    case 64: return which == 0 ? dkdv_smem_bytes<64>() : dq_smem_bytes<64>();
    case 128:
      return which == 0 ? dkdv_smem_bytes<128>() : dq_smem_bytes<128>();
  }
  return -1;
}

// Launch the backward on `stream`: delta into `delta` (B * H * Sq fp32
// scratch), then dK/dV and dQ. dtype 0 = float32, 1 = bfloat16. Returns 0
// or the first cudaError_t.
int flash_bwd_launch(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const void* lse,
                     void* delta, void* dq, void* dk, void* dv, int dtype,
                     int B, int H, int Hk, int Sq, int Sk, int D, int causal,
                     int q_offset, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define REPRO_BWD_ARGS q, k, v, out, dout, l, dl, dq, dk, dv, B, H, Hk, Sq, \
                       Sk, causal, q_offset, sm_scale, s
  if (dtype == 0) {
    switch (D) {
      case 32: return launch<float, 32>(REPRO_BWD_ARGS);
      case 64: return launch<float, 64>(REPRO_BWD_ARGS);
      case 128: return launch<float, 128>(REPRO_BWD_ARGS);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch<__nv_bfloat16, 32>(REPRO_BWD_ARGS);
      case 64: return launch<__nv_bfloat16, 64>(REPRO_BWD_ARGS);
      case 128: return launch<__nv_bfloat16, 128>(REPRO_BWD_ARGS);
    }
  }
#undef REPRO_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
