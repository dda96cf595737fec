// Flash-attention backward for Hopper (sm_90a): a delta kernel and two
// gradient kernels a call, for float32 and bfloat16 inputs.
//
// The TPU side has no Pallas backward: the reference differentiates its
// blockwise attention through the custom VJP _blockwise_bwd
// (src/repro/models/attention.py:142), a scan over key blocks that
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
// Design. No atomics of any kind: every output element is written once by
// one CTA, its sums in a fixed order, so a result is the same bit for bit
// from run to run (training resumes bit-exactly). The price is that S and
// dP are computed twice, once for dK/dV and once for dQ: 7 products a
// live pair (14 D flops) against the bound's 8 D. Three kernels on one
// stream:
//   flash_bwd_delta_kernel: one warp per query row, delta_i in fp32.
//   dK/dV: one CTA per (key tile, kv head, batch). K and V stay in
//     shared memory; the CTA walks every query head of its GQA group and
//     every query tile that sees one of its keys, recomputes S and dP,
//     and accumulates dK and dV in registers. Each kv head's dK and dV are
//     written once, directly: no expanded (B, S, H, D) buffer and no
//     reduction pass.
//   dQ: one CTA per (query tile, head, batch); Q, dO, lse and delta stay
//     on chip, the CTA walks the key tiles its rows can see, recomputes S
//     and dP and accumulates dQ in registers.
// The tiles that do the most causal work are launched first.
//   bfloat16 (flash_bwd_dkdv_wgmma_kernel, flash_bwd_dq_wgmma_kernel):
//     warp-specialised wgmma kernels fed by TMA (see namespace wg); P and
//     dS are rounded to bf16 as operands of the dV, dK and dQ products, as
//     the forward rounds P for P V, and dS is made from the bf16 P.
//   float32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): fp32 on the CUDA
//     cores, for the reference's fp32 tolerance, as the forward's fp32
//     kernel: 256 threads as a 16 x 16 grid of 4 x 4 micro tiles over fp32
//     tiles padded by one column, P and dS through shared memory.
#include <cuda.h>          // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

// The bf16 kernels: wgmma on the tensor cores, fed by TMA. Each CTA has
// 384 threads: two consumer warpgroups and one producer warpgroup, which
// hands its registers to the consumers (setmaxnreg 24 / 240) and of which
// one thread issues every TMA load. Tiles stay bf16 in shared memory as
// swizzle atoms (hopper.cuh), loaded through (D, S, B * heads) tensor maps
// whose box is 64 rows of one head, so the hardware's zero fill stops at
// each head's own end. A CTA loads its own tiles once, then the producer
// keeps a ring of kStages stages of 64 rows of the other side full: one
// mbarrier marks a stage full (its TMA bytes and, in the dK/dV kernel, its
// lse and delta rows stored by the producer warp's 32 lanes), a second one
// marks it empty (one arrival per consumer warp). The stage counter runs
// on across heads, so one parity arithmetic serves the whole ring.
//
// A consumer computes a 64 x 64 score tile of a stage with wgmma
// m64n64k16, both operands K-major from shared memory, turns it into P or
// dS in registers in the accumulator layout (base-2 exponentials with the
// log2(e) / sqrt(D) scale in one FMA; the mask only on tiles that cross
// the diagonal, Sq or Sk), rounds it to bf16 as the A operand of the next
// product (the accumulator layout of 16 columns is the A layout of a
// 16-deep step) and accumulates a gradient with register-A wgmma
// m64n{D}k16, B read MN-major from shared memory. P is rounded to bf16 as
// soon as it is made and dS is computed from that bf16 P. A stage's
// gradient product is left in flight while the next stage's score product
// is issued; the stage's slot is handed back when it is done.
//
// Registers shaped the design. ptxas gives a consumer the 240 registers of
// setmaxnreg, but issues every wgmma of a kernel one at a time (its C7512
// note) once a consumer holds much more than 168: a warpgroup that keeps
// dK and dV (128 registers at D = 128) beside S^T and dP^T (64) spills and
// runs serialized. So no consumer holds two accumulators, or two score
// tiles, at once:
// flash_bwd_dkdv_wgmma_kernel: one CTA per (key tile of 64, kv head,
//   batch). K and V are loaded once; the ring holds (Q, dO) of 64 query
//   rows of every query head of the GQA group and every query tile that
//   sees a key of the CTA. Both warpgroups own the tile's 64 keys:
//   warpgroup 0 computes S^T = K Q^T, P and dV += P^T dO; warpgroup 1
//   computes dP^T = V dO^T, takes the stage's P from warpgroup 0 through
//   shared memory (named barrier 1 + slot), makes dS and dK += dS^T Q.
//   Each stores its gradient once, summed over the whole group.
// flash_bwd_dq_wgmma_kernel: one CTA per (query tile of 128, head,
//   batch); warpgroup wg owns query rows q0 + 64 wg .. + 63. Q, dO, lse
//   and delta are loaded once; the ring holds (K, V) of 64 keys up to the
//   last key a row of the tile sees. Per stage: S = Q K^T, P, then
//   dP = dO V^T (into S's registers), dS and dQ += dS K.
// Shared memory at D = 128: dK/dV 2 x 16 KB once + 2 stages x (2 x 16 KB +
// 8 KB of P) + 1 KB of lse and delta rows = 113 KB; dQ 2 x 32 KB once +
// 2 stages x 2 x 16 KB = 128 KB; one CTA per SM.
// Head dims 80 and 192 (hubert-xlarge, nemotron-4-340b), as the forward
// takes them: at D = 80 the tiles are D = 128's, the tensor maps' zero
// fill past the 80 real columns, the score products take the 5 real
// 16-column steps and the gradients are accumulated 128 wide and stored
// 80 wide; at D = 192 (three atoms) a consumer holds a 96-register
// gradient, the gradient products are m64n192k16, and shared memory is
// dK/dV 161 KB, dQ 193 KB.
namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kTile = 128;           // query rows of a dQ CTA
constexpr int kRows = 64;            // keys of a dK/dV CTA, rows of a stage
constexpr int kStages = 2;           // ring depth
constexpr int kConsumerWarps = 8;    // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory layout of both kernels (tiles Atom<D>::kPadded columns
// wide): two tiles of kOnce rows
// loaded once, then kStages x two tiles of kRows rows; in the dK/dV
// kernel then kStages x P (the 16 bf16-pair words of each of a
// warpgroup's 128 threads, word i of every thread in row i) and kStages x
// (lse * log2(e), delta) of kRows query rows; then the mbarriers.
template <int D, int kOnce, bool kDkdv>
struct Smem {
  static constexpr uint32_t kTileBytes = kOnce * Atom<D>::kPadded * 2;
  static constexpr uint32_t kStageBytes = kRows * Atom<D>::kPadded * 2;
  static constexpr uint32_t kPOffset =
      2 * kTileBytes + 2 * kStages * kStageBytes;
  static constexpr uint32_t kPWords = 16 * 128;    // a stage's P
  static constexpr uint32_t kRowsOffset =
      kPOffset + (kDkdv ? kStages * kPWords * 4 : 0);
  static constexpr uint32_t kBarrierOffset =
      kRowsOffset + (kDkdv ? kStages * 2 * kRows * sizeof(float) : 0);
  // + the barriers, + slack to align the base to 1024 bytes.
  static constexpr size_t kSmem = kBarrierOffset + 64 + 1024;
};
template <int D>
using DkdvSmem = Smem<D, kRows, true>;
template <int D>
using DqSmem = Smem<D, kTile, false>;

// Rows [r0, r0 + rows) of head `head` into a tile of `rows` rows, one box
// of kRows rows per swizzle atom and 64-row block.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int r0,
                                         int head) {
  using A = Atom<D>;
#pragma unroll
  for (int a = 0; a < A::kCount; ++a)
    for (int r = 0; r < rows; r += kRows)
      tma_load_3d(dst + (a * rows + r) * A::kBytes, map, bar, a * A::kCols,
                  r0 + r, head);
}

// K-major operand: rows row0 .. row0 + 63 (M of A, or N of B) of a tile
// of `rows` rows, reduction step kk (columns 16 kk .. 16 kk + 15).
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int row0,
                                           int kk) {
  using A = Atom<D>;
  const uint32_t off = ((kk * 16 / A::kCols) * rows + row0) * A::kBytes +
                       (kk * 16 % A::kCols) * 2;
  return make_desc(tile + off, 16, 8 * A::kBytes, A::kLayout);
}

// MN-major B operand: rows 16 kk .. 16 kk + 15 (the reduction) and all
// kPadded columns of a tile of `rows` rows; the atoms along D lie `rows`
// rows apart.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  using A = Atom<D>;
  return make_desc(tile + kk * 16 * A::kBytes, rows * A::kBytes,
                   8 * A::kBytes, A::kLayout);
}

// The bf16 A fragments of a 64 x 64 accumulator, four 16-deep steps.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Rows `row` and row + 8 of a 64 x kPadded accumulator into a (rows, D)
// bf16 matrix: its D real columns; rows >= n are not stored.
template <int D>
__device__ __forceinline__ void store_rows(
    bf16* dst, const float (&acc)[Atom<D>::kPadded / 2], int row, int c0,
    int n) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = row + 8 * r;
    if (g >= n) continue;
    bf16* out = dst + static_cast<int64_t>(g) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap g_map,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int H, int Hk, int Sq, int Sk, int causal,
                            int q_offset, float sm_scale) {
  using L = DkdvSmem<D>;
  static_assert(D == 32 || D == 64 || D == 80 || D == 128 || D == 192,
                "head dim");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base;                          // [atoms][kRows rows]
  const uint32_t sV = sK + L::kTileBytes;
  const uint32_t sQ = sV + L::kTileBytes;            // [kStages] stage tiles
  const uint32_t sG = sQ + kStages * L::kStageBytes; // dO, [kStages]
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(gbase + L::kPOffset);
  float* rows = reinterpret_cast<float*>(gbase + L::kRowsOffset);
  const uint32_t kv_full = base + L::kBarrierOffset;  // then full, empty
  const uint32_t full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int bhk = blockIdx.x;                  // b * Hk + hk
  const int b = bhk / Hk;
  const int hk = bhk - b * Hk;
  const int k0 = blockIdx.y * kRows;           // the heaviest tiles first
  const int rep = H / Hk;
  // Query rows that see key k0 or later: i + q_offset >= k0.
  const int q_first = causal ? max(0, k0 - q_offset) / kRows * kRows : 0;
  const int n_q = q_first < Sq ? (Sq - q_first + kRows - 1) / kRows : 0;
  const int n_stages = rep * n_q;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);   // the TMA bytes + 32 lanes' rows
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumerWarps) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kTileBytes);
        tma_tile<D>(sK, &k_map, kv_full, kRows, k0, bhk);
        tma_tile<D>(sV, &v_map, kv_full, kRows, k0, bhk);
      }
      for (int t = 0; t < n_stages; ++t) {
        const int s = t % kStages;
        const int q0 = q_first + (t % n_q) * kRows;
        const int bh = b * H + hk * rep + t / n_q;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full, 2 * L::kStageBytes);
          tma_tile<D>(sQ + s * L::kStageBytes, &q_map, full, kRows, q0, bh);
          tma_tile<D>(sG + s * L::kStageBytes, &g_map, full, kRows, q0, bh);
        }
        float* ls = rows + s * 2 * kRows;
        for (int r = lane; r < kRows; r += 32) {
          const int g = q0 + r;
          const int64_t at = static_cast<int64_t>(bh) * Sq + g;
          ls[r] = g < Sq ? lse[at] * kLog2e : 0.f;
          ls[kRows + r] = g < Sq ? delta[at] : 0.f;
        }
        mbar_arrive(full);
      }
    }
    return;
  }

  // Consumers: both warpgroups own keys [k0, k0 + 64), this thread key
  // rows rk and rk + 8 of the accumulator layout. Warpgroup 0 makes P and
  // dV, warpgroup 1 dP, dS and dK: each holds one 64 x D accumulator, so
  // neither runs out of registers. Warpgroup 0 hands each stage's P (bf16,
  // in its accumulator layout, which is warpgroup 1's dP^T layout) over
  // through shared memory and named barrier 1 + stage slot.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int rk = k0 + 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float scale_log2 = sm_scale * kLog2e;

  constexpr int kPadded = Atom<D>::kPadded;
  float acc[kPadded / 2];   // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < kPadded / 2; ++i) acc[i] = 0.f;
  mbar_wait(kv_full, 0);

  // A stage's gradient product is left in flight while the next stage's
  // score product is issued; the stage's slot is handed back once its
  // product is done (`held`: the slot whose product may still run).
  uint32_t pa[4][4];
  int held = -1;
  for (int t = 0; t < n_stages; ++t) {
    const int s = t % kStages;
    const int q0 = q_first + (t % n_q) * kRows;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    // Every stage holds a query that sees a key of the tile (q_first).
    const uint32_t q_s = sQ + s * L::kStageBytes;
    const uint32_t g_s = sG + s * L::kStageBytes;
    const float* ls = rows + s * 2 * kRows;
    uint32_t* ps = pbuf + s * L::kPWords + tid;
    float sc[32];   // S^T or dP^T: keys x queries
    // sc[4 j + e] is key rk + 8 (e / 2), query q0 + 8 j + c0 + e % 2.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, desc_k<D>(wg == 0 ? sK : sV, kRows, 0, kk),
                   desc_k<D>(wg == 0 ? q_s : g_s, kRows, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's product is done
    if (held >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * held);
    }
    wgmma_wait_all();
    fence_regs(sc);
    if (wg == 0) {
      const bool edge = k0 + kRows > Sk || q0 + kRows > Sq ||
                        (causal && k0 + kRows - 1 > q0 + q_offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float l2 = ls[8 * (i >> 2) + c0 + (i & 1)];
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -l2));
        if (edge) {
          const int kj = rk + 8 * ((i >> 1) & 1);
          const int qi = q0 + 8 * (i >> 2) + c0 + (i & 1);
          if (kj >= Sk || qi >= Sq || (causal && kj > qi + q_offset))
            sc[i] = 0.f;
        }
      }
      pack_a(pa, sc);
#pragma unroll
      for (int i = 0; i < 16; ++i) ps[128 * i] = pa[i / 4][i % 4];
      asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + s) : "memory");
    } else {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + s) : "memory");
#pragma unroll
      for (int i = 0; i < 16; ++i) pa[i / 4][i % 4] = ps[128 * i];
      // dS = P (dP - delta) / sqrt(D) from the bf16 P that dV uses.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const uint32_t pair = pa[i / 8][(i % 8) / 2];
        const float pv = __uint_as_float((i & 1) ? pair & 0xFFFF0000u
                                                 : pair << 16);
        sc[i] = pv * (sc[i] - ls[kRows + 8 * (i >> 2) + c0 + (i & 1)]) *
                sm_scale;
      }
      pack_a(pa, sc);
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kPadded>(acc, pa[kk],
                        desc_mn<D>(wg == 0 ? g_s : q_s, kRows, kk));
    wgmma_commit();
    held = s;
  }
  wgmma_wait_all();
  fence_regs(acc);
  __syncwarp();
  if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);

  const int64_t kv_off = static_cast<int64_t>(bhk) * Sk * D;
  store_rows<D>((wg == 0 ? dv : dk) + kv_off, acc, rk, c0, Sk);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap g_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int H, int Hk, int Sq,
                          int Sk, int causal, int q_offset, float sm_scale) {
  using L = DqSmem<D>;
  static_assert(D == 32 || D == 64 || D == 80 || D == 128 || D == 192,
                "head dim");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                          // [atoms][kTile rows]
  const uint32_t sG = sQ + L::kTileBytes;            // dO
  const uint32_t sK = sG + L::kTileBytes;            // [kStages] stage tiles
  const uint32_t sV = sK + kStages * L::kStageBytes;
  const uint32_t q_full = base + L::kBarrierOffset;  // then full, empty
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int bh = blockIdx.x;                         // b * H + h
  const int b = bh / H;
  const int hk = (bh - b * H) / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // the heaviest first
  // Keys past the last one a row of this tile can see are masked for
  // every row: their stages are never loaded.
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(q0 + kTile, Sq) + q_offset);
  const int n_tiles = (kv_end + kRows - 1) / kRows;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(q_full, 2 * L::kTileBytes);
      tma_tile<D>(sQ, &q_map, q_full, kTile, q0, bh);
      tma_tile<D>(sG, &g_map, q_full, kTile, q0, bh);
      const int kvh = b * Hk + hk;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kStageBytes);
        tma_tile<D>(sK + s * L::kStageBytes, &k_map, full, kRows, t * kRows,
                    kvh);
        tma_tile<D>(sV + s * L::kStageBytes, &v_map, full, kRows, t * kRows,
                    kvh);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [row_wg, row_wg + 64); this
  // thread holds rows r0 and r0 + 8 of the accumulator layout.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4;
  const int row_wg = q0 + wg * kRows;
  const int r0 = row_wg + 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float scale_log2 = sm_scale * kLog2e;
  float l2[2], d2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = r0 + 8 * r;
    const int64_t at = static_cast<int64_t>(bh) * Sq + g;
    l2[r] = g < Sq ? lse[at] * kLog2e : 0.f;
    d2[r] = g < Sq ? delta[at] : 0.f;
  }
  // The first key none of this warpgroup's rows sees.
  int wg_end = row_wg < Sq ? Sk : 0;
  if (causal && row_wg < Sq)
    wg_end = min(Sk, min(row_wg + kRows, Sq) + q_offset);

  constexpr int kPadded = Atom<D>::kPadded;
  float acc[kPadded / 2];
#pragma unroll
  for (int i = 0; i < kPadded / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  // A stage's dQ product is left in flight while the next stage's S is
  // issued; the stage's K/V slot is handed back once its product is done
  // (`held`: the slot whose product may still run).
  uint32_t da[4][4];
  int held = -1;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int kt0 = t * kRows;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    if (kt0 < wg_end) {
      const uint32_t k_s = sK + s * L::kStageBytes;
      const uint32_t v_s = sV + s * L::kStageBytes;
      // S, P rounded to bf16 at once, then dP into S's registers: S and
      // dP are never held together beside dQ and the product in flight.
      float sc[32];   // S, then dP: queries x keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<D>(sQ, kTile, wg * kRows, kk),
                     desc_k<D>(k_s, kRows, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's dQ product is done
      if (held >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * held);
      }
      wgmma_wait_all();
      fence_regs(sc);
      // sc[4 j + e] is row r0 + 8 (e / 2), key kt0 + 8 j + c0 + e % 2.
      const bool edge = kt0 + kRows > Sk || row_wg + kRows > Sq ||
                        (causal && kt0 + kRows - 1 > row_wg + q_offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -l2[r]));
        if (edge) {
          const int qi = r0 + 8 * r;
          const int kj = kt0 + 8 * (i >> 2) + c0 + (i & 1);
          if (kj >= Sk || qi >= Sq || (causal && kj > qi + q_offset))
            sc[i] = 0.f;
        }
      }
      uint32_t pa[4][4];
      pack_a(pa, sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<D>(sG, kTile, wg * kRows, kk),
                     desc_k<D>(v_s, kRows, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const uint32_t pair = pa[i / 8][(i % 8) / 2];
        const float pv = __uint_as_float((i & 1) ? pair & 0xFFFF0000u
                                                 : pair << 16);
        sc[i] = pv * (sc[i] - d2[(i >> 1) & 1]) * sm_scale;
      }
      pack_a(da, sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<kPadded>(acc, da[kk], desc_mn<D>(k_s, kRows, kk));
      wgmma_commit();
      held = s;
    } else {
      // Past this warpgroup's last key: hand back the held slot and this.
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) {
        if (held >= 0) mbar_arrive(empty0 + 8 * held);
        mbar_arrive(empty0 + 8 * s);
      }
      held = -1;
    }
  }
  wgmma_wait_all();
  fence_regs(acc);
  __syncwarp();
  if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);

  store_rows<D>(dq + static_cast<int64_t>(bh) * Sq * D, acc, r0, c0, Sq);
}

}  // namespace wg

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
    constexpr size_t dkdv_smem = wg::DkdvSmem<D>::kSmem;
    constexpr size_t dq_smem = wg::DqSmem<D>::kSmem;
    err = set_smem_once(wg::flash_bwd_dkdv_wgmma_kernel<D>, dkdv_smem,
                        dkdv_set);
    if (err == cudaSuccess)
      err = set_smem_once(wg::flash_bwd_dq_wgmma_kernel<D>, dq_smem, dq_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    // One set of maps, boxes of 64 rows, serves both kernels.
    CUtensorMap qm, km, vm, gm;
    int bad = hopper::encode<D>(&qm, q, Sq, B * H, wg::kRows);
    if (!bad) bad = hopper::encode<D>(&gm, dout, Sq, B * H, wg::kRows);
    if (!bad) bad = hopper::encode<D>(&km, k, Sk, B * Hk, wg::kRows);
    if (!bad) bad = hopper::encode<D>(&vm, v, Sk, B * Hk, wg::kRows);
    if (bad) return bad;
    wg::flash_bwd_dkdv_wgmma_kernel<D>
        <<<dim3(B * Hk, (Sk + wg::kRows - 1) / wg::kRows), wg::kThreads,
           dkdv_smem, stream>>>(qm, km, vm, gm, lse, delta, static_cast<T*>(dk),
                     static_cast<T*>(dv), H, Hk, Sq, Sk, causal, q_offset,
                     sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    wg::flash_bwd_dq_wgmma_kernel<D>
        <<<dim3(B * H, (Sq + wg::kTile - 1) / wg::kTile), wg::kThreads,
           dq_smem, stream>>>(qm, km, vm, gm, lse, delta, static_cast<T*>(dq), H, Hk,
                     Sq, Sk, causal, q_offset, sm_scale);
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
  return hopper::error_string(err);
}

// Dynamic shared memory of one CTA of the dK/dV kernel (which = 0) or the
// dQ kernel (which = 1) at head dim D; dtype 0 = float32 (the CUDA-core
// kernels), 1 = bfloat16 (the wgmma kernels, one layout for both).
int64_t flash_bwd_smem_bytes(int dtype, int which, int D) {
  if (dtype == 1) {
    switch (D) {
      case 32:
        return which == 0 ? wg::DkdvSmem<32>::kSmem : wg::DqSmem<32>::kSmem;
      case 64:
        return which == 0 ? wg::DkdvSmem<64>::kSmem : wg::DqSmem<64>::kSmem;
      case 80:
        return which == 0 ? wg::DkdvSmem<80>::kSmem : wg::DqSmem<80>::kSmem;
      case 128:
        return which == 0 ? wg::DkdvSmem<128>::kSmem
                          : wg::DqSmem<128>::kSmem;
      case 192:
        return which == 0 ? wg::DkdvSmem<192>::kSmem
                          : wg::DqSmem<192>::kSmem;
    }
    return -1;
  }
  switch (D) {
    case 32: return which == 0 ? dkdv_smem_bytes<32>() : dq_smem_bytes<32>();
    case 64: return which == 0 ? dkdv_smem_bytes<64>() : dq_smem_bytes<64>();
    case 80: return which == 0 ? dkdv_smem_bytes<80>() : dq_smem_bytes<80>();
    case 128:
      return which == 0 ? dkdv_smem_bytes<128>() : dq_smem_bytes<128>();
    case 192:
      return which == 0 ? dkdv_smem_bytes<192>() : dq_smem_bytes<192>();
  }
  return -1;
}

// Launch the backward on `stream`: delta into `delta` (B * H * Sq fp32
// scratch), then dK/dV and dQ. dtype 0 = float32, 1 = bfloat16. Returns 0,
// the first cudaError_t, or a tensor-map code of flash_bwd_error_string.
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
      case 80: return launch<float, 80>(REPRO_BWD_ARGS);
      case 128: return launch<float, 128>(REPRO_BWD_ARGS);
      case 192: return launch<float, 192>(REPRO_BWD_ARGS);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch<__nv_bfloat16, 32>(REPRO_BWD_ARGS);
      case 64: return launch<__nv_bfloat16, 64>(REPRO_BWD_ARGS);
      case 80: return launch<__nv_bfloat16, 80>(REPRO_BWD_ARGS);
      case 128: return launch<__nv_bfloat16, 128>(REPRO_BWD_ARGS);
      case 192: return launch<__nv_bfloat16, 192>(REPRO_BWD_ARGS);
    }
  }
#undef REPRO_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
