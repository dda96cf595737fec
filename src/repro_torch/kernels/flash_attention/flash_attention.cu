// Flash-attention forward for Hopper (sm_90a): two kernels, one per dtype.
//
// Both replace the Pallas TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/flash_attention.py:61, _flash_kernel
// :22-58): q (B, H, Sq, D) against k, v (B, Hk, Sk, D) with H % Hk == 0
// (GQA: query head h reads kv head h / (H / Hk), never an expanded copy),
// online softmax over key tiles in fp32, causal mask on global indices
// with q_offset (query i sees keys j <= i + q_offset), output in q's dtype.
// Masked scores use the reference's finite -1e30, never -inf: key 0 is live
// for every row and is in the first key tile, so every row's running max
// is a real score after that tile and masked entries weigh exp(-1e30 - m)
// = 0. Only key tiles up to the last key a row of the CTA can see are
// visited (the TPU kernel's nk_live skip). The result does not depend on
// the TPU kernel's bq / bk: each kernel tiles by its own sizes. Given a
// non-null lse pointer, both kernels also store each row's natural-log
// logsumexp of the scaled, masked scores, (B, H, Sq) fp32, as the
// reference's _blockwise_impl returns it for its backward; the store
// follows the KV loop and costs nothing when the pointer is null.
//
// What bounds it on this card: at the prefill shape (B 2, S 4096, H 24,
// D 128, causal) the forward does about 2.1e11 flops on 134 MB of input
// and output, so the tensor cores (989 TFLOP/s bf16), not HBM, bound it.
//
// flash_fwd_bf16_kernel (bf16 q, k, v; FA3's shape). One CTA of 384
// threads per (query tile of 128 rows, head, batch): two consumer
// warpgroups of 64 query rows each and one producer warpgroup, which hands
// its registers to the consumers (setmaxnreg 24 / 240). The CTAs of the
// query tiles that see the most keys are launched first, so the causal
// imbalance leaves no tail. The producer loads the Q tile once, then keeps
// a ring of kStages K/V stages of 128 keys full, all by TMA through 3-D
// tensor maps (D, S, B * heads), so the hardware's zero fill stops at each
// head's own end; every stage signals an mbarrier with its byte count and
// is handed back by the consumers through a second one. Tiles stay bf16 in
// shared memory with the 128-byte swizzle (64-byte at D <= 32) that wgmma
// reads. A consumer computes S = Q K^T with wgmma m64n128k16 (both
// operands from shared memory, fp32 accumulators), runs the online softmax
// in registers in the accumulator layout (base-2 exponentials, the
// log2(e) / sqrt(D) scale folded into one FMA with the running max; the
// mask only on tiles that cross the diagonal or Sk), converts P to bf16 in
// registers as wgmma's A operand and accumulates O += P V with V read
// MN-major from shared memory. The epilogue divides by the row sums and
// stores bf16, skipping rows >= Sq. Key columns >= Sk score -1e30.
// Shared memory at D = 128: Q 32 KB + 2
// stages x (K 32 KB + V 32 KB) = 160 KB, one CTA per SM.
// Head dims: every multiple of 16 up to 192 (hubert-xlarge's 80,
// nemotron-4-340b's 192, and 16, the head dim of every config reduced to
// d_model 64 and 4 heads). A D that is not a whole number of swizzle
// atoms is padded, as D = 80 is: the tensor maps keep the real D
// columns (a 160-byte row at 80), the last atom's box reaches past them
// and TMA fills the rest with zeros, so the tiles are those of the next
// instantiated width (16 -> 32, 48 -> 64, 80..112 -> 128, 144..176 ->
// 192); S takes the D / 16 real 16-column steps, O is accumulated over
// the padded width (its padded columns stay 0) and only D columns are
// stored; the scale is 1/sqrt(D). D > 128 is three atoms; its stages
// hold 64 keys (Tile), S is m64n64k16 and O += P V m64n192k16: Q 48 KB
// + 2 x (24 + 24) KB = 144 KB.
// A value head narrower than the q/k head (latent attention's DV = 128
// beside D = 192, REPRO_HEAD_DIM_PAIRS) takes its own tiles: K and Q are D
// wide, V, O and the epilogue DV wide (atoms of Atom<DV>), so P V is
// m64n{DV}k16 and nothing is padded to D: Q 48 KB + 2 x (24 + 16) KB =
// 128 KB at (192, 128). The fp32 kernel takes D = DV only.
//
// flash_fwd_f32_kernel (float32 q, k, v). The reference's fp32 tolerance
// (2e-5) rules out TF32 tensor cores, so fp32 stays on the CUDA cores: one
// CTA of 256 threads per (query tile of 64 rows, head, batch) stages Q and
// K/V tiles of 64 keys in shared memory; S = Q K^T as a 16 x 16 thread grid
// of 4 x 4 micro-tiles, the masked online softmax per row (16 lanes of a
// half warp share a row), P through shared memory, and O += P V with each
// thread owning 4 rows x D/16 columns of the fp32 accumulator.
#include <cuda.h>          // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_dims.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kMaxDevices = 64;

// cudaFuncSetAttribute once per kernel instantiation and device.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t smem, bool (&done)[kMaxDevices]) {
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

// =========================================================== fp32 kernel

namespace f32 {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads

template <int D>
constexpr size_t smem_bytes() {
  // Q and K padded by one column (conflict-free column reads), V, and P.
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Hk, int Sq, int Sk,
                     int causal, int q_offset, float sm_scale) {
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
  const float* qb = q + (static_cast<int64_t>(b) * H + h) * Sq * D;
  const float* kb = k + (static_cast<int64_t>(b) * Hk + hk) * Sk * D;
  const float* vb = v + (static_cast<int64_t>(b) * Hk + hk) * Sk * D;
  float* ob = o + (static_cast<int64_t>(b) * H + h) * Sq * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = q0 + r;
    Qs[r * (D + 1) + c] =
        gr < Sq ? qb[static_cast<int64_t>(gr) * D + c] * sm_scale : 0.f;
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
      Ks[r * (D + 1) + c] = in ? kb[off] : 0.f;
      Vs[r * D + c] = in ? vb[off] : 0.f;
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
      ob[static_cast<int64_t>(gr) * D + tx + 16 * c] = acc[i][c] / denom;
    // The scores were scaled as Q landed, so m is in natural-log units.
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + gr] = m[i] + logf(denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hk, int Sq, int Sk, int causal, int q_offset,
           float sm_scale, cudaStream_t stream) {
  static bool attr_set[kMaxDevices] = {};
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = set_smem_once(flash_fwd_f32_kernel<D>, smem, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hk, Sq,
      Sk, causal, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// =========================================================== bf16 kernel

namespace bf16 {

using namespace hopper;

constexpr int kBQ = 128;            // query rows per CTA
constexpr int kRowsPerWG = 64;      // query rows per consumer warpgroup
constexpr int kStages = 2;          // K/V ring depth
constexpr int kConsumerWarps = 8;   // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup

// Tiles of swizzle atoms (hopper.cuh), kPadded columns wide (Q and K; V
// and O kVPadded). At D > 128 a stage holds 64 keys: Q (48 KB) and two
// stages of 128-key K and V (4 x 48 KB) would pass the 227 KB a CTA may
// have, and a 64-key score tile (32 registers a thread) and its bf16 copy
// (16) beside the O accumulator (96) keep a consumer near D = 128's 64 +
// 64 + 32.
template <int D, int DV = D>
struct Tile {
  static constexpr int kBK = D > 128 ? 64 : 128;       // keys per K/V stage
  static constexpr int kAtomCols = Atom<D>::kCols;
  static constexpr int kAtomBytes = Atom<D>::kBytes;   // bytes per atom row
  static constexpr int kAtoms = Atom<D>::kCount;
  static constexpr int kPadded = Atom<D>::kPadded;     // columns in smem
  static constexpr uint64_t kLayout = Atom<D>::kLayout;  // wgmma: 128B / 64B
  static constexpr int kVAtomCols = Atom<DV>::kCols;   // V's atoms
  static constexpr int kVAtomBytes = Atom<DV>::kBytes;
  static constexpr int kVAtoms = Atom<DV>::kCount;
  static constexpr int kVPadded = Atom<DV>::kPadded;
  static constexpr uint64_t kVLayout = Atom<DV>::kLayout;
  static constexpr int kMaxAtoms = kAtoms > kVAtoms ? kAtoms : kVAtoms;
  static constexpr uint32_t kQBytes = kBQ * kPadded * 2;
  static constexpr uint32_t kKBytes = kBK * kPadded * 2;   // K, a stage
  static constexpr uint32_t kVBytes = kBK * kVPadded * 2;  // V, a stage
  static constexpr uint32_t kBarrierOffset =
      kQBytes + kStages * (kKBytes + kVBytes);
  // + the barriers, + slack to align the base to 1024 bytes.
  static constexpr size_t kSmem = kBarrierOffset + 64 + 1024;
};

template <int D, int DV = D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int Hk, int Sq, int Sk,
                      int causal, int q_offset, float scale_log2) {
  using T = Tile<D, DV>;
  constexpr int kBK = T::kBK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                               // [atoms][kBQ rows]
  const uint32_t sK = sQ + T::kQBytes;                    // [kStages] tiles
  const uint32_t sV = sK + kStages * T::kKBytes;          // [kStages] tiles
  const uint32_t q_full = base + T::kBarrierOffset;       // then full, empty
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int qt = gridDim.y - 1 - blockIdx.y;   // the heaviest tiles first
  const int bh = blockIdx.x;                    // b * H + h
  const int b = bh / H;
  const int hk = (bh - b * H) / (H / Hk);
  const int q0 = qt * kBQ;
  // Keys past the last one a row of this tile can see are masked for
  // every row: their tiles are never loaded.
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(q0 + kBQ, Sq) + q_offset);
  const int n_tiles = (kv_end + kBK - 1) / kBK;

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
    // Producer warpgroup: gives its registers to the consumers; one
    // thread issues every TMA load of the CTA.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int a = 0; a < T::kAtoms; ++a)
        tma_load_3d(sQ + a * kBQ * T::kAtomBytes, &q_map, q_full,
                    a * T::kAtomCols, q0, bh);
      const int kvh = b * Hk + hk;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full, T::kKBytes + T::kVBytes);
        for (int a = 0; a < T::kMaxAtoms; ++a) {
          if (a < T::kAtoms)
            tma_load_3d(sK + s * T::kKBytes + a * kBK * T::kAtomBytes,
                        &k_map, full, a * T::kAtomCols, t * kBK, kvh);
          if (a < T::kVAtoms)
            tma_load_3d(sV + s * T::kVBytes + a * kBK * T::kVAtomBytes,
                        &v_map, full, a * T::kVAtomCols, t * kBK, kvh);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [row_wg, row_wg + 64); this
  // thread holds rows r0 and r0 + 8 of the accumulator layout.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4;
  const int row_wg = q0 + wg * kRowsPerWG;
  const int r0 = row_wg + 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  constexpr uint32_t kSbo = 8 * T::kAtomBytes;   // between 8-row groups
  const uint32_t q_wg = sQ + wg * kRowsPerWG * T::kAtomBytes;

  // O over V's padded columns: at D = 80 columns 80-127 stay 0 (V's zero
  // fill) and are not stored.
  float acc[T::kVPadded / 2];
#pragma unroll
  for (int i = 0; i < T::kVPadded / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    const uint32_t k_s = sK + s * T::kKBytes;
    const uint32_t v_s = sV + s * T::kVBytes;

    // S = Q K^T over the D real columns in steps of 16 (both operands
    // K-major).
    float sc[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk * 16 / T::kAtomCols) * kBQ * T::kAtomBytes +
                           (kk * 16 % T::kAtomCols) * 2;
      const uint32_t koff = (kk * 16 / T::kAtomCols) * kBK * T::kAtomBytes +
                            (kk * 16 % T::kAtomCols) * 2;
      const uint64_t da = make_desc(q_wg + off, 16, kSbo, T::kLayout);
      const uint64_t db = make_desc(k_s + koff, 16, kSbo, T::kLayout);
      if constexpr (kBK == 128) wgmma_ss_n128(sc, da, db, kk > 0);
      else wgmma_ss_n64(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Online softmax in the accumulator layout: sc[4 j + e] is row
    // r0 + 8 (e / 2), key k0 + 8 j + c0 + e % 2.
    const int k0 = t * kBK;
    if (k0 + kBK > Sk || (causal && k0 + kBK - 1 > row_wg + q_offset)) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + c0 + (e & 1);
          const int qi = r0 + 8 * (e >> 1) + q_offset;
          if (kj >= Sk || (causal && kj > qi)) sc[4 * j + e] = kNegInf;
        }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float corr[2], rsum[2] = {0.f, 0.f}, nm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r] * scale_log2);
      corr[r] = exp2f(m[r] - mn);
      m[r] = mn;
      nm[r] = -mn;
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      sc[i] = exp2f(fmaf(sc[i], scale_log2, nm[(i >> 1) & 1]));
      rsum[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rsum[r];
#pragma unroll
    for (int i = 0; i < T::kVPadded / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V: P as bf16 A fragments in registers (the accumulator layout
    // of S is the A layout of 16-key slices), V MN-major from shared memory.
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<T::kVPadded>(acc, pa[kk],
                  make_desc(v_s + kk * 16 * T::kVAtomBytes,
                            kBK * T::kVAtomBytes, 8 * T::kVAtomBytes,
                            T::kVLayout));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);   // the stage is free
  }

  // Epilogue: row sums across the quad, normalise, store bf16 rows < Sq
  // and their DV real columns.
  __nv_bfloat16* ob = o + static_cast<int64_t>(bh) * Sq * DV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    // m is the running max of the base-2 scaled scores: the natural-log
    // logsumexp is m ln 2 + ln(l).
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<int64_t>(bh) * Sq + row] =
          m[r] * 0.6931471805599453f + logf(fmaxf(lr, 1e-30f));
    __nv_bfloat16* orow = ob + static_cast<int64_t>(row) * DV + c0;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                acc[4 * j + 2 * r + 1] * inv);
  }
}

template <int D, int DV = D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hk, int Sq, int Sk, int causal, int q_offset,
           float sm_scale, cudaStream_t stream) {
  using T = Tile<D, DV>;
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = set_smem_once(flash_fwd_bf16_kernel<D, DV>, T::kSmem,
                                  attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, km, vm;
  int bad = encode<D>(&qm, q, Sq, B * H, kBQ);
  if (!bad) bad = encode<D>(&km, k, Sk, B * Hk, T::kBK);
  if (!bad) bad = encode<DV>(&vm, v, Sk, B * Hk, T::kBK);
  if (bad) return bad;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_bf16_kernel<D, DV><<<grid, kThreads, T::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, H, Hk, Sq, Sk,
      causal, q_offset, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16

}  // namespace

extern "C" {

const char* flash_error_string(int err) { return hopper::error_string(err); }

// Dynamic shared memory of one CTA; dtype 0 = float32, 1 = bfloat16.
int64_t flash_smem_bytes(int dtype, int D) {
  if (dtype == 0) {
    switch (D) {
#define REPRO_ARM(d) case d: return f32::smem_bytes<d>();
      REPRO_HEAD_DIMS(REPRO_ARM)
#undef REPRO_ARM
    }
  } else if (dtype == 1) {
    switch (D) {
#define REPRO_ARM(d) case d: return bf16::Tile<d>::kSmem;
      REPRO_HEAD_DIMS(REPRO_ARM)
#undef REPRO_ARM
    }
  }
  return -1;
}

// Launch the forward on `stream`; dtype 0 = float32 (flash_fwd_f32_kernel),
// 1 = bfloat16 (flash_fwd_bf16_kernel). D is q's and k's head dim, DV v's
// (D, or the value dim of a REPRO_HEAD_DIM_PAIRS pair, bfloat16 only).
// `lse` is null, or (B, H, Sq) fp32 that receives each row's natural-log
// logsumexp of the scaled, masked scores (the backward reads it; serving
// passes null). Returns 0, a cudaError_t, or one of the tensor-map codes
// of flash_error_string.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int dtype, int B, int H, int Hk, int Sq,
                     int Sk, int D, int DV, int causal, int q_offset,
                     float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define REPRO_FLASH_ARGS q, k, v, o, l, B, H, Hk, Sq, Sk, causal, q_offset, sm_scale, s
  if (DV != D) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_PAIR(d, dv) \
    if (D == d && DV == dv) return bf16::launch<d, dv>(REPRO_FLASH_ARGS);
    REPRO_HEAD_DIM_PAIRS(REPRO_PAIR)
#undef REPRO_PAIR
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    switch (D) {
#define REPRO_ARM(d) case d: return f32::launch<d>(REPRO_FLASH_ARGS);
      REPRO_HEAD_DIMS(REPRO_ARM)
#undef REPRO_ARM
    }
  } else if (dtype == 1) {
    switch (D) {
#define REPRO_ARM(d) case d: return bf16::launch<d>(REPRO_FLASH_ARGS);
      REPRO_HEAD_DIMS(REPRO_ARM)
#undef REPRO_ARM
    }
  }
#undef REPRO_FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
