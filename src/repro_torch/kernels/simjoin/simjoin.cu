// Blocked L1 similarity-join kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of repro/kernels/simjoin/simjoin.py:
//   * simjoin_block_counts        (simjoin.py:73)  -> the walker over the
//     implicit dense grid (simjoin_dense_launch);
//   * simjoin_pruned_block_counts (simjoin.py:108) -> the walker over a
//     host-built pair list (simjoin_pruned_launch).
//
// Both count, per 128x128 block pair of two coordinate-major int32 sets
// (a: (k, d, Na), b: (k, d, Nb), padded with +2^20 / -2^20 sentinels so pad
// cells never match), the cell pairs with sum_k |a_ki - b_kj| <= eps; in
// self-join mode only global i < j counts. The dense walker covers every
// (task, block_i, block_j) of the (k, Na/128, Nb/128) output; the pair-list
// walker covers the rows of a (k, P, 3) list of (block_i, block_j, valid)
// and writes count * valid per row (0 for valid == 0 rows, which load
// nothing). A live row naming a block outside the grid traps (__trap), so
// the fault surfaces at the next synchronize; it is never clamped.
//
// What bounds them: instructions per cell pair. A block pair reads
// 2 * d * 128 * 4 bytes and does 128 * 128 cell pairs, so device memory is
// far from the limit; each pair costs d subtractions, d absolute values,
// d - 1 additions, a compare and a count. Hopper dispatches one warp
// instruction per clock per SM partition and has 128 FP32 lanes per SM but
// only 64 INT32 lanes, so the int32 form of that arithmetic runs at half
// the dispatch rate. Second comes the fixed cost of each block pair
// (finding the row, fetching the tiles, reducing the count), which a
// design with one CTA and a barrier per block pair pays in exposed
// latency. The design:
//
//   * Exact fp32 where the tile pair allows. Once a tile has landed in
//     shared memory the warp checks every coordinate of it against +-2^21
//     (the sentinels are +-2^20). When both tiles pass, each |a - b| <= 2^22
//     and any sum of d <= 4 of them is <= 2^24, so every operand and partial
//     sum is an integer that float32 holds exactly: the pair runs as FADDs
//     with the free |x| operand modifier on the FP32 lanes (2d - 1 FADDs,
//     one set.le that yields 1.0f / 0.0f, one FADD into the count: 7
//     instructions at d = 3), compared with min(eps, 2^24) as a float.
//     Otherwise the warp runs the same pair in int32 with two's-complement
//     wrap-around, as the plain version does. Both branches are exact; the
//     check is one vote per tile and needs no host knob.
//   * One warp per block pair, no CTA barrier. A cell is one 16-byte record
//     in shared memory (d <= 4 coordinates, padded), so one 128-bit load
//     gives a b-cell; each lane keeps kR = 8 a-cells in registers (int and
//     float copies; 16 lanes cover the a-tile, the other half of the warp
//     the other half of the b-tile) and reuses every b-record across all 8
//     of them (8 measured faster than 4 at every shape). A warp
//     load touches one or two records: broadcasts, no bank conflicts. Each
//     lane does 512 cell pairs per block pair, so the fixed cost per block
//     pair is a few percent, and warps never wait for one another.
//   * A persistent walker. Resident warps (occupancy times the SM count,
//     queried once per device) each take a contiguous range of the rows.
//     While consecutive rows keep (task, block_i), the a-tile stays in
//     registers and only the next b-tile is fetched, with 4-byte cp.async
//     copies that transpose it into records, into the second of two stage
//     buffers while the current pair is counted. Rows are located by a
//     ballot over 32 rows at a time, so a run of pad rows costs one load
//     per 32 rows. Order only decides reuse: lists need not be sorted.
//   * Self-join. Only a diagonal pair (block_i == block_j) applies the
//     i < j mask; block_i > block_j counts 0 and loads nothing.
//   * Counts. kR independent per-lane counters, one __reduce_add_sync, one
//     store per row by the warp that owns it. No atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;            // cells per block (the TPU kernel's BLOCK)
constexpr int kWarps = 4;              // warps per CTA, each walking alone
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 8;                  // a-cells per lane, in registers
constexpr unsigned kFp32Limit = 1u << 21;       // |coordinate| of the fp32 branch
constexpr float kFp32MaxDist = 16777216.0f;     // 2^24
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;

// One row of the walk, the same in every lane of the warp.
struct Row {
  int idx;      // flat row index into out
  int task;
  int bi;
  int bj;
  int valid;
};

// What a launch walks: the stacks, the grid and the row source.
struct Walk {
  const int32_t* a;
  const int32_t* b;
  const int32_t* pairs;   // (k, P, 3) rows; null for the dense grid
  long long na;
  long long nb;
  int nab;                // Na / 128
  int nbb;                // Nb / 128
  int per;                // rows per task: P, or nab * nbb
  int total;              // k * per
  int warps;              // walking warps: warp w takes rows
                          // [w * total / warps, (w + 1) * total / warps)
  int same;
};

// One warp's shared memory: two b-tile stages (int records, or float
// records once converted) and the a-tile of the next new (task, block_i).
struct WarpTiles {
  int4 b[2][kBlock];
  int4 a[kBlock];
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// -2^21 <= v <= 2^21, without overflow for any int32.
__device__ __forceinline__ bool fits_fp32(int v) {
  return static_cast<unsigned>(v) + kFp32Limit <= 2u * kFp32Limit;
}

// 1.0f when x <= y, else 0.0f (one FSET).
__device__ __forceinline__ float le_one(float x, float y) {
  float r;
  asm("set.le.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

// |x - y| of two int32s with two's-complement wrap-around (as int32 tensor
// arithmetic does), as the bits of an unsigned.
__device__ __forceinline__ unsigned abs_diff(int x, int y) {
  const int t = static_cast<int>(static_cast<unsigned>(x) -
                                 static_cast<unsigned>(y));
  return t < 0 ? 0u - static_cast<unsigned>(t) : static_cast<unsigned>(t);
}

// Row idx of the walk. Returns whether it has work: valid != 0 and not a
// self-join pair below the diagonal. A live list row outside the grid traps.
template <bool DENSE>
__device__ __forceinline__ bool row_at(const Walk& w, int idx, Row& r) {
  r.idx = idx;
  r.task = static_cast<unsigned>(idx) / static_cast<unsigned>(w.per);
  const int rem = idx - r.task * w.per;
  if (DENSE) {
    r.bi = static_cast<unsigned>(rem) / static_cast<unsigned>(w.nbb);
    r.bj = rem - r.bi * w.nbb;
    r.valid = 1;
  } else {
    const int32_t* p = w.pairs + 3ll * idx;
    r.bi = p[0];
    r.bj = p[1];
    r.valid = p[2];
    if (r.valid == 0) return false;
    if (static_cast<unsigned>(r.bi) >= static_cast<unsigned>(w.nab) ||
        static_cast<unsigned>(r.bj) >= static_cast<unsigned>(w.nbb))
      __trap();
  }
  return !(w.same && r.bi > r.bj);
}

// The first row with work in [from, end), the same in every lane; the warp
// looks at 32 rows per step and stores count 0 for the rows without work
// that it passes. Returns idx == end when there is none.
template <bool DENSE>
__device__ Row next_live(const Walk& w, int from, int end,
                         int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int base = from; base < end; base += 32) {
    const int idx = base + lane;
    Row r = {idx, 0, 0, 0, 0};
    const bool live = idx < end && row_at<DENSE>(w, idx, r);
    const unsigned mask = __ballot_sync(kAll, live);
    const int first = mask ? __ffs(mask) - 1 : 32;
    if (idx < end && lane < first) out[idx] = 0;
    if (mask) {
      Row got;
      got.idx = base + first;
      got.task = __shfl_sync(kAll, r.task, first);
      got.bi = __shfl_sync(kAll, r.bi, first);
      got.bj = __shfl_sync(kAll, r.bj, first);
      got.valid = __shfl_sync(kAll, r.valid, first);
      return got;
    }
  }
  Row none = {end, 0, 0, 0, 0};
  return none;
}

// Start the copies of a row's b-tile (and a-tile): element e of the
// (d, 128) tile goes to coordinate e / 128 of record e % 128.
template <int D>
__device__ __forceinline__ void fetch(const Walk& w, const Row& r, int4* bt,
                                      int4* at, bool with_a) {
  const int lane = threadIdx.x & 31;
  const int32_t* bsrc = w.b + static_cast<long long>(r.task) * D * w.nb +
                        static_cast<long long>(r.bj) * kBlock;
  const int32_t* asrc = w.a + static_cast<long long>(r.task) * D * w.na +
                        static_cast<long long>(r.bi) * kBlock;
#pragma unroll
  for (int m = 0; m < 4 * D; ++m) {
    const int e = lane + 32 * m;
    const int k = e / kBlock;
    const int c = e % kBlock;
    cp_async4(reinterpret_cast<int*>(&bt[c]) + k, bsrc + k * w.nb + c);
    if (with_a)
      cp_async4(reinterpret_cast<int*>(&at[c]) + k, asrc + k * w.na + c);
  }
}

// This lane's matches of one block pair, fp32 branch: lane (g, s) pairs
// a-cells g + AG * r (r < kR) with b-cells s + BS * j.
template <int D, bool DIAG>
__device__ __forceinline__ int count_f32(const float (&af)[kR][D],
                                         const float4* __restrict__ bf,
                                         int g, int s, float epsf) {
  constexpr int AG = kBlock / kR;
  constexpr int BS = 32 / AG;
  constexpr int JB = kBlock / BS;
  float c[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) c[r] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < JB; ++j) {
    const int jb = s + BS * j;
    const float4 v = bf[jb];
    const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float dist = fabsf(af[r][0] - bv[0]);
#pragma unroll
      for (int k = 1; k < D; ++k) dist += fabsf(af[r][k] - bv[k]);
      const float hit = le_one(dist, epsf);
      c[r] += DIAG ? (g + AG * r < jb ? hit : 0.0f) : hit;
    }
  }
  float t = 0.0f;
#pragma unroll
  for (int r = 0; r < kR; ++r) t += c[r];
  return static_cast<int>(t);
}

// The same in int32 (any coordinates), with the plain version's wrap-around.
template <int D, bool DIAG>
__device__ __forceinline__ int count_i32(const int (&ai)[kR][D],
                                         const int4* __restrict__ bi,
                                         int g, int s, int eps) {
  constexpr int AG = kBlock / kR;
  constexpr int BS = 32 / AG;
  constexpr int JB = kBlock / BS;
  int c[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) c[r] = 0;
#pragma unroll 4
  for (int j = 0; j < JB; ++j) {
    const int jb = s + BS * j;
    const int4 v = bi[jb];
    const int bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      unsigned dist = abs_diff(ai[r][0], bv[0]);
#pragma unroll
      for (int k = 1; k < D; ++k) dist += abs_diff(ai[r][k], bv[k]);
      bool hit = static_cast<int>(dist) <= eps;
      if (DIAG) hit = hit && (g + AG * r < jb);
      c[r] += hit ? 1 : 0;
    }
  }
  int t = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) t += c[r];
  return t;
}

// The walker: warp w of the launch counts rows
// [w * total / warps, (w + 1) * total / warps) on its own.
template <int D, bool DENSE>
__global__ void __launch_bounds__(kThreads)
simjoin_walk_kernel(const Walk w, int32_t* __restrict__ out, int eps) {
  constexpr int AG = kBlock / kR;
  __shared__ WarpTiles tiles[kWarps];
  const int lane = threadIdx.x & 31;
  const int g = lane % AG;
  const int s = lane / AG;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= w.warps) return;                 // whole warps only
  WarpTiles& t = tiles[threadIdx.x >> 5];
  const int begin = static_cast<int>(static_cast<long long>(w.total) * warp /
                                     w.warps);
  const int end = static_cast<int>(static_cast<long long>(w.total) *
                                   (warp + 1) / w.warps);
  Row cur = next_live<DENSE>(w, begin, end, out);
  if (cur.idx >= end) return;
  fetch<D>(w, cur, t.b[0], t.a, true);
  cp_async_commit();

  const float epsf = eps >= (1 << 24) ? kFp32MaxDist : static_cast<float>(eps);
  int ai[kR][D];
  float af[kR][D];
  bool fits_a = false;
  bool a_new = true;
  int stage = 0;
  for (;;) {
    cp_async_wait_all();                       // this row's tiles, own copies
    __syncwarp();                              // ... and every lane's
    if (a_new) {
      bool ok = true;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int4 v = t.a[g + AG * r];
        const int vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < D; ++k) {
          ai[r][k] = vv[k];
          af[r][k] = static_cast<float>(vv[k]);
          ok = ok && fits_fp32(vv[k]);
        }
      }
      fits_a = __all_sync(kAll, ok);
    }
    int4* bt = t.b[stage];
    int4 own[kBlock / 32];                     // records lane + 32 m
    bool ok = true;
#pragma unroll
    for (int m = 0; m < kBlock / 32; ++m) {
      own[m] = bt[lane + 32 * m];
      const int vv[4] = {own[m].x, own[m].y, own[m].z, own[m].w};
#pragma unroll
      for (int k = 0; k < D; ++k) ok = ok && fits_fp32(vv[k]);
    }
    const bool fp32 = __all_sync(kAll, ok) && fits_a;
    const Row nxt = next_live<DENSE>(w, cur.idx + 1, end, out);
    const bool has_next = nxt.idx < end;
    const bool next_a = has_next && (nxt.task != cur.task || nxt.bi != cur.bi);
    __syncwarp();                              // t.a read by every lane
    if (has_next) {                            // the other stage is free
      fetch<D>(w, nxt, t.b[stage ^ 1], t.a, next_a);
      cp_async_commit();
    }
    if (fp32) {                                // this stage as float records
#pragma unroll
      for (int m = 0; m < kBlock / 32; ++m)
        reinterpret_cast<float4*>(bt)[lane + 32 * m] = make_float4(
            static_cast<float>(own[m].x), static_cast<float>(own[m].y),
            static_cast<float>(own[m].z), static_cast<float>(own[m].w));
      __syncwarp();
    }
    const bool diag = w.same && cur.bi == cur.bj;
    const float4* bf = reinterpret_cast<const float4*>(bt);
    int mine;
    if (fp32)
      mine = diag ? count_f32<D, true>(af, bf, g, s, epsf)
                  : count_f32<D, false>(af, bf, g, s, epsf);
    else
      mine = diag ? count_i32<D, true>(ai, bt, g, s, eps)
                  : count_i32<D, false>(ai, bt, g, s, eps);
    const unsigned total = __reduce_add_sync(kAll, static_cast<unsigned>(mine));
    if (lane == 0)
      out[cur.idx] = static_cast<int>(total * static_cast<unsigned>(cur.valid));
    if (!has_next) break;
    cur = nxt;
    stage ^= 1;
    a_new = next_a;
  }
}

// Walking warps per launch at most: resident CTAs per SM times the SM count
// times kWarps, queried once per (device, kernel); < 0 is a CUDA error code.
template <int D, bool DENSE>
int warp_cap() {
  static int cap[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev >= 0 && dev < kMaxDevices && cap[dev] > 0) return cap[dev];
  int sms = 0;
  int per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, simjoin_walk_kernel<D, DENSE>, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int n = sms * (per_sm > 0 ? per_sm : 1) * kWarps;
  if (dev >= 0 && dev < kMaxDevices) cap[dev] = n;
  return n;
}

template <int D, bool DENSE>
int launch_walk(Walk w, int32_t* out, int eps, cudaStream_t stream) {
  const int cap = warp_cap<D, DENSE>();
  if (cap < 0) return -cap;
  w.warps = w.total < cap ? w.total : cap;
  const int grid = (w.warps + kWarps - 1) / kWarps;
  simjoin_walk_kernel<D, DENSE><<<grid, kThreads, 0, stream>>>(w, out, eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool DENSE>
int dispatch(const Walk& w, int d, int32_t* out, int eps,
             cudaStream_t stream) {
  if (w.total <= 0) return 0;
  switch (d) {
    case 1: return launch_walk<1, DENSE>(w, out, eps, stream);
    case 2: return launch_walk<2, DENSE>(w, out, eps, stream);
    case 3: return launch_walk<3, DENSE>(w, out, eps, stream);
    case 4: return launch_walk<4, DENSE>(w, out, eps, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Walk make_walk(const int32_t* a, const int32_t* b, const int32_t* pairs,
               int64_t k, int64_t na, int64_t nb, int64_t per, int same) {
  Walk w;
  w.a = a;
  w.b = b;
  w.pairs = pairs;
  w.na = na;
  w.nb = nb;
  w.nab = static_cast<int>(na / kBlock);
  w.nbb = static_cast<int>(nb / kBlock);
  w.per = static_cast<int>(per);
  w.total = static_cast<int>(k * per);
  w.warps = 0;
  w.same = same;
  return w;
}

}  // namespace

extern "C" {

const char* simjoin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The dense grid: out (k, Na/128, Nb/128) int32. Returns
// cudaGetLastError() (0 = ok).
int simjoin_dense_launch(const int32_t* a, const int32_t* b, int32_t* out,
                         int64_t k, int64_t d, int64_t na, int64_t nb,
                         int eps, int same, void* stream) {
  const Walk w = make_walk(a, b, nullptr, k, na, nb,
                           (na / kBlock) * (nb / kBlock), same);
  return dispatch<true>(w, static_cast<int>(d), out, eps,
                        static_cast<cudaStream_t>(stream));
}

// The pair list: pairs (k, P, 3) int32, out (k, P) int32.
int simjoin_pruned_launch(const int32_t* a, const int32_t* b,
                          const int32_t* pairs, int32_t* out, int64_t k,
                          int64_t d, int64_t na, int64_t nb, int64_t n_pairs,
                          int eps, int same, void* stream) {
  const Walk w = make_walk(a, b, pairs, k, na, nb, n_pairs, same);
  return dispatch<false>(w, static_cast<int>(d), out, eps,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
