// The beam engine's entry-point draw: starts i32[L, S] for L lanes.
//
// Replaces no Pallas kernel. JAX draws entry points in plain jnp
// (src/repro/core/search.py, entry_points and batch_entry_points):
// jax.random.gumbel over every slot, then lax.top_k, vmapped over the lanes'
// keys fold_in(key, offset + i). Gumbel is monotone in the uniform draw, so
// the port ranks the uniform draw's 23-bit mantissa, exact on every device
// (kernels/ref.py::entry_draw is that plain version, the elementwise chain
// this kernel replaces: ~150 int32 ops, each writing a [lanes, capacity]
// tensor, then a radix top-k).
//
// What it computes, for each lane i (original index, not its rank among the
// active lanes): the lane key is fold_in(key, offset + i) = threefry2x32(key,
// (0, offset + i)), or key itself when fold is 0. For each present slot j,
// m = ((b0 ^ b1) >> 9) with (b0, b1) = threefry2x32(lane key, (0, j)); the
// lane's starts are its num_starts present slots by (m desc, j asc), then
// NULL (-1) where fewer are present. Lanes whose active flag is 0 get a row
// of NULL and draw nothing. Absent slots cannot be returned, so their
// threefry is skipped: the same output, not left-out work.
//
// Bound on this card: int32 operations. A slot costs 74 of them (20 rounds
// of add, rotate and xor, 10 key injections, the counter's add, the
// mantissa's xor and shift, the threshold compare) against one byte of
// `present` read; at L 512 and 2^20 slots that is 4.0e10 operations, 1.2 ms
// at the int32 peak of launch/analysis.py (an SM issues 64 lanes a clock on
// its ALU pipe and 64 integer adds, as IMAD, on its FMA pipe), and 1 MB of
// reads. The rotates and xors run on the ALU pipe alone, so the 43 ALU-only
// operations of a slot put the floor near 1.3 ms. Written as elementwise
// ops each intermediate went through HBM; here nothing as wide as
// lanes x capacity is written:
//   * tiling: a block of kWarps warps owns `lanes_per_warp` lanes (a group
//     of the active lanes, compacted in the block by a ballot scan of the
//     active flags) and a tile of `tile` slots, each warp a contiguous
//     tile / kWarps of them. A warp reads the present flags of 32 slots with
//     one coalesced byte load and a ballot, and draws only the set bits. At
//     32 lanes a warp (L >= 32) every thread is a lane and all walk the same
//     slots: control flow stays uniform, a missing slot costs nothing, and
//     the flags are read once for 32 lanes. Fewer lanes give each lane
//     32 / lanes_per_warp threads that split the slots by phase, so L = 1
//     still fills a warp.
//   * shape: kernels/ops.py::entry_plan takes lanes_per_warp as the power of
//     two covering L (at most 32) and doubles the tile from kMinTile while
//     the grid keeps 16 blocks a SM: (512, 2^20) runs 16 lane groups x 256
//     tiles of 4,096 slots, (4,096, 2^20) 128 x 32 tiles of 32,768, (1,
//     2^17) 1 x 256 tiles of 512. Groups past the active count exit.
//   * top-S: each thread keeps its lane's running top NS (the power of two
//     >= S) as 64-bit keys (m << 32 | ~j; 0 is empty) sorted in registers,
//     with the S-th key's m as a threshold, so a draw costs one compare
//     unless it enters the list. The threads of one lane merge by xor
//     shuffles, the warps of the block through shared memory, and the block
//     writes S keys a lane to the int64 scratch (lanes x tiles x S). Pass 2
//     (draw_merge) merges a lane's tiles with one warp and writes its row.
// The keys are unique per lane (one a slot), so every merge is exact and
// the result does not depend on the order candidates arrive in.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStarts = 16;   // largest S
constexpr int kWarps = 8;        // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinTile = 512;    // slots a tile, at least (2 ballots a warp)
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;

// Threefry-2x32 with 20 rounds (jax.random's block function) on (x0, x1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

// The uniform draw's mantissa of slot j under the lane key (k0, k1).
__device__ __forceinline__ uint32_t mantissa(uint32_t k0, uint32_t k1, uint32_t j) {
  uint32_t x0 = 0u, x1 = j;
  threefry(k0, k1, x0, x1);
  return (x0 ^ x1) >> 9;
}

// Insert a key into a list sorted descending (0 = empty), dropping the
// smallest; keys already below the last entry change nothing.
template <int NS>
__device__ __forceinline__ void insert(unsigned long long (&v)[NS], unsigned long long key) {
  if (key <= v[NS - 1]) return;
#pragma unroll
  for (int i = NS - 1; i > 0; --i) v[i] = key > v[i - 1] ? v[i - 1] : (key > v[i] ? key : v[i]);
  v[0] = key > v[0] ? key : v[0];
}

// Offer slot j with mantissa m to the thread's list; thr is the m that the
// list's last key holds, below which no slot can enter.
template <int NS>
__device__ __forceinline__ void offer(unsigned long long (&best)[NS], uint32_t& thr,
                                      uint32_t m, uint32_t j) {
  if (m >= thr) {
    insert<NS>(best, (static_cast<unsigned long long>(m) << 32) | static_cast<uint32_t>(~j));
    thr = static_cast<uint32_t>(best[NS - 1] >> 32);
  }
}

template <int NS>
__global__ void __launch_bounds__(kThreads)
draw_partial(const unsigned char* __restrict__ present, const long long* __restrict__ key,
             uint32_t key0, uint32_t key1, const unsigned char* __restrict__ active,
             unsigned long long* __restrict__ partial, int* __restrict__ lane_pos, int cap,
             int L, int S, uint32_t offset, int fold, int wl, int tile, int tiles) {
  __shared__ int s_lane[32];
  __shared__ int s_count[kWarps];
  __shared__ unsigned long long s_part[kWarps][32][NS];
  const int t = threadIdx.x, x = t & 31, w = t >> 5;
  const int lo = blockIdx.y * wl;          // the group's first position

  // ---- the group's lanes: positions lo .. lo + wl - 1 among the active ----
  if (t < 32) s_lane[t] = -1;
  if (active == nullptr) {
    if (t < wl && lo + t < L) s_lane[t] = lo + t;
  } else {
    __syncthreads();
    int base = 0;                          // active lanes before this chunk
    for (int c0 = 0; c0 < L && base < lo + wl; c0 += kThreads) {
      const int r = c0 + t;
      const bool a = r < L && active[r];
      const unsigned ball = __ballot_sync(0xffffffffu, a);
      if (x == 0) s_count[w] = __popc(ball);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        before += v < w ? s_count[v] : 0;
        total += s_count[v];
      }
      const int rank = base + before + __popc(ball & ((1u << x) - 1u));
      if (a && rank >= lo && rank < lo + wl) s_lane[rank - lo] = r;
      base += total;
      __syncthreads();
    }
  }
  __syncthreads();
  if (s_lane[0] < 0) return;               // no active lane at these positions

  const int pw = 32 / wl;                  // threads a lane within a warp
  const int local = x % wl, phase = x / wl;
  const int r = s_lane[local];
  if (active != nullptr && blockIdx.x == 0 && w == 0 && phase == 0 && r >= 0)
    lane_pos[r] = lo + local;
  uint32_t k0 = key ? static_cast<uint32_t>(key[0]) : key0;
  uint32_t k1 = key ? static_cast<uint32_t>(key[1]) : key1;
  if (fold) {
    uint32_t f0 = 0u, f1 = offset + static_cast<uint32_t>(r);
    threefry(k0, k1, f0, f1);
    k0 = f0;
    k1 = f1;
  }
  uint32_t mine = 0u;                      // the chunk bits this thread draws
  for (int b = phase; b < 32; b += pw) mine |= 1u << b;
  if (r < 0) mine = 0u;

  unsigned long long best[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) best[i] = 0ull;
  uint32_t thr = 0u;
  const int span = tile / kWarps;
  const int w0 = blockIdx.x * tile + w * span;
  const int w1 = min(cap, w0 + span);
  bool flag = w0 + x < w1 && present[w0 + x];
  for (int j0 = w0; j0 < w1; j0 += 32) {
    uint32_t bits = __ballot_sync(0xffffffffu, flag) & mine;
    const int jn = j0 + 32 + x;
    flag = jn < w1 && present[jn];         // the next chunk's flag, in flight
    if (bits == 0xffffffffu) {
      // a full chunk at 32 lanes a warp: 8 independent threefry chains at
      // a time, then their 8 offers
      for (int b0 = 0; b0 < 32; b0 += 8) {
        uint32_t m[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) m[u] = mantissa(k0, k1, j0 + b0 + u);
#pragma unroll
        for (int u = 0; u < 8; ++u) offer<NS>(best, thr, m[u], j0 + b0 + u);
      }
    } else {
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        offer<NS>(best, thr, mantissa(k0, k1, j0 + b), j0 + b);
      }
    }
  }

  // ---- merge: the threads of a lane (xor shuffles), then the warps ----
  for (int off = wl; off < 32; off <<= 1) {
    unsigned long long other[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) other[i] = __shfl_xor_sync(0xffffffffu, best[i], off);
#pragma unroll
    for (int i = 0; i < NS; ++i) insert<NS>(best, other[i]);
  }
  if (phase == 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) s_part[w][local][i] = best[i];
  }
  __syncthreads();
  if (w == 0 && phase == 0 && r >= 0) {
    for (int v = 1; v < kWarps; ++v) {
#pragma unroll
      for (int i = 0; i < NS; ++i) insert<NS>(best, s_part[v][local][i]);
    }
    unsigned long long* dst = partial + ((size_t)(lo + local) * tiles + blockIdx.x) * S;
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (i < S) dst[i] = best[i];
  }
}

// Pass 2: one warp a lane (original index) merges the lane's tiles' keys
// and writes its row of starts; inactive lanes get NULL.
template <int NS>
__global__ void __launch_bounds__(kThreads)
draw_merge(const unsigned long long* __restrict__ partial, const int* __restrict__ lane_pos,
           const unsigned char* __restrict__ active, int* __restrict__ out, int L, int S,
           int tiles) {
  const int x = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= L) return;
  int* row = out + (size_t)r * S;
  if (active != nullptr && !active[r]) {
    if (x < S) row[x] = -1;
    return;
  }
  const int p = active != nullptr ? lane_pos[r] : r;
  const unsigned long long* src = partial + (size_t)p * tiles * S;
  unsigned long long best[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) best[i] = 0ull;
  for (int e = x; e < tiles * S; e += 32) insert<NS>(best, src[e]);
  for (int off = 1; off < 32; off <<= 1) {
    unsigned long long other[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) other[i] = __shfl_xor_sync(0xffffffffu, best[i], off);
#pragma unroll
    for (int i = 0; i < NS; ++i) insert<NS>(best, other[i]);
  }
  unsigned long long mine = 0ull;
#pragma unroll
  for (int i = 0; i < NS; ++i)
    if (i == x) mine = best[i];
  if (x < S) row[x] = mine ? static_cast<int>(~static_cast<uint32_t>(mine)) : -1;
}

template <int NS>
int launch(const unsigned char* present, const long long* key, uint32_t key0, uint32_t key1,
           const unsigned char* active, long long* scratch, int* out, int cap, int L, int S,
           uint32_t offset, int fold, int wl, int tile, cudaStream_t st) {
  const int tiles = (cap + tile - 1) / tile;
  const int groups = (L + wl - 1) / wl;
  unsigned long long* partial = reinterpret_cast<unsigned long long*>(scratch);
  int* lane_pos = reinterpret_cast<int*>(partial + (size_t)L * tiles * S);
  draw_partial<NS><<<dim3(tiles, groups), kThreads, 0, st>>>(
      present, key, key0, key1, active, partial, lane_pos, cap, L, S, offset, fold, wl, tile,
      tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  draw_merge<NS><<<(L + kWarps - 1) / kWarps, kThreads, 0, st>>>(partial, lane_pos, active,
                                                                  out, L, S, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The key's two words are read on the device from key (int64[2]), or,
// where key is NULL, taken from key0 and key1 (a key the host holds; the
// uint32 words' bits). scratch: int64, L * ceil(capacity / tile) * starts
// keys, then L int32 lane positions (kernels/ops.py::entry_scratch).
// active may be NULL (all lanes draw). offset is the uint32 lane offset's
// bits.
extern "C" int entry_draw(const unsigned char* present, const long long* key, int key0,
                          int key1, const unsigned char* active, long long* scratch,
                          int* out, int capacity, int lanes, int starts, int offset, int fold,
                          int lanes_per_warp, int tile, void* stream) {
  if (capacity < 1 || lanes < 1 || starts < 1 || starts > kMaxStarts ||
      lanes_per_warp < 1 || lanes_per_warp > 32 || (lanes_per_warp & (lanes_per_warp - 1)) ||
      tile < kMinTile || tile % kThreads != 0 ||
      (lanes + lanes_per_warp - 1) / lanes_per_warp > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t off = static_cast<uint32_t>(offset);
  const uint32_t k0 = static_cast<uint32_t>(key0), k1 = static_cast<uint32_t>(key1);
  const auto run = starts == 1 ? launch<1> : starts == 2 ? launch<2> : starts <= 4 ? launch<4>
                  : starts <= 8 ? launch<8> : launch<16>;
  return run(present, key, k0, k1, active, scratch, out, capacity, lanes, starts, off, fold,
             lanes_per_warp, tile, st);
}
