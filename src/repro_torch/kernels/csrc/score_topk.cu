// Fused brute-force scoring + top-k: (scores f32[B,k], ids i32[B,k]).
//
// Replaces score_topk_pallas in src/repro/kernels/distance_matrix.py (body
// _topk_kernel with its _iter_topk merge). For every query b the k best rows
// of x[0:n_valid] by score (l2: 2<x,q> - xsq, ip/cos: <x,q>), ordered by
// score descending with ties to the lowest id; missing entries are
// (-inf, -1). The [B, M] score matrix is never written.
//
// Bound on this card: fp32 operations, 2*B*M*d FLOPs on the CUDA cores (no
// TF32: the ids must equal the fp32 reference) against (B + M)*d*4 bytes
// read; at B = 1,000, M = 2^20, d = 128 that is 4.0 ms of FMA against
// 0.16 ms of HBM. The design keeps the product near the rate that shared
// memory lets an fp32 tile reach and makes the top-k cheap beside it:
//   * product tile: a block owns QT = 128 queries (64 when k > 70, for
//     shared memory) and walks its row range in tiles of 128 rows. Each of
//     its 2*QT threads holds an 8 x 8 register micro-tile (queries ty*4+i and
//     QT/2+ty*4+i, rows tx*4+j and 64+tx*4+j), so 4 float4 shared loads feed
//     64 FMAs. d is staged in chunks of 16, transposed to [k][row] by 4-byte
//     cp.async copies (no staging registers; rows padded by 4 floats, so a
//     warp's copies put at most two on a bank), double-buffered across tile
//     boundaries: the next chunk is in flight while this one computes, one
//     __syncthreads per chunk. Launch bounds and shared memory keep two blocks on an SM, so
//     one block's product hides the other's top-k phase. The query tile
//     index varies fastest in the grid, so the blocks resident at one time
//     stream the same rows of x and share them through L2.
//   * epilogue: xsq arrives with the tile (cp.async); l2 is
//     __fsub_rn(__fmul_rn(2, acc), xsq) (no contraction, so integer data
//     stay byte-equal to the plain version); rows at n_valid or above never
//     become candidates.
//   * top-k by threshold filter: each query's running top-k stays sorted in
//     dynamic shared memory sized by the actual k. A thread takes the max
//     of its 8 scores of a query and, only when that reaches the query's
//     k-th entry, compares each under the total order (score desc, id asc)
//     and appends those that beat it to a per-query buffer of 8. Buffers are
//     folded into the lists only when one overflows (then the tile's
//     remaining candidates are filtered again against the new thresholds)
//     and once at the end; a fold merges each buffer in one warp step
//     (binary search of the list plus a rank count over the buffer). Lists
//     change only between barriers and only upward, so a threshold is never
//     higher than the list it guards; an old one only admits extra
//     candidates. Once a list is full, about k*ln(M/k) candidates per query
//     pass, so folds are rare after the first tiles.
//   * splits: at small B the query tiles alone cannot fill 132 SMs, so the
//     rows are split across `splits` blocks per query tile (ops.topk_splits
//     picks a count that fills the last wave of resident blocks); pass 2
//     (topk_merge) merges the partial lists of each query with the same
//     warp step. With one split pass 1 writes the output.
// The comparison (score desc, id asc) is a total order on the candidates
// (ids are unique), so the result does not depend on arrival order.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RT = 128;         // rows per tile
constexpr int DK = 16;          // dims per staged chunk
constexpr int PAD = 4;          // staged row padding (floats)
constexpr int CAP = 8;          // candidate buffer per query (<= 32)
constexpr int KMAX = 128;       // largest supported k
constexpr int kWideMaxK = 70;   // QT = 128 up to this k, else QT = 64

__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Merge c <= 32 candidates, one per lane below c ((-inf, -1) in the other
// lanes), into the sorted list (ls, li) of length k in one step. An element's
// new place is the number of list entries and candidates better than it
// (a total order on unique ids, so places are distinct); those at k or
// beyond drop out. Entries better than a candidate are a prefix of the list,
// so a binary search counts them.
__device__ __forceinline__ void warp_merge(float* ls, int* li, int k, float cs,
                                           int ci, int c, int lane) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(ls[mid], li[mid], cs, ci)) lo = mid + 1; else hi = mid;
  }
  int pos = lo;
  float ev[KMAX / 32];
  int ei[KMAX / 32], pe[KMAX / 32];
#pragma unroll
  for (int n = 0; n < KMAX / 32; ++n) {
    const int e = lane + 32 * n;
    ev[n] = e < k ? ls[e] : -INFINITY;
    ei[n] = e < k ? li[e] : -1;
    pe[n] = e;
  }
  for (int m = 0; m < c; ++m) {
    const float s = __shfl_sync(0xffffffffu, cs, m);
    const int i = __shfl_sync(0xffffffffu, ci, m);
    pos += better(s, i, cs, ci) ? 1 : 0;
#pragma unroll
    for (int n = 0; n < KMAX / 32; ++n) pe[n] += better(s, i, ev[n], ei[n]) ? 1 : 0;
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < KMAX / 32; ++n) {
    if (lane + 32 * n < k && pe[n] < k) { ls[pe[n]] = ev[n]; li[pe[n]] = ei[n]; }
  }
  if (ci >= 0 && pos < k) { ls[pos] = cs; li[pos] = ci; }
  __syncwarp();
}

// Copy one float from device memory to shared memory without passing it
// through registers; a copy with valid == false writes 0.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0));
}

// Dynamic shared memory of topk_partial<QT> at k.
__host__ __device__ constexpr size_t dyn_bytes(int qt, int k) {
  return (size_t)qt * k * 8 + (size_t)qt * CAP * 8 + (size_t)qt * 4 + 16;
}

template <int QT>
__global__ void __launch_bounds__(2 * QT, 2)
topk_partial(const float* __restrict__ x, const float* __restrict__ xsq,
             const float* __restrict__ q, float* __restrict__ out_s,
             int* __restrict__ out_i, int d, int B, int k, int m_limit,
             int metric, int rows_per_split) {
  constexpr int THREADS = 2 * QT;
  constexpr int NWARPS = THREADS / 32;
  static_assert(QT * DK % THREADS == 0 && RT * DK % THREADS == 0, "staging");
  __shared__ __align__(16) float qs[2][DK][QT + PAD];
  __shared__ __align__(16) float xs[2][DK][RT + PAD];
  __shared__ __align__(16) float xq[2][RT];     // xsq of the tile (l2)
  extern __shared__ __align__(16) unsigned char dyn[];
  float* ls = reinterpret_cast<float*>(dyn);          // [QT][k]
  int* li = reinterpret_cast<int*>(ls + QT * k);        // [QT][k]
  float* bs = reinterpret_cast<float*>(li + QT * k);    // [QT][CAP]
  int* bi = reinterpret_cast<int*>(bs + QT * CAP);      // [QT][CAP]
  int* cnt = bi + QT * CAP;                             // [QT]
  int* over = cnt + QT;      // last filter pass that found a buffer full

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tx = t % 16;
  const int ty = t / 16;
  const int b0 = blockIdx.x * QT;
  const int m_begin = blockIdx.y * rows_per_split;
  const int m_end = min(m_limit, m_begin + rows_per_split);

  for (int e = t; e < QT * k; e += THREADS) { ls[e] = -INFINITY; li[e] = -1; }
  for (int e = t; e < QT; e += THREADS) cnt[e] = 0;
  if (t == 0) *over = -1;
  int pass = 0;   // filter passes so far, the same count in every thread

  const int nchunks = (d + DK - 1) / DK;
  const int ntiles = m_end > m_begin ? (m_end - m_begin + RT - 1) / RT : 0;
  const int total = ntiles * nchunks;

  // staging: element (row r, dim k0 + t % DK) of each operand tile goes to
  // s[k][r] by cp.async; a warp reads two rows x 64 bytes
  auto stage = [&](int step, int buf) {
    const int m0 = m_begin + (step / nchunks) * RT;
    const int c = t % DK, gc = (step % nchunks) * DK + c;
#pragma unroll
    for (int u = 0; u < QT * DK / THREADS; ++u) {
      const int r = t / DK + u * (THREADS / DK);
      const bool ok = gc < d && b0 + r < B;
      cp_async4(&qs[buf][c][r], ok ? q + (size_t)(b0 + r) * d + gc : q, ok);
    }
#pragma unroll
    for (int u = 0; u < RT * DK / THREADS; ++u) {
      const int r = t / DK + u * (THREADS / DK);
      const bool ok = gc < d && m0 + r < m_end;
      cp_async4(&xs[buf][c][r], ok ? x + (size_t)(m0 + r) * d + gc : x, ok);
    }
    if (step % nchunks == 0 && t < RT) {   // a new tile: its xsq too
      const bool ok = metric == 0 && m0 + t < m_end;
      cp_async4(&xq[(step / nchunks) & 1][t], ok ? xsq + m0 + t : xsq, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (total > 0) stage(0, 0);

  // merge every query's buffered candidates into its list (warp w takes
  // queries w, w + NWARPS, ...) and empty the buffers
  auto fold = [&](int w, int ln) {
    for (int qi = w; qi < QT; qi += NWARPS) {
      const int c = min(cnt[qi], CAP);
      if (c == 0) continue;
      const bool ok = ln < c;   // c <= CAP <= 32: one merge per list
      warp_merge(ls + qi * k, li + qi * k, k, ok ? bs[qi * CAP + ln] : -INFINITY,
                 ok ? bi[qi * CAP + ln] : -1, c, ln);
      if (ln == 0) cnt[qi] = 0;
    }
  };

  for (int tile = 0; tile < ntiles; ++tile) {
    const int m0 = m_begin + tile * RT;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c = 0; c < nchunks; ++c) {
      const int step = tile * nchunks + c;
      const int buf = step & 1;
      // this step's chunk has landed, and every thread is done with the
      // other buffer (read at the previous step): refill it meanwhile
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      if (step + 1 < total) stage(step + 1, buf ^ 1);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&qs[buf][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&qs[buf][kk][QT / 2 + ty * 4]);
        const float4 c0 = *reinterpret_cast<const float4*>(&xs[buf][kk][tx * 4]);
        const float4 c1 = *reinterpret_cast<const float4*>(&xs[buf][kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }

    // ---- threshold filter; fold only when a buffer overflowed ----
    const float4 sq0 = *reinterpret_cast<const float4*>(&xq[tile & 1][tx * 4]);
    const float4 sq1 = *reinterpret_cast<const float4*>(&xq[tile & 1][64 + tx * 4]);
    const float sq[8] = {sq0.x, sq0.y, sq0.z, sq0.w, sq1.x, sq1.y, sq1.z, sq1.w};
    unsigned long long done = 0;   // bit 8i+j: candidate (i, j) is appended
    for (;;) {
      ++pass;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qi = i < 4 ? ty * 4 + i : QT / 2 + ty * 4 + i - 4;
        if (b0 + qi >= B) continue;
        const float ts = ls[qi * k + k - 1];
        float s[8], top = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int id = m0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
          s[j] = id >= m_end ? -INFINITY
                 : metric == 0 ? __fsub_rn(__fmul_rn(2.f, acc[i][j]), sq[j]) : acc[i][j];
          top = fmaxf(top, s[j]);
        }
        if (!(top >= ts)) continue;   // nothing here can beat the k-th entry
        const int tid = li[qi * k + k - 1];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned long long bit = 1ull << (8 * i + j);
          const int id = m0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
          if (id >= m_end || (done & bit) || !better(s[j], id, ts, tid)) continue;
          const int p = atomicAdd(&cnt[qi], 1);
          if (p < CAP) {
            bs[qi * CAP + p] = s[j];
            bi[qi * CAP + p] = id;
            done |= bit;
          } else {
            *over = pass;
          }
        }
      }
      __syncthreads();
      // `over` is final here and is not written again before the next
      // barrier, so every thread reads the same value
      if (*over != pass) break;
      fold(warp, lane);
      __syncthreads();
    }
  }
  __syncthreads();
  fold(warp, lane);
  __syncthreads();

  const int split = blockIdx.y;
  for (int e = t; e < QT * k; e += THREADS) {
    const int qi = e / k, j = e % k;
    const int b = b0 + qi;
    if (b >= B) continue;
    const size_t o = ((size_t)split * B + b) * k + j;
    out_s[o] = ls[e];
    out_i[o] = li[e];
  }
}

// One warp per query: fold `splits` partial lists into the final top-k.
__global__ void topk_merge(const float* __restrict__ part_s,
                           const int* __restrict__ part_i,
                           float* __restrict__ out_s, int* __restrict__ out_i,
                           int B, int k, int splits) {
  __shared__ float ls[4][KMAX];
  __shared__ int li[4][KMAX];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * 4 + w;
  if (b >= B) return;  // whole warps only: B is uniform per warp
  for (int e = lane; e < k; e += 32) { ls[w][e] = -INFINITY; li[w][e] = -1; }
  __syncwarp();
  const int total = splits * k;
  for (int base = 0; base < total; base += 32) {
    const int e = base + lane;
    float s = -INFINITY;
    int id = -1;
    if (e < total) {
      const int sp = e / k, j = e % k;
      const size_t o = ((size_t)sp * B + b) * k + j;
      s = part_s[o];
      id = part_i[o];
    }
    warp_merge(ls[w], li[w], k, s, id, min(32, total - base), lane);
  }
  for (int e = lane; e < k; e += 32) {
    out_s[(size_t)b * k + e] = ls[w][e];
    out_i[(size_t)b * k + e] = li[w][e];
  }
}

template <int QT>
cudaError_t launch_partial(const float* x, const float* xsq, const float* q,
                           float* ps, int* pi, int d, int B, int k, int limit,
                           int metric, int rows_per_split, int splits, cudaStream_t st) {
  const size_t dyn = dyn_bytes(QT, k);
  static size_t allowed = 0;   // the largest dynamic size granted so far
  if (dyn > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_partial<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return err;
    allowed = dyn;
  }
  dim3 grid((B + QT - 1) / QT, splits);
  topk_partial<QT><<<grid, 2 * QT, dyn, st>>>(x, xsq, q, ps, pi, d, B, k, limit,
                                              metric, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" int score_topk_f32(const float* x, const float* xsq, const float* q,
                              float* part_s, int* part_i, float* out_s,
                              int* out_i, int M, int d, int B, int k,
                              int n_valid, int metric, int splits,
                              void* stream) {
  if (k < 1 || k > KMAX || splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int limit = min(M, n_valid);
  int rows_per_split = (limit + splits - 1) / splits;
  rows_per_split = ((rows_per_split + RT - 1) / RT) * RT;
  if (rows_per_split == 0) rows_per_split = RT;
  float* ps = splits == 1 ? out_s : part_s;
  int* pi = splits == 1 ? out_i : part_i;
  cudaError_t err =
      k <= kWideMaxK
          ? launch_partial<128>(x, xsq, q, ps, pi, d, B, k, limit, metric,
                                rows_per_split, splits, st)
          : launch_partial<64>(x, xsq, q, ps, pi, d, B, k, limit, metric,
                               rows_per_split, splits, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  topk_merge<<<(B + 3) / 4, 128, 0, st>>>(part_s, part_i, out_s, out_i, B, k,
                                          splits);
  return (int)cudaGetLastError();
}
