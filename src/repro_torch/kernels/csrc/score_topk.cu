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
// read. The design:
//   * pass 1 (topk_partial): a block owns 16 queries and one range of rows.
//     It walks the range in tiles of 64 rows, staging 64-wide slices of the
//     tile and of the queries through shared memory (the row tile padded by
//     one word so the 64 lanes reading one column hit 32 distinct banks).
//     Each thread accumulates 8 query x 1 row dot products in registers.
//     Scores of rows >= n_valid are -inf.
//   * each warp then folds the tile's scores into the running top-k lists
//     of its 4 queries, kept sorted in shared memory: a ballot against the
//     current k-th entry lets only candidates that can enter pay for an
//     insertion (a warp-parallel rank count and shift).
//   * at B = 1000 the query groups alone give ~63 blocks for 132 SMs, so the
//     rows are split across `splits` blocks per query group; pass 2
//     (topk_merge) folds the partial lists of each query with the same
//     insertion and tie rule. With one split pass 1 writes the output.
// The comparison (score desc, id asc) is a total order on the candidates,
// so the result does not depend on the order in which they arrive.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QB = 16;        // queries per block
constexpr int TM = 64;        // rows per tile
constexpr int DK = 64;        // dims per staged slice
constexpr int KMAX = 128;     // largest supported k
constexpr int THREADS = 128;  // 4 warps; thread t: row t % 64, queries 8*(t/64)..+7

__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Insert (cs, ci) into the sorted list (ls, li) of length k if it beats the
// k-th entry. Called by all 32 lanes of a warp with the same candidate.
__device__ __forceinline__ void warp_insert(float* ls, int* li, int k,
                                            float cs, int ci, int lane) {
  if (!better(cs, ci, ls[k - 1], li[k - 1])) return;
  int cnt = 0;
  for (int e = lane; e < k; e += 32) cnt += better(ls[e], li[e], cs, ci) ? 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  const int pos = cnt;  // entries strictly better than the candidate
  float mv[KMAX / 32];
  int mi[KMAX / 32];
  int n = 0;
  for (int e = lane; e < k; e += 32, ++n) {
    if (e > pos) { mv[n] = ls[e - 1]; mi[n] = li[e - 1]; }
  }
  __syncwarp();
  n = 0;
  for (int e = lane; e < k; e += 32, ++n) {
    if (e > pos) { ls[e] = mv[n]; li[e] = mi[n]; }
    else if (e == pos) { ls[e] = cs; li[e] = ci; }
  }
  __syncwarp();
}

// Offer 32 candidates (one per lane) to a list; only those that beat the
// current k-th entry at offer time are inserted, in lane order.
__device__ __forceinline__ void warp_offer(float* ls, int* li, int k,
                                           float s, int id, int lane) {
  unsigned mask = __ballot_sync(0xffffffffu, better(s, id, ls[k - 1], li[k - 1]));
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cs = __shfl_sync(0xffffffffu, s, src);
    const int ci = __shfl_sync(0xffffffffu, id, src);
    warp_insert(ls, li, k, cs, ci, lane);
  }
}

__global__ void __launch_bounds__(THREADS)
topk_partial(const float* __restrict__ x, const float* __restrict__ xsq,
             const float* __restrict__ q, float* __restrict__ out_s,
             int* __restrict__ out_i, int M, int d, int B, int k, int n_valid,
             int metric, int rows_per_split) {
  __shared__ float xs[TM][DK + 1];
  __shared__ __align__(16) float qs[DK][QB];
  __shared__ float sc[QB][TM];
  __shared__ float ls[QB][KMAX];
  __shared__ int li[QB][KMAX];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int r = t % TM;
  const int qg = (t / TM) * 8;
  const int b0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int m_begin = split * rows_per_split;
  const int m_end = min(M, min(n_valid, m_begin + rows_per_split));

  for (int e = t; e < QB * KMAX; e += THREADS) {
    (&ls[0][0])[e] = -INFINITY;
    (&li[0][0])[e] = -1;
  }
  __syncthreads();

  for (int m0 = m_begin; m0 < m_end; m0 += TM) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += DK) {
      for (int e = t; e < TM * DK; e += THREADS) {
        const int row = e / DK, col = e % DK;
        const int gr = m0 + row, gc = k0 + col;
        xs[row][col] = (gr < m_end && gc < d) ? x[(size_t)gr * d + gc] : 0.f;
      }
      for (int e = t; e < QB * DK; e += THREADS) {
        const int qi = e / DK, col = e % DK;
        const int gb = b0 + qi, gc = k0 + col;
        qs[col][qi] = (gb < B && gc < d) ? q[(size_t)gb * d + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) {
        const float xv = xs[r][kk];
        const float4 qa = *reinterpret_cast<const float4*>(&qs[kk][qg]);
        const float4 qb = *reinterpret_cast<const float4*>(&qs[kk][qg + 4]);
        acc[0] = fmaf(xv, qa.x, acc[0]);
        acc[1] = fmaf(xv, qa.y, acc[1]);
        acc[2] = fmaf(xv, qa.z, acc[2]);
        acc[3] = fmaf(xv, qa.w, acc[3]);
        acc[4] = fmaf(xv, qb.x, acc[4]);
        acc[5] = fmaf(xv, qb.y, acc[5]);
        acc[6] = fmaf(xv, qb.z, acc[6]);
        acc[7] = fmaf(xv, qb.w, acc[7]);
      }
      __syncthreads();
    }
    const int id = m0 + r;
    const bool ok = id < m_end;
    const float sq = (ok && metric == 0) ? xsq[id] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s = metric == 0 ? __fsub_rn(__fmul_rn(2.f, acc[j]), sq) : acc[j];
      sc[qg + j][r] = ok ? s : -INFINITY;
    }
    __syncthreads();
    for (int qi = warp * 4; qi < warp * 4 + 4; ++qi) {
      if (b0 + qi >= B) break;
#pragma unroll
      for (int half = 0; half < TM / 32; ++half) {
        const int j = half * 32 + lane;
        warp_offer(ls[qi], li[qi], k, sc[qi][j], m0 + j, lane);
      }
    }
    __syncthreads();
  }

  for (int qi = 0; qi < QB; ++qi) {
    const int b = b0 + qi;
    if (b >= B) break;
    for (int e = t; e < k; e += THREADS) {
      const size_t o = ((size_t)split * B + b) * k + e;
      out_s[o] = ls[qi][e];
      out_i[o] = li[qi][e];
    }
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
    warp_offer(ls[w], li[w], k, s, id, lane);
  }
  for (int e = lane; e < k; e += 32) {
    out_s[(size_t)b * k + e] = ls[w][e];
    out_i[(size_t)b * k + e] = li[w][e];
  }
}

}  // namespace

extern "C" int score_topk_f32(const float* x, const float* xsq, const float* q,
                              float* part_s, int* part_i, float* out_s,
                              int* out_i, int M, int d, int B, int k,
                              int n_valid, int metric, int splits,
                              void* stream) {
  if (k < 1 || k > KMAX || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int limit = min(M, n_valid);
  int rows_per_split = (limit + splits - 1) / splits;
  rows_per_split = ((rows_per_split + TM - 1) / TM) * TM;
  if (rows_per_split == 0) rows_per_split = TM;
  dim3 grid((B + QB - 1) / QB, splits);
  float* ps = splits == 1 ? out_s : part_s;
  int* pi = splits == 1 ? out_i : part_i;
  topk_partial<<<grid, THREADS, 0, st>>>(x, xsq, q, ps, pi, M, d, B, k,
                                         limit, metric, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  topk_merge<<<(B + 3) / 4, 128, 0, st>>>(part_s, part_i, out_s, out_i, B, k,
                                          splits);
  return (int)cudaGetLastError();
}
