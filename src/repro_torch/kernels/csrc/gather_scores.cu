// Fused gather + score over candidate ids, fp32 rows and int8 codes.
//
// Replaces the Pallas kernels of src/repro/kernels/gather_distance.py:
//   gather_scores_pallas    (_gd_kernel)  -> gather_scores_f32 below
//   gather_scores_q8_pallas (_gdq_kernel) -> gather_scores_q8 below
// For each query b and candidate slot c the score of row table[ids[b,c]]
// against q[b]: l2 = 2<x,q> - tsq[id], ip/cos = <x,q>; the q8 variant scores
// the dequantized row s*codes: l2 = s*(2<c,q> - s*sum(c^2)), ip/cos = s*<c,q>.
// Ids < 0 or >= N write -inf without touching memory. fp32 accumulation.
//
// Bound on this card: bytes. Each (b, c) reads one table row (4d bytes, or d
// for codes) plus an id, a norm or scale and writes a score, about
// B*C*(4d + 12) bytes, against 2d FLOPs per row — far below the H100's
// FLOP/byte balance. The design therefore spends everything on the row
// read: one warp per (b, c), each lane loading 16-byte pieces (4 bytes for
// codes), so a 512-byte row at d = 128 is one coalesced warp transaction;
// the block stages q[b] in shared memory once for all its candidates; the
// warp reduces with shuffles and lane 0 writes. d need not be a multiple of
// the piece size: the tail is masked (and rows whose stride breaks 16-byte
// alignment take 4-byte loads).
//
// The q8 epilogue uses __fmul_rn/__fsub_rn so nvcc cannot contract it into
// an FMA: with integer-valued data the kernel then matches its plain PyTorch
// version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block per query b; warp w handles candidates c = w, w + kWarps, ...
__global__ void gather_f32_kernel(const float* __restrict__ table,
                                  const float* __restrict__ tsq,
                                  const int* __restrict__ ids,
                                  const float* __restrict__ q,
                                  float* __restrict__ out, int N, int d, int C,
                                  int metric, bool vec4) {
  extern __shared__ float qs[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < d; j += blockDim.x) qs[j] = q[(size_t)b * d + j];
  __syncthreads();
  for (int c = warp; c < C; c += kWarps) {
    const int id = ids[(size_t)b * C + c];
    if (id < 0 || id >= N) {
      if (lane == 0) out[(size_t)b * C + c] = -INFINITY;
      continue;
    }
    const float* row = table + (size_t)id * d;
    float acc = 0.f;
    if (vec4) {
      const int d4 = d >> 2;
      const float4* row4 = reinterpret_cast<const float4*>(row);
      for (int j = lane; j < d4; j += 32) {
        float4 v = __ldg(row4 + j);
        const float* qq = qs + 4 * j;
        acc = fmaf(v.x, qq[0], acc);
        acc = fmaf(v.y, qq[1], acc);
        acc = fmaf(v.z, qq[2], acc);
        acc = fmaf(v.w, qq[3], acc);
      }
    } else {
      for (int j = lane; j < d; j += 32) acc = fmaf(__ldg(row + j), qs[j], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      out[(size_t)b * C + c] =
          metric == 0 ? __fsub_rn(__fmul_rn(2.f, acc), tsq[id]) : acc;
    }
  }
}

__global__ void gather_q8_kernel(const int8_t* __restrict__ codes,
                                 const float* __restrict__ scales,
                                 const int* __restrict__ ids,
                                 const float* __restrict__ q,
                                 float* __restrict__ out, int N, int d, int C,
                                 int metric, bool vec4) {
  extern __shared__ float qs[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < d; j += blockDim.x) qs[j] = q[(size_t)b * d + j];
  __syncthreads();
  for (int c = warp; c < C; c += kWarps) {
    const int id = ids[(size_t)b * C + c];
    if (id < 0 || id >= N) {
      if (lane == 0) out[(size_t)b * C + c] = -INFINITY;
      continue;
    }
    const int8_t* row = codes + (size_t)id * d;
    float dot = 0.f, sq = 0.f;
    if (vec4) {
      const int d4 = d >> 2;
      const char4* row4 = reinterpret_cast<const char4*>(row);
      for (int j = lane; j < d4; j += 32) {
        char4 v = row4[j];
        const float* qq = qs + 4 * j;
        const float c0 = v.x, c1 = v.y, c2 = v.z, c3 = v.w;
        dot = fmaf(c0, qq[0], dot);
        dot = fmaf(c1, qq[1], dot);
        dot = fmaf(c2, qq[2], dot);
        dot = fmaf(c3, qq[3], dot);
        sq = fmaf(c0, c0, sq);
        sq = fmaf(c1, c1, sq);
        sq = fmaf(c2, c2, sq);
        sq = fmaf(c3, c3, sq);
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float cj = row[j];
        dot = fmaf(cj, qs[j], dot);
        sq = fmaf(cj, cj, sq);
      }
    }
    dot = warp_sum(dot);
    sq = warp_sum(sq);
    if (lane == 0) {
      const float s = scales[id];
      float r;
      if (metric == 0) {
        r = __fmul_rn(s, __fsub_rn(__fmul_rn(2.f, dot), __fmul_rn(s, sq)));
      } else {
        r = __fmul_rn(s, dot);
      }
      out[(size_t)b * C + c] = r;
    }
  }
}

}  // namespace

extern "C" int gather_scores_f32(const float* table, const float* tsq,
                                 const int* ids, const float* q, float* out,
                                 int N, int d, int B, int C, int metric,
                                 void* stream) {
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(table) % 16 == 0);
  gather_f32_kernel<<<B, 32 * kWarps, d * sizeof(float), (cudaStream_t)stream>>>(
      table, tsq, ids, q, out, N, d, C, metric, vec4);
  return (int)cudaGetLastError();
}

extern "C" int gather_scores_q8(const int8_t* codes, const float* scales,
                                const int* ids, const float* q, float* out,
                                int N, int d, int B, int C, int metric,
                                void* stream) {
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(codes) % 4 == 0);
  gather_q8_kernel<<<B, 32 * kWarps, d * sizeof(float), (cudaStream_t)stream>>>(
      codes, scales, ids, q, out, N, d, C, metric, vec4);
  return (int)cudaGetLastError();
}
