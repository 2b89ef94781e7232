// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the mask, the row reductions, the
// bf16 row dot product of delta = rowsum(dO * O), and the f32 parity
// path's tile shapes, global->shared row loader, CUDA-core tile product and
// per-tile delta. (bf16 runs the wgmma kernels built from hopper.cuh.)
//
// Layouts are the JAX package's public ones, read in place (no transposes):
//   q, o, do   [B, S, H, D]      row (b, s, h) at ((b*S + s)*H + h)*D
//   k, v       [B, S, Hkv, D]    q head h reads kv head h / (H / Hkv)
//   lse, dlse  [B, H, S] f32
// Every kernel masks a ragged tail (S % tile != 0) itself: rows and columns
// at or past S load as zeros, score as -inf and are never written.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps per block (f32 path)

// Tile shapes of the f32 parity path (CUDA cores): one float of padding
// makes the column walks conflict-free, and the small tiles keep the dK/dV
// kernel's five f32 tiles under 227 KB.
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int BQ = 32, BK = 32, PAD = 1;
};
constexpr int kAccPad = 4;  // floats of padding of the f32 scratch rows

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Bytes of a carved shared buffer, rounded up to 128 so that every buffer
// starts 128-byte aligned.
__host__ __device__ constexpr int carve(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// Rows [row0, row0 + R) of one head of a [B, S, heads, D] tensor into shared
// memory (row stride ld elements). `g` points at row 0 of the head; rows are
// `row_stride` elements apart. Rows at or past S are zero-filled.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* g,
                                          long long row_stride, int row0,
                                          int S) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kChunks = D / kVec;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * kVec;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) {
      val = *reinterpret_cast<const uint4*>(g + row * row_stride + c);
    }
    // the odd f32 row stride forbids vector stores
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * ld + c + i] = e[i];
  }
}

// C[M x N] (+)= A[M x K] * B[K x N], all in shared memory; C is f32.
// A_T: A is stored transposed (A(m, k) at A[k * lda + m]), else row-major.
// B_T: B is stored transposed (B(k, n) at B[n * ldb + k]), else row-major.
// A plain CUDA-core dot product per element (the f32 parity path).
// The caller synchronises before (operands written) and after (C read).
template <typename T, bool A_T, bool B_T, int M, int N, int K>
__device__ __forceinline__ void tile_mm(float* C, int ldc, const T* A, int lda,
                                        const T* B, int ldb, bool accumulate) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int m = idx / N, n = idx % N;
    float s = accumulate ? C[m * ldc + n] : 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = to_f(A_T ? A[k * lda + m] : A[m * lda + k]);
      const float b = to_f(B_T ? B[n * ldb + k] : B[k * ldb + n]);
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

// Which (row, col) scores survive: in range, causal (col <= row) and inside a
// sliding window (col > row - window) when those are on.
__device__ __forceinline__ bool visible(int row, int col, int S, int causal,
                                        int window) {
  return row < S && col < S && (!causal || col <= row) &&
         (!window || col > row - window);
}

// Sum over the `width` consecutive lanes that share one row.
template <int width>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
template <int width>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// sum_d O[d] * dO[d] of one bf16 row of D columns, taken by its D / 8
// consecutive lanes together (`part` = the lane's index among them), each
// with one 16-byte load of O and of dO; a lane with `valid` false adds 0.
// Every lane of the warp calls it (the sum shuffles over the full mask).
// delta's row sum in the bf16 backward kernels.
template <int D>
__device__ __forceinline__ float row_dot(const bf16* o_row, const bf16* do_row,
                                         int part, bool valid) {
  float acc = 0.0f;
  if (valid) {
    const uint4 a = *reinterpret_cast<const uint4*>(o_row + part * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(do_row + part * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(g2[e]);
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
  return row_sum<D / 8>(acc);
}

// delta_r = sum_d dO[r, d] * O[r, d] (minus dlse_r when given), for the R rows
// of one tile: dO from shared memory, O straight from global memory. Rows past
// S get 0. `width` threads share a row.
template <typename T, int D, int R>
__device__ __forceinline__ void row_delta(float* delta, const T* sdO, int ld,
                                          const T* o_head, long long row_stride,
                                          const float* dlse_head, int row0,
                                          int S) {
  constexpr int width = kThreads / R;
  const int r = threadIdx.x / width, part = threadIdx.x % width;
  const int row = row0 + r;
  float acc = 0.0f;
  if (row < S) {
    const T* orow = o_head + row * row_stride;
    for (int d = part; d < D; d += width)
      acc = fmaf(to_f(sdO[r * ld + d]), to_f(orow[d]), acc);
  }
  acc = row_sum<width>(acc);
  if (part == 0) {
    if (row < S && dlse_head != nullptr) acc -= dlse_head[row];
    delta[r] = acc;
  }
}

}  // namespace flash

// One dispatch over the supported head dims; anything else is refused.
#define FLASH_DISPATCH_D(D_VAL, ...)                 \
  switch (D_VAL) {                                   \
    case 16: { constexpr int D = 16; __VA_ARGS__; break; }   \
    case 32: { constexpr int D = 32; __VA_ARGS__; break; }   \
    case 64: { constexpr int D = 64; __VA_ARGS__; break; }   \
    case 128: { constexpr int D = 128; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;      \
  }
