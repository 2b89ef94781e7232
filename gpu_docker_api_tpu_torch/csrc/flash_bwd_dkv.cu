// Flash-attention backward, dK / dV, for Hopper.
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel`, launched by
// `_flash_bwd_raw` (gpu_docker_api_tpu/ops/attention.py):
//   dV_j = sum_i P_ij^T dO_i
//   dK_j = scale * sum_i dS_ij^T Q_i,   dS = P * (dO V^T - delta)
// summed over the q heads of the kv head's GQA group.
//
// The TPU version makes the group the fastest grid axis and adds each q
// head's share into the same output block on consecutive (sequential) grid
// steps. CUDA blocks run in no order, so here one block per (batch*kv_head,
// kv tile) loops over the group's q heads AND their q tiles itself,
// accumulating dK / dV in f32 shared memory: no atomics, no reliance on grid
// order, and the result is deterministic.
//
// What bounds it on the H100: four tile products per (kv tile, q tile) pair,
// 8*D flops per visible score: bound by tensor-core throughput at the
// training shape. What the design does about that: K, V and both f32
// accumulators stay in shared memory for the block's whole walk, the
// products run on the tensor cores (WMMA bf16, f32 accumulate), and only the
// q tiles the causal / window bounds leave visible are visited. delta is
// recomputed per q tile from O and dO, as the TPU kernel does.
#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dlse, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, int Hkv,
                         float scale, int causal, int window) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  constexpr int LDT = D + PAD;
  constexpr int LDP = BK + PAD;
  constexpr int LDS = BK + kAccPad;
  constexpr int LDA = D + kAccPad;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* sK = reinterpret_cast<T*>(p);    p += carve(BK * LDT * sizeof(T));
  T* sV = reinterpret_cast<T*>(p);    p += carve(BK * LDT * sizeof(T));
  T* sQ = reinterpret_cast<T*>(p);    p += carve(BQ * LDT * sizeof(T));
  T* sdO = reinterpret_cast<T*>(p);   p += carve(BQ * LDT * sizeof(T));
  T* sP = reinterpret_cast<T*>(p);    p += carve(BQ * LDP * sizeof(T));
  T* sdS = reinterpret_cast<T*>(p);   p += carve(BQ * LDP * sizeof(T));
  float* sS = reinterpret_cast<float*>(p);     p += carve(BQ * LDS * 4);
  float* sdP = reinterpret_cast<float*>(p);    p += carve(BQ * LDS * 4);
  float* sdK = reinterpret_cast<float*>(p);    p += carve(BK * LDA * 4);
  float* sdV = reinterpret_cast<float*>(p);    p += carve(BK * LDA * 4);
  float* sLse = reinterpret_cast<float*>(p);   p += carve(BQ * 4);
  float* sDelta = reinterpret_cast<float*>(p);

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int group = H / Hkv;
  const int col0 = blockIdx.y * BK;
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const long long kv_off = ((long long)b * S * Hkv + hk) * D;

  load_rows<T, D, BK>(sK, LDT, k + kv_off, kv_stride, col0, S);
  load_rows<T, D, BK>(sV, LDT, v + kv_off, kv_stride, col0, S);
  for (int i = threadIdx.x; i < BK * LDA; i += kThreads) {
    sdK[i] = 0.0f;
    sdV[i] = 0.0f;
  }

  const int n_q_total = cdiv(S, BQ);
  // q tiles wholly above this kv tile never see it (causal) ...
  const int i_start = causal ? col0 / BQ : 0;
  // ... nor do rows past its last column + window
  const int i_end =
      window ? min((col0 + BK - 1 + window) / BQ + 1, n_q_total) : n_q_total;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int bh = b * H + h;
    const long long q_off = ((long long)b * S * H + h) * D;
    const float* lse_head = lse + (long long)bh * S;
    const float* dlse_head = dlse ? dlse + (long long)bh * S : nullptr;
    for (int i = i_start; i < i_end; ++i) {
      const int row0 = i * BQ;
      __syncthreads();  // the previous pair's products are done with sQ / sdO
      load_rows<T, D, BQ>(sQ, LDT, q + q_off, q_stride, row0, S);
      load_rows<T, D, BQ>(sdO, LDT, dout + q_off, q_stride, row0, S);
      for (int r = threadIdx.x; r < BQ; r += kThreads)
        sLse[r] = row0 + r < S ? lse_head[row0 + r] : 0.0f;
      __syncthreads();
      row_delta<T, D, BQ>(sDelta, sdO, LDT, o + q_off, q_stride, dlse_head,
                          row0, S);
      tile_mm<T, false, true, BQ, BK, D>(sS, LDS, sQ, LDT, sK, LDT, false);
      tile_mm<T, false, true, BQ, BK, D>(sdP, LDS, sdO, LDT, sV, LDT, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
        const int r = idx / BK, c = idx % BK;
        const bool keep = visible(row0 + r, col0 + c, S, causal, window);
        const float pv =
            keep ? expf(sS[r * LDS + c] * scale - sLse[r]) : 0.0f;
        sP[r * LDP + c] = from_f<T>(pv);
        sdS[r * LDP + c] = from_f<T>(pv * (sdP[r * LDS + c] - sDelta[r]));
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q: A is P / dS read transposed
      tile_mm<T, true, false, BK, D, BQ>(sdV, LDA, sP, LDP, sdO, LDT, true);
      tile_mm<T, true, false, BK, D, BQ>(sdK, LDA, sdS, LDP, sQ, LDT, true);
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < BK * D; idx += kThreads) {
    const int c = idx / D, d = idx % D;
    const int col = col0 + c;
    if (col < S) {
      dk[kv_off + col * kv_stride + d] = from_f<T>(sdK[c * LDA + d] * scale);
      dv[kv_off + col * kv_stride + d] = from_f<T>(sdV[c * LDA + d]);
    }
  }
}

template <typename T, int D>
constexpr int dkv_smem_bytes() {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  return 2 * carve(BK * (D + PAD) * sizeof(T)) +
         2 * carve(BQ * (D + PAD) * sizeof(T)) +
         2 * carve(BQ * (BK + PAD) * sizeof(T)) +
         2 * carve(BQ * (BK + kAccPad) * 4) +
         2 * carve(BK * (D + kAccPad) * 4) + 2 * carve(BQ * 4);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, const void* dlse, void* dk,
               void* dv, int B, int S, int H, int Hkv, int causal, int window,
               cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<T, D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hkv, cdiv(S, Tile<T>::BK));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dlse), static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, Hkv, 1.0f / sqrtf((float)D), causal, window);
  return (int)cudaGetLastError();
}

}  // namespace flash

// dtype: 0 = float32, 1 = bfloat16. dlse may be null (no lse cotangent).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             const void* lse, const void* dlse, void* dk,
                             void* dv, int B, int S, int H, int Hkv, int D,
                             int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FLASH_DISPATCH_D(D, return flash::launch_dkv<float, D>(
                            q, k, v, o, dout, lse, dlse, dk, dv, B, S, H, Hkv,
                            causal, window, st));
  } else if (dtype == 1) {
    FLASH_DISPATCH_D(D, return flash::launch_dkv<flash::bf16, D>(
                            q, k, v, o, dout, lse, dlse, dk, dv, B, S, H, Hkv,
                            causal, window, st));
  }
  return (int)cudaErrorInvalidValue;
}
