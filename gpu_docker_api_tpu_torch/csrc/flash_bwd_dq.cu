// Flash-attention backward, dQ, for Hopper.
//
// Replaces the TPU kernel `_flash_bwd_dq_kernel`, launched by `_flash_bwd_raw`
// (gpu_docker_api_tpu/ops/attention.py):
//   P  = exp(scale * Q K^T - lse)            recomputed tile by tile
//   dS = P * (dO V^T - delta),  delta = rowsum(dO * O) - dlse
//   dQ = scale * sum_j dS_j K_j
// with the forward's causal / window bounds and zero-copy GQA.
//
// What bounds it on the H100: three tile products per (q tile, kv tile) pair,
// 6*D flops per visible score, against Q / dO / O rows read once and K / V
// tiles streamed: bound by tensor-core throughput at the training shape.
// What the design does about that: one block per (batch*head, q tile)
// holds Q, dO and the f32 dQ accumulator in shared memory for its whole kv
// walk, runs the three products on the tensor cores (WMMA bf16, f32
// accumulate), computes delta in the block from O and dO (no extra pass),
// and walks only the kv tiles the causal / window bounds leave visible.
#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dlse, T* __restrict__ dq,
                        int S, int H, int Hkv, float scale, int causal,
                        int window) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  constexpr int LDT = D + PAD;
  constexpr int LDP = BK + PAD;
  constexpr int LDS = BK + kAccPad;
  constexpr int LDA = D + kAccPad;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* sQ = reinterpret_cast<T*>(p);    p += carve(BQ * LDT * sizeof(T));
  T* sdO = reinterpret_cast<T*>(p);   p += carve(BQ * LDT * sizeof(T));
  T* sK = reinterpret_cast<T*>(p);    p += carve(BK * LDT * sizeof(T));
  T* sV = reinterpret_cast<T*>(p);    p += carve(BK * LDT * sizeof(T));
  T* sdS = reinterpret_cast<T*>(p);   p += carve(BQ * LDP * sizeof(T));
  float* sS = reinterpret_cast<float*>(p);     p += carve(BQ * LDS * 4);
  float* sdP = reinterpret_cast<float*>(p);    p += carve(BQ * LDS * 4);
  float* sdQ = reinterpret_cast<float*>(p);    p += carve(BQ * LDA * 4);
  float* sLse = reinterpret_cast<float*>(p);   p += carve(BQ * 4);
  float* sDelta = reinterpret_cast<float*>(p);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int row0 = blockIdx.y * BQ;
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const long long q_off = ((long long)b * S * H + h) * D;
  const T* k_head = k + ((long long)b * S * Hkv + hk) * D;
  const T* v_head = v + ((long long)b * S * Hkv + hk) * D;
  const float* lse_head = lse + (long long)bh * S;
  const float* dlse_head = dlse ? dlse + (long long)bh * S : nullptr;

  load_rows<T, D, BQ>(sQ, LDT, q + q_off, q_stride, row0, S);
  load_rows<T, D, BQ>(sdO, LDT, dout + q_off, q_stride, row0, S);
  for (int i = threadIdx.x; i < BQ * LDA; i += kThreads) sdQ[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += kThreads)
    sLse[i] = row0 + i < S ? lse_head[row0 + i] : 0.0f;
  __syncthreads();
  row_delta<T, D, BQ>(sDelta, sdO, LDT, o + q_off, q_stride, dlse_head, row0,
                      S);

  const int n_kv_total = cdiv(S, BK);
  const int n_kv = causal ? min(cdiv(row0 + BQ, BK), n_kv_total) : n_kv_total;
  const int kv_lo = window ? max((row0 - window + 1) / BK, 0) : 0;

  for (int j = kv_lo; j < n_kv; ++j) {
    __syncthreads();  // previous dS @ K is done with sK / sdS
    load_rows<T, D, BK>(sK, LDT, k_head, kv_stride, j * BK, S);
    load_rows<T, D, BK>(sV, LDT, v_head, kv_stride, j * BK, S);
    __syncthreads();
    tile_mm<T, false, true, BQ, BK, D>(sS, LDS, sQ, LDT, sK, LDT, false);
    tile_mm<T, false, true, BQ, BK, D>(sdP, LDS, sdO, LDT, sV, LDT, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
      const int r = idx / BK, c = idx % BK;
      const bool keep = visible(row0 + r, j * BK + c, S, causal, window);
      const float pv =
          keep ? expf(sS[r * LDS + c] * scale - sLse[r]) : 0.0f;
      sdS[r * LDP + c] = from_f<T>(pv * (sdP[r * LDS + c] - sDelta[r]));
    }
    __syncthreads();
    tile_mm<T, false, false, BQ, D, BK>(sdQ, LDA, sdS, LDP, sK, LDT, true);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    if (row < S) dq[q_off + row * q_stride + d] = from_f<T>(sdQ[r * LDA + d] * scale);
  }
}

template <typename T, int D>
constexpr int dq_smem_bytes() {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  return 2 * carve(BQ * (D + PAD) * sizeof(T)) +
         2 * carve(BK * (D + PAD) * sizeof(T)) +
         carve(BQ * (BK + PAD) * sizeof(T)) +
         2 * carve(BQ * (BK + kAccPad) * 4) + carve(BQ * (D + kAccPad) * 4) +
         2 * carve(BQ * 4);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, const void* dlse, void* dq,
              int B, int S, int H, int Hkv, int causal, int window,
              cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<T, D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, cdiv(S, Tile<T>::BQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dlse), static_cast<T*>(dq), S, H, Hkv,
      1.0f / sqrtf((float)D), causal, window);
  return (int)cudaGetLastError();
}

}  // namespace flash

// dtype: 0 = float32, 1 = bfloat16. dlse may be null (no lse cotangent).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const void* lse, const void* dlse, void* dq, int B,
                            int S, int H, int Hkv, int D, int causal,
                            int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FLASH_DISPATCH_D(D, return flash::launch_dq<float, D>(
                            q, k, v, o, dout, lse, dlse, dq, B, S, H, Hkv,
                            causal, window, st));
  } else if (dtype == 1) {
    FLASH_DISPATCH_D(D, return flash::launch_dq<flash::bf16, D>(
                            q, k, v, o, dout, lse, dlse, dq, B, S, H, Hkv,
                            causal, window, st));
  }
  return (int)cudaErrorInvalidValue;
}
