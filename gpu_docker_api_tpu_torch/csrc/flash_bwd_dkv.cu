// Flash-attention backward, dK / dV, for Hopper.
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel`, launched by
// `_flash_bwd_raw` (gpu_docker_api_tpu/ops/attention.py):
//   dV_j = sum_i P_ij^T dO_i
//   dK_j = scale * sum_i dS_ij^T Q_i,   dS = P * (dO V^T - delta)
//   delta_i = rowsum(dO_i * O_i) - dlse_i
// summed over the q heads of the kv head's GQA group.
//
// The TPU version makes the group the fastest grid axis and adds each q
// head's share into the same output block on consecutive (sequential) grid
// steps. CUDA blocks run in no order, so here one block per (batch*kv_head,
// kv tile) loops over the group's q heads AND their q tiles itself,
// accumulating dK / dV in f32 inside the block: no atomics, no reliance on
// grid order, and the result is deterministic.
//
// What bounds it on the H100: four tile products per (kv tile, q tile)
// pair, 8*D flops per visible score. At the training shape (bf16, causal,
// B=4, S=2048, 16 q / 8 kv heads, D=128) that is 137 GFLOP against about
// 60 MB, 0.14 ms at the dense bf16 rate: tensor-core bound.
//
// bf16 (every head dim) runs the wgmma design:
// - flash_bwd_dkv_kernel_delta, a pre-pass launched from the same entry
//   point, computes delta once per call into a [B, H, S] f32 scratch
//   buffer (reading O and dO once), instead of once per (kv tile, q tile);
// - flash_bwd_dkv_kernel_wgmma: one block per (batch*kv_head, 128-row kv
//   tile), early kv tiles (the longest causal walks) first; two consumer
//   warpgroups own 64 kv rows each, one producer warp loads. K and V are
//   TMA-loaded once; the producer walks the group's q heads and their
//   visible 64-row q tiles, bringing Q, dO (TMA) and the tile's lse and
//   delta through a 2-stage ring guarded by full / empty mbarriers;
// - S^T = K Q^T and dP^T = V dO^T are wgmmas from shared memory (K-major);
//   P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T - delta)
//   are formed in registers, masked only on the diagonal, window-edge and
//   ragged tiles; dV += P^T dO and dK += dS^T Q take P^T / dS^T from
//   registers (bf16) and dO / Q from the same ring stage read MN-major;
// - dK and dV (64 x D f32 per warpgroup each) stay in registers for the
//   whole walk (setmaxnreg gives the consumers 240 registers a thread), and
//   the epilogue stages them in the block's own K / V buffers and stores
//   them with TMA.
// f32 is the CUDA-core parity path (wgmma has no f32 mode; TF32 would
// change the numerics): flash_bwd_dkv_kernel below, with K, V and both
// accumulators in shared memory and delta computed per q tile.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace flash {

// ---- bf16: wgmma + TMA, warp-specialised ------------------------------------

namespace hop {

constexpr int kConsumers = 2;                     // warpgroups of 64 kv rows
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int BK = 64 * kConsumers;               // kv rows per block
constexpr int BQ = 64;                            // q rows per ring stage
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// delta = rowsum(dO * O) - dlse, one row (b, s, h) per D / 8 lanes, into
// [B, H, S].
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_kernel_delta(const bf16* __restrict__ o,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ dlse,
                               float* __restrict__ delta, long long rows,
                               int S, int H) {
  constexpr int L = D / 8;  // lanes per row, 16 bytes each
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long row = idx / L;
  const int part = idx % L;
  const float acc = row_dot<D>(o + row * D, dout + row * D, part, row < rows);
  if (part == 0 && row < rows) {
    const long long b = row / ((long long)S * H);
    const int s = (row / H) % S, h = row % H;
    const long long out = (b * H + h) * S + s;
    delta[out] = acc - (dlse != nullptr ? dlse[out] : 0.0f);
  }
}

template <int D>
struct DkvSmem {
  bf16 k[BK * D];  // then dK, each warpgroup in its own rows
  bf16 v[BK * D];  // then dV
  bf16 q[kStages][BQ * D];
  bf16 dout[kStages][BQ * D];
  float lse2[kStages][BQ];  // lse * log2 e of the stage's q rows
  float delta[kStages][BQ];
  uint64_t kv_full, full[kStages], empty[kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const __grid_constant__ CUtensorMap map_dk,
                               const __grid_constant__ CUtensorMap map_dv,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, int S, int H,
                               int Hkv, float scale, int causal, int window) {
  using Ch = hopper::Chunk<D>;
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int group = H / Hkv;
  const int col0 = blockIdx.y * BK;  // early kv tiles (most q tiles) first
  const int n_q_total = cdiv(S, BQ);
  // q tiles wholly above this kv tile never see it (causal) ...
  const int i_start = causal ? col0 / BQ : 0;
  // ... nor do rows past its last column + window
  const int i_end =
      window ? min((col0 + BK - 1 + window) / BQ + 1, n_q_total) : n_q_total;
  const int n_i = i_end - i_start;
  const int n_iter = group * n_i;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 32);               // the producer warp
      hopper::mbar_init(&sm.empty[s], kConsumers * 4);  // one per warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one warp; lane 0 issues the TMA loads, every lane
    // writes its share of the stage's lse / delta ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x / 32 != kConsumers * 4) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&sm.kv_full, 2 * BK * D * 2);
      for (int c = 0; c < Ch::N; ++c) {
        hopper::tma_load_4d(sm.k + c * BK * Ch::C, &map_k, &sm.kv_full,
                            c * Ch::C, hk, col0, b);
        hopper::tma_load_4d(sm.v + c * BK * Ch::C, &map_v, &sm.kv_full,
                            c * Ch::C, hk, col0, b);
      }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % kStages;
      const int h = hk * group + it / n_i;
      const int row0 = (i_start + it % n_i) * BQ;
      hopper::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
      const long long head = ((long long)b * H + h) * S;
      for (int r = lane; r < BQ; r += 32) {
        const int row = row0 + r;
        sm.lse2[st][r] = row < S ? lse[head + row] * kLog2e : 0.0f;
        sm.delta[st][r] = row < S ? delta[head + row] : 0.0f;
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&sm.full[st], 2 * BQ * D * 2);
        for (int c = 0; c < Ch::N; ++c) {
          hopper::tma_load_4d(sm.q[st] + c * BQ * Ch::C, &map_q, &sm.full[st],
                              c * Ch::C, h, row0, b);
          hopper::tma_load_4d(sm.dout[st] + c * BQ * Ch::C, &map_do,
                              &sm.full[st], c * Ch::C, h, row0, b);
        }
      } else {
        hopper::mbar_arrive(&sm.full[st]);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns kv rows [c_lo, c_lo + 64) ----
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int c_lo = col0 + wg * 64;
    const int kv_row0 = c_lo + warp * 16 + lane / 4;  // and kv_row0 + 8
    const int col_t = 2 * (lane % 4);
    bf16* k_rows = sm.k + wg * 64 * Ch::C;
    bf16* v_rows = sm.v + wg * 64 * Ch::C;
    const uint32_t k_addr = hopper::smem_u32(k_rows);
    const uint32_t v_addr = hopper::smem_u32(v_rows);
    const uint32_t q_addr = hopper::smem_u32(sm.q[0]);
    const uint32_t do_addr = hopper::smem_u32(sm.dout[0]);
    const float scale_log2 = scale * kLog2e;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

    hopper::mbar_wait(&sm.kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % kStages;
      const int row0 = (i_start + it % n_i) * BQ;
      const uint32_t qa = q_addr + st * BQ * D * 2;
      const uint32_t da = do_addr + st * BQ * D * 2;
      float s[BQ / 2], dp[BQ / 2];
      hopper::mbar_wait(&sm.full[st], (it / kStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::Wgmma<BQ>::template ss<0>(
            s, hopper::desc_k_major<D, BK>(k_addr, ks),
            hopper::desc_k_major<D, BQ>(qa, ks), ks > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::Wgmma<BQ>::template ss<0>(
            dp, hopper::desc_k_major<D, BK>(v_addr, ks),
            hopper::desc_k_major<D, BQ>(da, ks), ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S^T is in
      hopper::fence_regs(s);

      // P^T: rows are kv rows, columns q rows; lse / delta per column
      const bool edge = row0 + BQ > S || c_lo + 64 > S ||
                        (causal && row0 < c_lo + 63) ||
                        (window && row0 + BQ - 1 - c_lo >= window);
      const float* lse2 = sm.lse2[st];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int qc = 8 * (i / 4) + col_t + (i & 1);
        s[i] = hopper::exp2_approx(fmaf(s[i], scale_log2, -lse2[qc]));
        if (edge && !visible(row0 + qc, kv_row0 + 8 * ((i >> 1) & 1), S,
                             causal, window))
          s[i] = 0.0f;
      }
      hopper::wgmma_wait<0>();  // dP^T is in
      hopper::fence_regs(dp);
      const float* dl = sm.delta[st];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int qc = 8 * (i / 4) + col_t + (i & 1);
        dp[i] = s[i] * (dp[i] - dl[qc]);
      }
      // P^T and dS^T as bf16 A fragments; the f32 tiles are dead from here,
      // which keeps dK, dV and both fragments inside the register budget
      uint32_t a[BQ / 16][4], ads[BQ / 16][4];
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks) {
        hopper::acc_to_a(a[ks], s, ks);
        hopper::acc_to_a(ads[ks], dp, ks);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks)
        hopper::Wgmma<D>::template rs<1>(
            dv, a[ks], hopper::desc_mn_major<D, BQ>(da, ks), 1);
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks)
        hopper::Wgmma<D>::template rs<1>(
            dk, ads[ks], hopper::desc_mn_major<D, BQ>(qa, ks), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks) {
        hopper::fence_regs(a[ks]);
        hopper::fence_regs(ads[ks]);
      }
      if (lane == 0) hopper::mbar_arrive(&sm.empty[st]);
    }

    // epilogue: dK (scaled) and dV into this warpgroup's rows of the K / V
    // buffers, then TMA
    const float dk_scale[2] = {scale, scale}, dv_scale[2] = {1.0f, 1.0f};
    hopper::stage_acc<D, BK>(dk, dk_scale, k_rows);
    hopper::stage_acc<D, BK>(dv, dv_scale, v_rows);
    hopper::store_staged<D, BK>({{&map_dk, k_rows}, {&map_dv, v_rows}}, hk,
                                c_lo, b, S);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* dlse, void* delta,
           void* dk, void* dv, int B, int S, int H, int Hkv, int causal,
           int window, cudaStream_t stream) {
  if (delta == nullptr) return (int)cudaErrorInvalidValue;
  // a runtime call first: it makes a context current, which make_map needs
  constexpr int smem = sizeof(DkvSmem<D>) + 1024;  // + base alignment
  auto kernel = flash_bwd_dkv_kernel_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  int rc = hopper::make_map<D>(&mq, q, B, S, H, BQ);
  if (!rc) rc = hopper::make_map<D>(&mdo, dout, B, S, H, BQ);
  if (!rc) rc = hopper::make_map<D>(&mk, k, B, S, Hkv, BK);
  if (!rc) rc = hopper::make_map<D>(&mv, v, B, S, Hkv, BK);
  if (!rc) rc = hopper::make_map<D>(&mdk, dk, B, S, Hkv, 64);
  if (!rc) rc = hopper::make_map<D>(&mdv, dv, B, S, Hkv, 64);
  if (rc) return rc;

  const long long rows = (long long)B * S * H;
  const long long threads = rows * (D / 8);
  flash_bwd_dkv_kernel_delta<D><<<(unsigned)((threads + 255) / 256), 256, 0,
                                  stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(dlse), static_cast<float*>(delta), rows, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hkv, cdiv(S, BK));
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, mdk, mdv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), S, H, Hkv, 1.0f / sqrtf((float)D),
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace hop

// ---- f32: the CUDA-core parity path ------------------------------------------


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
// delta: a [B, H, S] f32 scratch buffer for bf16 (the pre-pass writes it),
// unused (may be null) for f32. Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             const void* lse, const void* dlse, void* delta,
                             void* dk, void* dv, int B, int S, int H, int Hkv,
                             int D, int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FLASH_DISPATCH_D(D, return flash::launch_dkv<float, D>(
                            q, k, v, o, dout, lse, dlse, dk, dv, B, S, H, Hkv,
                            causal, window, st));
  } else if (dtype == 1) {
    FLASH_DISPATCH_D(D, return flash::hop::launch<D>(
                            q, k, v, o, dout, lse, dlse, delta, dk, dv, B, S,
                            H, Hkv, causal, window, st));
  }
  return (int)cudaErrorInvalidValue;
}
