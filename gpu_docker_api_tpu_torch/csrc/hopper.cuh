// Hopper (sm_90a) building blocks of the flash kernels, written as inline
// PTX: mbarriers, TMA tensor loads and stores, wgmma with its shared-memory
// matrix descriptors, warpgroup register reallocation, and the host-side
// tensor map over the JAX package's [B, S, heads, D] layout.
//
// Shared-memory tiles. A tile of R rows by D bf16 columns is kept as D / C
// column chunks of C = min(D, 64) elements; chunk c holds R rows of C * 2
// bytes (W bytes: 128, 64 or 32) and starts at c * R * W. TMA writes each
// chunk with the swizzle of width W (CU_TENSOR_MAP_SWIZZLE_{128,64,32}B),
// and the wgmma descriptors below read it with the same swizzle mode:
//   K-major operand (the product's depth runs along D): a k-step of 16
//     columns starts 32 bytes further in its chunk; 8-row groups are 8 * W
//     bytes apart (SBO).
//   MN-major operand (the product's depth runs along the rows, D is the
//     output width): a k-step of 16 rows starts 16 * W bytes further;
//     8-row groups are 8 * W apart (SBO) and column chunks R * W apart (LBO).
// Register fragments follow the wgmma m64nNk16 layouts: in a warpgroup,
// warp w holds rows 16w..16w+15, lane l rows 16w + l/4 and 16w + l/4 + 8;
// accumulator element 4j + e sits at column 8j + 2(l%4) + (e & 1), in the
// second row when e & 2.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---- shared memory, barriers, fences ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and to the
// other threads; the caller then synchronises the block.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase with this parity has completed. (No watchdog: a
// trap path in the consumers' loop makes ptxas serialise their wgmmas and
// spill the dK / dV accumulators.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

// Generic-proxy shared-memory writes made visible to TMA / wgmma reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over `count` threads (a warpgroup), id 1..15 (0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- TMA ---------------------------------------------------------------------

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box from shared memory to global; elements outside the tensor are
// not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The issuing thread's stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Pin accumulator registers at this point of the program: no read or write
// of them moves across it (around the asynchronous wgmma).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments held in registers.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Swizzle width in bytes of a chunk of D bf16 columns (see the top).
template <int D>
struct Chunk {
  static constexpr int C = D < 64 ? D : 64;  // columns per chunk
  static constexpr int W = C * 2;            // bytes per chunk row
  static constexpr int N = D / C;            // chunks per row
  static constexpr CUtensorMapSwizzle kSwizzle =
      W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B);
  static constexpr uint64_t kLayout = W == 128 ? 1 : (W == 64 ? 2 : 3);
};

// Byte offset of (row, col) in one chunk of rows W bytes wide, swizzled as
// TMA writes it: the 16-byte unit index XOR the row's bits above it.
template <int W>
__device__ __forceinline__ uint32_t swizzle(int row, int col) {
  const uint32_t off = row * W + col * 2;
  constexpr uint32_t mask = W / 16 - 1;
  return off ^ (((off >> 7) & mask) << 4);
}

template <int W>
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr,
                                              uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) |
         (Chunk<W / 2>::kLayout << 62);
}

// Descriptor of k-step `ks` (16 columns of D) of a K-major tile whose rows
// start at shared address `rows` (R rows per chunk: the chunk stride is
// R * W).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t rows, int ks) {
  using Ch = Chunk<D>;
  const int col = ks * 16;
  const uint32_t addr = rows + (col / Ch::C) * R * Ch::W + (col % Ch::C) * 2;
  return make_desc<Ch::W>(addr, 16, 8 * Ch::W);
}

// Descriptor of k-step `ks` (16 rows) of an MN-major tile of R rows at
// shared address `tile`.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int ks) {
  using Ch = Chunk<D>;
  return make_desc<Ch::W>(tile + ks * 16 * Ch::W, R * Ch::W, 8 * Ch::W);
}

// D[64 x N] (+)= A * B for bf16 A, B and an f32 accumulator d of N / 2
// registers a thread: ss takes A from shared memory (descriptor da), rs
// from registers (4 x bf16x2); B comes from shared memory (descriptor db),
// K-major (kTransB 0) or MN-major (1). The operand lists differ only in N,
// so one macro writes each specialisation: R = N / 2 accumulator registers
// %0..%(R-1), and I0..I6 the numbers R..R+6 of the operands after them.
template <int N>
struct Wgmma;

#define HOPPER_ACC8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_ACC_8 HOPPER_ACC8(0)
#define HOPPER_ACC_16 HOPPER_ACC_8, HOPPER_ACC8(8)
#define HOPPER_ACC_32 HOPPER_ACC_16, HOPPER_ACC8(16), HOPPER_ACC8(24)
#define HOPPER_ACC_64 \
  HOPPER_ACC_32, HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56)
#define HOPPER_REGS_8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HOPPER_REGS_16 HOPPER_REGS_8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_REGS_32                                                    \
  HOPPER_REGS_16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
                 "%27, %28, %29, %30, %31"
#define HOPPER_REGS_64                                                    \
  HOPPER_REGS_32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
                 "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
                 "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

#define HOPPER_WGMMA(N, R, I0, I1, I2, I3, I4, I5, I6)                     \
  template <>                                                             \
  struct Wgmma<N> {                                                       \
    template <int kTransB>                                                \
    static __device__ __forceinline__ void ss(float (&d)[R], uint64_t da, \
                                              uint64_t db, int accumulate) { \
      asm volatile(                                                       \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #I2 ", 0;\n"               \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "     \
          "{" HOPPER_REGS_##R "}, %" #I0 ", %" #I1 ", p, 1, 1, 0, %" #I3  \
          ";\n}\n"                                                        \
          : HOPPER_ACC_##R                                                \
          : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));             \
    }                                                                     \
    template <int kTransB>                                                \
    static __device__ __forceinline__ void rs(float (&d)[R],              \
                                              const uint32_t (&a)[4],     \
                                              uint64_t db, int accumulate) { \
      asm volatile(                                                       \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #I5 ", 0;\n"               \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "     \
          "{" HOPPER_REGS_##R "}, {%" #I0 ", %" #I1 ", %" #I2 ", %" #I3   \
          "}, %" #I4 ", p, 1, 1, %" #I6 ";\n}\n"                          \
          : HOPPER_ACC_##R                                                \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),          \
            "r"(accumulate), "n"(kTransB));                               \
    }                                                                     \
  };

HOPPER_WGMMA(16, 8, 8, 9, 10, 11, 12, 13, 14)
HOPPER_WGMMA(32, 16, 16, 17, 18, 19, 20, 21, 22)
HOPPER_WGMMA(64, 32, 32, 33, 34, 35, 36, 37, 38)
HOPPER_WGMMA(128, 64, 64, 65, 66, 67, 68, 69, 70)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step `ks` of a product whose A is an m64 accumulator
// (the columns of `acc` become the depth): 16 columns, 4 x bf16x2.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&acc)[N],
                                         int ks) {
  const int i = ks * 8;
  a[0] = pack_bf16(acc[i + 0], acc[i + 1]);
  a[1] = pack_bf16(acc[i + 2], acc[i + 3]);
  a[2] = pack_bf16(acc[i + 4], acc[i + 5]);
  a[3] = pack_bf16(acc[i + 6], acc[i + 7]);
}

// ---- epilogue: register accumulators to global memory through TMA -----------

// A warpgroup's m64 x D f32 accumulator, the lane's two rows times scale[0]
// and scale[1], packed to bf16 into `stage`: the warpgroup's 64 rows of a
// tile of kRows rows laid out as TMA reads it (column chunks kRows * W bytes
// apart, swizzled).
template <int D, int kRows>
__device__ __forceinline__ void stage_acc(const float (&acc)[D / 2],
                                          const float (&scale)[2],
                                          void* stage) {
  using Ch = Chunk<D>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
  unsigned char* base = static_cast<unsigned char*>(stage);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = warp * 16 + lane / 4 + 8 * r;
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(base + (col / Ch::C) * kRows * Ch::W +
                                 swizzle<Ch::W>(row, col % Ch::C)) =
        pack_bf16(acc[i] * scale[r], acc[i + 1] * scale[r]);
  }
}

// A tile staged by stage_acc and the tensor map it is stored through.
struct Staged {
  const CUtensorMap* map;
  const void* stage;
};

// Called by the whole warpgroup once its stage_acc writes are done: makes
// them visible to TMA, then one thread stores each tile to rows
// [row0, row0 + 64) of head h, batch b (rows at or past S are dropped) and
// waits until the stores have read shared memory.
template <int D, int kRows, int kN>
__device__ __forceinline__ void store_staged(const Staged (&tiles)[kN], int h,
                                             int row0, int b, int S) {
  using Ch = Chunk<D>;
  fence_proxy_async();
  named_sync(1 + threadIdx.x / 128, 128);
  if (threadIdx.x % 128 == 0 && row0 < S) {
    for (int n = 0; n < kN; ++n)
      for (int c = 0; c < Ch::N; ++c)
        tma_store_4d(tiles[n].map,
                     static_cast<const unsigned char*>(tiles[n].stage) +
                         c * kRows * Ch::W,
                     c * Ch::C, h, row0, b);
    tma_store_wait();
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- host: tensor maps ------------------------------------------------------

// cuTensorMapEncodeTiled is a driver-API call; reach it through the runtime
// so that the library needs no link against libcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// Map over a bf16 [B, S, heads, D] tensor, dims (D, heads, S, B), whose box
// is one column chunk of `rows` rows of one head. Rows at or past S read as
// zeros and are not written. Returns 0 or a cudaError_t. The encoder needs a
// current context on the calling thread, and a thread that has made no CUDA
// call yet (as autograd's device thread may be) has none: make a runtime
// call first.
template <int D>
inline int make_map(CUtensorMap* map, const void* base, int B, int S,
                    int heads, int rows) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16) return (int)cudaErrorMisalignedAddress;
  using Ch = Chunk<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Ch::C, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, Ch::kSwizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
