// Pieces shared by the flash-attention kernels for Hopper (sm_90a): the
// block geometry, f32 conversions, and the tensor-core helpers of the
// bf16/fp16 kernels (mma.sync m16n8k16 with f32 accumulation, ldmatrix,
// 16-byte cp.async copies into XOR-swizzled 16-bit tiles).
//
// Included by flash_attention.cu (forward) and flash_attention_bwd.cu
// (backward).  Each source is built into a library of its own, so
// everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per block
constexpr int NTHREADS = 128;  // 4 warps

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// The 16-bit element types: pack two f32 into one 32-bit A operand (the
// lower column in the low half) and run m16n8k16 with f32 accumulation.
template <typename T> struct Tc;
template <> struct Tc<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Tc<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// src_bytes = 0 copies nothing and zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's newest commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk c of row r in a tile of rows of D 16-bit
// elements.  The chunk index is XORed with the row's position among the
// 8 rows that share a 128-byte line pattern, so the 8 row addresses of one
// ldmatrix matrix (8 consecutive rows, one chunk) hit 8 different bank
// groups at every D.
template <int D>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  constexpr int CH = D / 8;                 // chunks per row
  constexpr int RPL = CH >= 8 ? 1 : 8 / CH; // rows per 128-byte line
  constexpr int MASK = CH >= 8 ? 7 : CH - 1;
  return static_cast<uint32_t>((r * CH + (c ^ ((r / RPL) & MASK))) * 16);
}

// cp.async rows [row0, row0 + ROWS) of one head of x (row stride sl
// elements) into a swizzled tile; rows past L are zero-filled.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_tile(uint32_t tile, const T* x, int64_t sl, int row0,
                                          int L) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    const int row = row0 + r;
    const T* src = x + static_cast<int64_t>(row < L ? row : 0) * sl + c * 8;
    cp_async16(tile + tile_off<D>(r, c), src, row < L ? 16 : 0);
  }
}

// Rows [row0, row0 + ROWS) of a swizzled tile (already multiplied and
// rounded into the input dtype) to head h of a contiguous [B, L, H, D]
// output, 16 bytes a thread; rows past L are not written.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void store_tile(T* dst_base, const unsigned char* tile, int b,
                                           int row0, int L, int H, int h) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    const int row = row0 + r;
    if (row >= L) continue;
    T* dst = dst_base + ((static_cast<int64_t>(b) * L + row) * H + h) * D + c * 8;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tile + tile_off<D>(r, c));
  }
}

// One warp's 16 x D accumulator (m16n8 C layout, D/8 column tiles) times
// mult, rounded into the input dtype, into rows [row0, row0 + 16) of a
// swizzled tile.
template <typename T, int D>
__device__ __forceinline__ void acc_to_tile(unsigned char* tile, const float (&acc)[D / 8][4],
                                            int row0, float mult) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(tile + tile_off<D>(row0 + g, n) + 4 * t) =
        Tc<T>::pack(mult * acc[n][0], mult * acc[n][1]);
    *reinterpret_cast<uint32_t*>(tile + tile_off<D>(row0 + g + 8, n) + 4 * t) =
        Tc<T>::pack(mult * acc[n][2], mult * acc[n][3]);
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the SFU (relative error about 2^-22, far below the rounding of p
// to 16 bits that follows it).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
