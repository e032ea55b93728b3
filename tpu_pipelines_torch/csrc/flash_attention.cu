// Flash-attention forward for Hopper (sm_90a): blockwise online-softmax
// self-attention with key padding, optional causal masking and a per-row
// log-sum-exp output.
//
// Replaces tpu_pipelines/ops/flash_attention.py:_fwd_kernel (the Pallas TPU
// kernel driven by _flash_forward).  It computes the same function:
//   - q is scaled by D^-0.5 in f32 before the product; all math is f32;
//   - a key is allowed iff it lies inside the sequence, its mask entry is
//     > 0 and (when causal) its position is <= the query's;
//   - m, l and the output accumulator follow the online-softmax recurrence;
//     a row with no allowed key outputs 0 and lse = m + log(max(l, 1e-30))
//     (= -1e30 for such a row), as the reference does;
//   - out is written in the input dtype, lse in f32 as [B*H, L].
//
// What differs from the TPU kernel, and why:
//   - q/k/v are read as [B, L, H, D] through their strides (last dim
//     contiguous) instead of a transposed [B*H, L, D] copy, and the [B, L]
//     mask is read directly instead of being repeated per head;
//   - one CTA owns one (batch*head, q-block) pair and loops over kv-blocks
//     (the TPU's sequential grid axis); dead blocks above the causal
//     diagonal are skipped;
//   - ragged L is masked inside the kernel, so there is no divisibility rule.
//
// What bounds it: at the BERT-base serving shape (B=32, L=128, H=12, D=64,
// bf16) the function must read q and write out and lse (~12.8 MB) and read
// k and v only where the mask allows a key (at most ~12.6 MB more, about
// 7.6 us at 3.35 TB/s with no padding), and do 4*H*D*L*(allowed keys)
// operations (at most ~1.6 GFLOP, about 1.6 us at the bf16 tensor-core
// rate): it is memory-bound at any mask.  This first version does its
// products with f32 FMAs from shared memory (exact f32 math, like the
// reference), so it runs well above that bound; tensor-core products
// (mma/wgmma) and asynchronous tile loads are the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per kv-block
constexpr int NTHREADS = 128;  // 4 warps
constexpr float NEG_INF = -1e30f;

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
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  // sQ [BQ][D+1], sKt [D][BK+1], sV [BK][D], sS [BQ][BK+1],
  // sM, sL, sC [BQ], sMask [BK] (ints, same size as floats).
  return BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1) + 3 * BQ + BK;
}

// Grid: x = batch*head, y = q-block.  Block: NTHREADS.
//
// Thread layout for the two products: thread t owns rows 4*(t/8) .. +3 of
// the q-block and columns (t%8) + 8*j, so a warp reads 8 consecutive
// shared-memory words of K^T / V and broadcasts 4 rows of Q / P.  Row
// strides of D+1 and BK+1 keep those 4 rows in distinct banks.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse,
                 int L, int H,
                 int64_t q_sb, int64_t q_sl, int64_t q_sh,
                 int64_t k_sb, int64_t k_sl, int64_t k_sh,
                 int64_t v_sb, int64_t v_sl, int64_t v_sh,
                 int causal, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKt = sQ + BQ * (D + 1);
  float* sV = sKt + D * (BK + 1);
  float* sS = sV + BK * D;
  float* sM = sS + BQ * (BK + 1);
  float* sL = sM + BQ;
  float* sC = sL + BQ;
  int* sMask = reinterpret_cast<int*>(sC + BQ);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * BQ;

  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;
  const int32_t* mp = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * L;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    sQ[r * (D + 1) + d] = row < L ? to_f32(qp[row * q_sl + d]) * scale : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  const int tr = tid / 8;
  const int tc = tid % 8;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int DC = D / 8;  // accumulator columns per thread
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  int n_kv = (L + BK - 1) / BK;
  if (causal) {
    // _causal_live: block kb is live iff kb*BK <= q0 + BQ - 1.
    const int last_live = (q0 + BQ - 1) / BK + 1;
    n_kv = n_kv < last_live ? n_kv : last_live;
  }

  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous block's readers of sKt/sV/sS/sMask are done
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int c = i / D, d = i % D;
      const int row = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (row < L) {
        kx = to_f32(kp[row * k_sl + d]);
        vx = to_f32(vp[row * v_sl + d]);
      }
      sKt[d * (BK + 1) + c] = kx;
      sV[c * D + d] = vx;
    }
    if (tid < BK) {
      const int row = k0 + tid;
      sMask[tid] = row < L && (mp == nullptr || mp[row] > 0);
    }
    __syncthreads();

    // S = (scale * Q) K^T for this thread's 4 x 8 tile.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(tr * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sKt[d * (BK + 1) + tc + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc + 8 * j;
        const bool ok = sMask[c] && (!causal || q0 + r >= k0 + c);
        sS[r * (BK + 1) + c] = ok ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax: warp w owns rows 16w .. 16w+15, a lane two columns.
    for (int rr = 0; rr < BQ / 4; ++rr) {
      const int r = warp * (BQ / 4) + rr;
      const int qrow = q0 + r;
      const float s0 = sS[r * (BK + 1) + lane];
      const float s1 = sS[r * (BK + 1) + lane + 32];
      const bool a0 = sMask[lane] && (!causal || qrow >= k0 + lane);
      const bool a1 = sMask[lane + 32] && (!causal || qrow >= k0 + lane + 32);
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = a0 ? expf(s0 - m_new) : 0.f;
      const float p1 = a1 ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sS[r * (BK + 1) + lane] = p0;
      sS[r * (BK + 1) + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sC[tr * 4 + i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sS[(tr * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = sV[c * D + tc + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  // sM/sL were last written before the final softmax barrier.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int row = q0 + r;
    if (row >= L) continue;
    const float denom = fmaxf(sL[r], 1e-30f);
    T* op = out + ((static_cast<int64_t>(b) * L + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) op[tc + 8 * j] = from_f32<T>(acc[i][j] / denom);
    if (tc == 0) lse[static_cast<int64_t>(bh) * L + row] = sM[r] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* mask,
                   void* out, float* lse, int B, int L, int H,
                   int64_t q_sb, int64_t q_sl, int64_t q_sh,
                   int64_t k_sb, int64_t k_sl, int64_t k_sh,
                   int64_t v_sb, int64_t v_sl, int64_t v_sh,
                   int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  // Above 48 KB of dynamic shared memory a kernel must opt in; set on every
  // launch so that each device the caller uses gets the attribute.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (L + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<T*>(out), lse, L, H,
      q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int D, const void* q, const void* k, const void* v,
                         const int32_t* mask, void* out, float* lse,
                         int B, int L, int H,
                         int64_t q_sb, int64_t q_sl, int64_t q_sh,
                         int64_t k_sb, int64_t k_sl, int64_t k_sh,
                         int64_t v_sb, int64_t v_sl, int64_t v_sh,
                         int causal, float scale, cudaStream_t stream) {
#define TPP_FLASH_CASE(DIM)                                                    \
  case DIM:                                                                    \
    return launch<T, DIM>(q, k, v, mask, out, lse, B, L, H, q_sb, q_sl, q_sh, \
                          k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, causal, scale,   \
                          stream);
  switch (D) {
    TPP_FLASH_CASE(16)
    TPP_FLASH_CASE(32)
    TPP_FLASH_CASE(64)
    TPP_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef TPP_FLASH_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Strides are in elements;
// the last dimension of q/k/v must be contiguous.  mask is [B, L] int32 or
// null (every key allowed).  out is a contiguous [B, L, H, D] tensor of the
// input dtype and lse a contiguous [B*H, L] float32 tensor.  Returns the
// cudaError_t of the launch.
extern "C" int tpp_flash_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, void* lse,
                             int dtype, int B, int L, int H, int D,
                             int64_t q_sb, int64_t q_sl, int64_t q_sh,
                             int64_t k_sb, int64_t k_sl, int64_t k_sh,
                             int64_t v_sb, int64_t v_sl, int64_t v_sh,
                             int causal, float scale, void* stream) {
  const int32_t* m = static_cast<const int32_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dtype<float>(D, q, k, v, m, out, l, B, L, H, q_sb, q_sl, q_sh,
                                 k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, causal, scale, s);
    case 1:
      return launch_dtype<__half>(D, q, k, v, m, out, l, B, L, H, q_sb, q_sl, q_sh,
                                  k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, causal, scale, s);
    case 2:
      return launch_dtype<__nv_bfloat16>(D, q, k, v, m, out, l, B, L, H, q_sb, q_sl,
                                         q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                                         causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
