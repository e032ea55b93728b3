// Flash-attention backward for Hopper (sm_90a): the gradients of
// blockwise online-softmax self-attention with respect to q, k and v,
// recomputed from the forward's per-row log-sum-exp.
//
// Two kernels, as the TPU reference has (no atomics, so every gradient is
// the same from run to run):
//   - flash_bwd_dq_kernel replaces tpu_pipelines/ops/flash_attention.py:
//     _dq_kernel.  One CTA per (batch*head, 64-row q-block) loops over
//     64-key blocks staged in shared memory and accumulates
//     dQ = scale * dS K, with
//       s  = scale * q k^T,
//       p  = allowed ? exp(s - lse) : 0,
//       dS = p * (dO v^T - Dvec);
//   - flash_bwd_dkv_kernel replaces _dkv_kernel.  One CTA per (batch*head,
//     64-key block) keeps its K and V rows in shared memory, loops over
//     64-row q-blocks (staging Q, dO, lse and Dvec) and accumulates
//     dV = P^T dO and dK = scale * dS^T Q.
// Dvec = rowsum(dO * O) comes in from the caller, f32 [B*H, L] like lse.
//
// Semantics kept from the TPU kernels: every product and sum is f32; a key
// is allowed iff it lies inside the sequence, its mask entry is > 0 and
// (when causal) its position is <= the query's; p is a select on that set,
// never a product with it, because an all-masked row has lse = -1e30 and
// exp(s - lse) overflows there.  Such a row gets dq = 0 and adds nothing
// to dk or dv.  Gradients are written in the input dtype.
//
// What differs from the TPU kernels, and why: q, k, v and dO are read as
// [B, L, H, D] through their strides and the [B, L] mask directly (the TPU
// path transposes four tensors to [B*H, L, D] and repeats the mask per
// head); a CTA's loop takes the place of the TPU's sequential grid axis;
// ragged L is masked in the kernel; blocks above the causal diagonal are
// skipped (_causal_live).
//
// What bounds them: at the BERT-base training shape (B=256, L=128, H=12,
// D=64, bf16, no padding) dq must read q, k, v, dO (4 x 50.3 MB), lse and
// Dvec and write dq (50.3 MB): ~252 MB, ~75 us at 3.35 TB/s, against
// ~19 GFLOP (~20 us on the bf16 tensor cores); dkv reads the same and
// writes dk and dv: ~302 MB, ~90 us, against ~26 GFLOP.  Both are bound by
// bytes, and k/v (dq) or q/dO (dkv) rows are needed only where the mask
// allows them.  This first version does its products with f32 FMAs from
// shared memory (the reference's exact f32 math, 4 x 8 register tiles per
// thread, row strides padded against bank conflicts), so it runs well
// above that bound; tensor-core products (mma.sync, then wgmma with TMA
// loads) and skipping kv-blocks the padding mask empties come next.

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
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Everything both kernels read.  Strides are in elements, for dims
// (batch, len, head) of q, k, v and dout; the last dim is contiguous.
// Gradients are contiguous [B, L, H, D].
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int32_t* mask;  // [B, L] or null (every key allowed)
  const float* lse;     // [B*H, L]
  const float* dvec;    // [B*H, L]
  void* dq;
  void* dk;
  void* dv;
  int L, H;
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh, o_sb, o_sl, o_sh;
  int causal;
  float scale;
};

// Rows [row0, row0 + nrows) of one head of x, as f32, into a shared tile:
// row-major with row stride D + 1 (transposed = false) or column-major with
// stride nrows + 1 (transposed = true).  Rows past L read as 0.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* x, int64_t sl, int row0,
                                      int nrows, int L, bool transposed) {
  for (int i = threadIdx.x; i < nrows * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    const float val = row < L ? to_f32(x[row * sl + d]) : 0.f;
    if (transposed) {
      dst[d * (nrows + 1) + r] = val;
    } else {
      dst[r * (D + 1) + d] = val;
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  // sQ, sdO [BQ][D+1]; sKt, sVt [D][BK+1]; sDS [BQ][BK+1];
  // sLse, sDvec [BQ]; sMask [BK] (ints, same size as floats).
  return 2 * BQ * (D + 1) + 2 * D * (BK + 1) + BQ * (BK + 1) + 2 * BQ + BK;
}

template <int D>
constexpr int dkv_smem_floats() {
  // sK, sV [BK][D+1]; sQt, sdOt [D][BQ+1]; sP, sDS [BK][BQ+1];
  // sLse, sDvec [BQ]; sMask [BK].
  return 2 * BK * (D + 1) + 2 * D * (BQ + 1) + 2 * BK * (BQ + 1) + 2 * BQ + BK;
}

// Grid: x = batch*head, y = q-block.  Block: NTHREADS.
//
// Thread t owns rows 4*(t/8) .. +3 of the q-block and the columns
// (t%8) + 8*j of each product, as the forward kernel does.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * (D + 1);
  float* sKt = sdO + BQ * (D + 1);
  float* sVt = sKt + D * (BK + 1);
  float* sDS = sVt + D * (BK + 1);
  float* sLse = sDS + BQ * (BK + 1);
  float* sDvec = sLse + BQ;
  int* sMask = reinterpret_cast<int*>(sDvec + BQ);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int L = a.L;
  const int q0 = blockIdx.y * BQ;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* op = static_cast<const T*>(a.dout) + b * a.o_sb + h * a.o_sh;
  const int32_t* mp = a.mask == nullptr ? nullptr : a.mask + static_cast<int64_t>(b) * L;
  const float* lp = a.lse + static_cast<int64_t>(bh) * L;
  const float* dp_vec = a.dvec + static_cast<int64_t>(bh) * L;

  stage<T, D>(sQ, qp, a.q_sl, q0, BQ, L, false);
  stage<T, D>(sdO, op, a.o_sl, q0, BQ, L, false);
  if (tid < BQ) {
    const int row = q0 + tid;
    sLse[tid] = row < L ? lp[row] : 0.f;
    sDvec[tid] = row < L ? dp_vec[row] : 0.f;
  }

  const int tr = tid / 8;
  const int tc = tid % 8;
  constexpr int DC = D / 8;  // accumulator columns per thread
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  int n_kv = (L + BK - 1) / BK;
  if (a.causal) {
    // _causal_live: kv-block kb is live iff kb*BK <= q0 + BQ - 1.
    const int last_live = (q0 + BQ - 1) / BK + 1;
    n_kv = n_kv < last_live ? n_kv : last_live;
  }

  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous block's readers of sKt/sVt/sDS are done
    stage<T, D>(sKt, kp, a.k_sl, k0, BK, L, true);
    stage<T, D>(sVt, vp, a.v_sl, k0, BK, L, true);
    if (tid < BK) {
      const int row = k0 + tid;
      sMask[tid] = row < L && (mp == nullptr || mp[row] > 0);
    }
    __syncthreads();

    // s = q k^T and dp = dO v^T for this thread's 4 x 8 tile.
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(tr * 4 + i) * (D + 1) + d];
        ov[i] = sdO[(tr * 4 + i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = sKt[d * (BK + 1) + tc + 8 * j];
        vv[j] = sVt[d * (BK + 1) + tc + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc + 8 * j;
        const bool ok = sMask[c] && row < L && (!a.causal || row >= k0 + c);
        const float p = ok ? expf(a.scale * s[i][j] - sLse[r]) : 0.f;
        sDS[r * (BK + 1) + c] = p * (dp[i][j] - sDvec[r]);
      }
    }
    __syncthreads();

    // acc += dS K.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(tr * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kk = sKt[(tc + 8 * j) * (BK + 1) + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= L) continue;
    T* dst = static_cast<T*>(a.dq) + ((static_cast<int64_t>(b) * L + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) dst[tc + 8 * j] = from_f32<T>(a.scale * acc[i][j]);
  }
}

// Grid: x = batch*head, y = kv-block.  Block: NTHREADS.
//
// Thread t owns keys 4*(t/8) .. +3 of the kv-block and the columns
// (t%8) + 8*j of each product.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * (D + 1);
  float* sQt = sV + BK * (D + 1);
  float* sdOt = sQt + D * (BQ + 1);
  float* sP = sdOt + D * (BQ + 1);
  float* sDS = sP + BK * (BQ + 1);
  float* sLse = sDS + BK * (BQ + 1);
  float* sDvec = sLse + BQ;
  int* sMask = reinterpret_cast<int*>(sDvec + BQ);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int L = a.L;
  const int k0 = blockIdx.y * BK;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* op = static_cast<const T*>(a.dout) + b * a.o_sb + h * a.o_sh;
  const int32_t* mp = a.mask == nullptr ? nullptr : a.mask + static_cast<int64_t>(b) * L;
  const float* lp = a.lse + static_cast<int64_t>(bh) * L;
  const float* dp_vec = a.dvec + static_cast<int64_t>(bh) * L;

  stage<T, D>(sK, kp, a.k_sl, k0, BK, L, false);
  stage<T, D>(sV, vp, a.v_sl, k0, BK, L, false);
  if (tid < BK) {
    const int row = k0 + tid;
    sMask[tid] = row < L && (mp == nullptr || mp[row] > 0);
  }

  const int tr = tid / 8;
  const int tc = tid % 8;
  constexpr int DC = D / 8;
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_q = (L + BQ - 1) / BQ;
  // _causal_live: q-block qb is live iff k0 <= qb*BQ + BQ - 1.
  const int first_q = a.causal ? k0 / BQ : 0;

  for (int qb = first_q; qb < n_q; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();  // the previous block's readers of sQt/sdOt/sP/sDS are done
    stage<T, D>(sQt, qp, a.q_sl, q0, BQ, L, true);
    stage<T, D>(sdOt, op, a.o_sl, q0, BQ, L, true);
    if (tid < BQ) {
      const int row = q0 + tid;
      sLse[tid] = row < L ? lp[row] : 0.f;
      sDvec[tid] = row < L ? dp_vec[row] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v dO^T for this thread's 4 keys x 8 queries.
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[8], ov[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(tr * 4 + i) * (D + 1) + d];
        vv[i] = sV[(tr * 4 + i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qv[j] = sQt[d * (BQ + 1) + tc + 8 * j];
        ov[j] = sdOt[d * (BQ + 1) + tc + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tc + 8 * j;
        const int row = q0 + r;
        const bool ok = sMask[c] && row < L && (!a.causal || row >= k0 + c);
        const float p = ok ? expf(a.scale * s[i][j] - sLse[r]) : 0.f;
        sP[c * (BQ + 1) + r] = p;
        sDS[c * (BQ + 1) + r] = p * (dp[i][j] - sDvec[r]);
      }
    }
    __syncthreads();

    // dv += P^T dO and dk += dS^T Q.
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(tr * 4 + i) * (BQ + 1) + r];
        dsv[i] = sDS[(tr * 4 + i) * (BQ + 1) + r];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float o = sdOt[(tc + 8 * j) * (BQ + 1) + r];
        const float qq = sQt[(tc + 8 * j) * (BQ + 1) + r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pv[i], o, dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qq, dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + tr * 4 + i;
    if (row >= L) continue;
    const int64_t at = ((static_cast<int64_t>(b) * L + row) * a.H + h) * D;
    T* dkp = static_cast<T*>(a.dk) + at;
    T* dvp = static_cast<T*>(a.dv) + at;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dkp[tc + 8 * j] = from_f32<T>(a.scale * dk[i][j]);
      dvp[tc + 8 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const BwdArgs& a,
                   cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory a kernel must opt in; set on every
  // launch so that each device the caller uses gets the attribute.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, int B, cudaStream_t stream) {
  return launch(flash_bwd_dq_kernel<T, D>, dq_smem_floats<D>() * sizeof(float),
                dim3(B * a.H, (a.L + BQ - 1) / BQ), a, stream);
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, int B, cudaStream_t stream) {
  return launch(flash_bwd_dkv_kernel<T, D>, dkv_smem_floats<D>() * sizeof(float),
                dim3(B * a.H, (a.L + BK - 1) / BK), a, stream);
}

// One instantiation per (dtype, head dim); which = 0 for dq, 1 for dk/dv.
template <typename T>
cudaError_t dispatch_dim(int which, int D, const BwdArgs& a, int B, cudaStream_t s) {
#define TPP_BWD_CASE(DIM)                                                       \
  case DIM:                                                                     \
    return which == 0 ? launch_dq<T, DIM>(a, B, s) : launch_dkv<T, DIM>(a, B, s);
  switch (D) {
    TPP_BWD_CASE(16)
    TPP_BWD_CASE(32)
    TPP_BWD_CASE(64)
    TPP_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef TPP_BWD_CASE
}

int dispatch(int which, int dtype, int D, const BwdArgs& a, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dim<float>(which, D, a, B, s);
    case 1:
      return dispatch_dim<__half>(which, D, a, B, s);
    case 2:
      return dispatch_dim<__nv_bfloat16>(which, D, a, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

BwdArgs pack(const void* q, const void* k, const void* v, const void* dout,
             const void* mask, const void* lse, const void* dvec, void* dq, void* dk,
             void* dv, int L, int H, const int64_t* st, int causal, float scale) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.mask = static_cast<const int32_t*>(mask);
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<const float*>(dvec);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.L = L;
  a.H = H;
  a.q_sb = st[0], a.q_sl = st[1], a.q_sh = st[2];
  a.k_sb = st[3], a.k_sl = st[4], a.k_sh = st[5];
  a.v_sb = st[6], a.v_sl = st[7], a.v_sh = st[8];
  a.o_sb = st[9], a.o_sl = st[10], a.o_sh = st[11];
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  strides: 12 int64 in
// elements, (batch, len, head) of q, k, v and dout in that order; the last
// dimension of each must be contiguous.  mask is [B, L] int32 or null;
// lse and dvec are contiguous [B*H, L] float32; dq (dk, dv) are contiguous
// [B, L, H, D] tensors of the input dtype.  Each returns the cudaError_t of
// its launch.
extern "C" int tpp_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* mask, const void* lse,
                                const void* dvec, void* dq, int dtype, int B, int L,
                                int H, int D, const int64_t* strides, int causal,
                                float scale, void* stream) {
  const BwdArgs a = pack(q, k, v, dout, mask, lse, dvec, dq, nullptr, nullptr, L, H,
                         strides, causal, scale);
  return dispatch(0, dtype, D, a, B, stream);
}

extern "C" int tpp_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* mask, const void* lse,
                                 const void* dvec, void* dk, void* dv, int dtype, int B,
                                 int L, int H, int D, const int64_t* strides, int causal,
                                 float scale, void* stream) {
  const BwdArgs a = pack(q, k, v, dout, mask, lse, dvec, nullptr, dk, dv, L, H,
                         strides, causal, scale);
  return dispatch(1, dtype, D, a, B, stream);
}
