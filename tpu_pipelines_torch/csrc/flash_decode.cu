// Flash-decode attention for Hopper (sm_90a): one query per (batch, head)
// attends over a padded KV cache, with key validity and an additive score
// bias (T5's relative positions).
//
// Replaces tpu_pipelines/ops/flash_attention.py:_decode_kernel (the Pallas
// TPU kernel driven by flash_decode_attention).  It computes the same
// function:
//   - q is scaled by D^-0.5 in f32 before the product; all math is f32;
//   - s = (scale * q) . k + bias, the bias added after the product;
//   - a key is allowed iff it lies inside the cache and its validity entry
//     is > 0; a masked key's score is NEG_INF (-1e30) in the reference,
//     where exp(s - m) of it is exactly 0, so here it never enters the sums;
//   - online softmax in f32: p = exp(s - m), out = acc / max(l, 1e-30), so a
//     row whose keys are all masked outputs exact 0;
//   - out is written in q's dtype as [B, 1, H, D].  No LSE and no VJP.
//
// What differs from the TPU kernel, and why:
//   - no replication of q to a sublane tile, no transposed [B*H, L, D] copy
//     of the cache on every call, no [B*H, 1, L] broadcast of the bias: q, k,
//     v, the validity mask and the bias are read where they lie, through
//     their strides (the bias with batch stride 0 when its leading dim is 1),
//     so a strided view such as an engine arena's [:b, :kv] slice is read in
//     place;
//   - one CTA owns one (batch, head) pair.  Its threads form key groups of
//     D * sizeof(T) / 16 lanes, each lane holding 16 bytes of a row, so a
//     group reads one key row with one load per lane.  The CTA walks the keys
//     in blocks of BLOCK_K; within a block the groups take the keys in turn
//     (a few at a time, their loads issued before the math), and each group
//     runs its own online softmax in f32 over the keys it took.  At the end
//     the groups' (m, l, acc) are merged in shared memory with the
//     max/denominator rule;
//   - ragged L is masked inside the kernel, so there is no divisibility rule.
//
// What bounds it: for each allowed key the function reads k and v (4*D bytes
// in bf16) and does about 4*D operations (2*D for q.k, 2*D for p*v), about
// 1 operation per byte, far below Hopper's bf16 line of about 295 operations
// per byte: it is bound by bytes (k and v at the allowed keys, plus q, out,
// the mask and the bias).  At the long-cache shape (B=32, L=4096, H=8, D=64,
// bf16) k and v alone are 2*32*4096*8*64*2 B = 268 MB, about 0.080 ms at
// 3.35 TB/s.  B*H CTAs under-fill the card's 132 SMs at small batch: a 1-row
// beam request has 4 x 8 = 32 CTAs.  Splitting the KV range across CTAs with
// a merge pass (flash-decoding) is the redesign's work, not this version's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;  // 4 warps
constexpr int BLOCK_K = 64;    // keys per block of the CTA's walk
constexpr int MAX_UNROLL = 4;  // keys a group loads before it does their math
constexpr float NEG_INF = -1e30f;

struct DecodeArgs {
  const void* q;         // [B, 1, H, D]
  const void* k;         // [B, L, H, D]
  const void* v;         // [B, L, H, D]
  const int32_t* mask;   // [B, L] or null (every key allowed)
  const float* bias;     // [1|B, H, 1, L] or null (zero)
  void* out;             // contiguous [B, 1, H, D]
  int L, H;
  int64_t q_sb, q_sh;
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int64_t m_sb, m_sl;
  int64_t b_sb, b_sh, b_sl;
  float scale;
};

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

// The 16 / sizeof(T) elements of one 16-byte load, as floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) out[i] = to_f32(e[i]);
}

// Grid: B*H CTAs, one per (batch, head).  Block: NTHREADS.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_decode_kernel(const DecodeArgs a) {
  constexpr int VEC = 16 / sizeof(T);           // elements per lane per row
  constexpr int LANES = D / VEC;                // lanes that share one key row
  constexpr int GROUPS = NTHREADS / LANES;      // keys one pass of the CTA takes
  constexpr int PER_GROUP = BLOCK_K / GROUPS;   // keys per group per block
  constexpr int UNROLL = PER_GROUP < MAX_UNROLL ? PER_GROUP : MAX_UNROLL;
  static_assert(LANES >= 2 && LANES <= 32 && 32 % LANES == 0, "lanes per key");
  static_assert(PER_GROUP >= 1 && PER_GROUP % UNROLL == 0, "keys per group");

  __shared__ float s_acc[GROUPS][D];
  __shared__ float s_m[GROUPS];
  __shared__ float s_l[GROUPS];

  const int tid = threadIdx.x;
  const int g = tid / LANES;
  const int lane = tid % LANES;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int d0 = lane * VEC;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + d0;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + d0;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + d0;
  const int32_t* mp = a.mask == nullptr ? nullptr : a.mask + b * a.m_sb;
  const float* bp = a.bias == nullptr ? nullptr : a.bias + b * a.b_sb + h * a.b_sh;

  float qv[VEC];
  unpack<T>(*reinterpret_cast<const uint4*>(qp), qv);
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] *= a.scale;

  float m = NEG_INF, l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  // The loop bounds are the same for every thread, so the shuffles below
  // run with the whole warp; only the softmax update is predicated.
  for (int k0 = 0; k0 < a.L; k0 += BLOCK_K) {
#pragma unroll
    for (int u0 = 0; u0 < PER_GROUP; u0 += UNROLL) {
      uint4 kraw[UNROLL], vraw[UNROLL];
      bool ok[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = k0 + (u0 + u) * GROUPS + g;
        ok[u] = j < a.L && (mp == nullptr || mp[j * a.m_sl] > 0);
        kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u]) {  // masked keys cost no k/v bytes
          kraw[u] = *reinterpret_cast<const uint4*>(kp + j * a.k_sl);
          vraw[u] = *reinterpret_cast<const uint4*>(vp + j * a.v_sl);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float kv[VEC];
        unpack<T>(kraw[u], kv);
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s = fmaf(qv[i], kv[i], s);
        // Butterfly over the group's lanes: every lane ends with the same sum.
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (ok[u]) {
          const int j = k0 + (u0 + u) * GROUPS + g;
          if (bp != nullptr) s += bp[j * a.b_sl];
          const float m_new = fmaxf(m, s);
          const float corr = expf(m - m_new);
          const float p = expf(s - m_new);
          float vv[VEC];
          unpack<T>(vraw[u], vv);
          l = l * corr + p;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vv[i], acc[i] * corr);
          m = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < VEC; ++i) s_acc[g][d0 + i] = acc[i];
  if (lane == 0) {
    s_m[g] = m;
    s_l[g] = l;
  }
  __syncthreads();
  if (tid < D) {
    // A group that took no allowed key has m = NEG_INF and l = acc = 0, so
    // it adds nothing; if no group did, out = 0 / 1e-30 = 0.
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) mx = fmaxf(mx, s_m[i]);
    float den = 0.f, o = 0.f;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) {
      const float c = expf(s_m[i] - mx);
      den = fmaf(s_l[i], c, den);
      o = fmaf(s_acc[i][tid], c, o);
    }
    T* op = static_cast<T*>(a.out) + (static_cast<int64_t>(b) * a.H + h) * D + tid;
    *op = from_f32<T>(o / fmaxf(den, 1e-30f));
  }
}

template <typename T>
cudaError_t launch_dtype(int D, int B, const DecodeArgs& a, cudaStream_t stream) {
  const dim3 grid(B * a.H);
#define TPP_DECODE_CASE(DIM)                                                \
  case DIM:                                                                 \
    flash_decode_kernel<T, DIM><<<grid, NTHREADS, 0, stream>>>(a);          \
    return cudaGetLastError();
  switch (D) {
    TPP_DECODE_CASE(16)
    TPP_DECODE_CASE(32)
    TPP_DECODE_CASE(64)
    TPP_DECODE_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef TPP_DECODE_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Strides are in elements,
// 13 of them: q (batch, head), k (batch, len, head), v (batch, len, head),
// mask (batch, len), bias (batch, head, len); the last dimension of q/k/v
// must be contiguous and every q/k/v row 16-byte aligned.  mask is int32 or
// null (every key allowed), bias float32 or null (zero).  out is a contiguous
// [B, 1, H, D] tensor of the input dtype.  Returns the cudaError_t of the
// launch.
extern "C" int tpp_flash_decode(const void* q, const void* k, const void* v,
                                const void* mask, const void* bias, void* out,
                                int dtype, int B, int L, int H, int D,
                                const int64_t* strides, float scale, void* stream) {
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const int32_t*>(mask);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.L = L;
  a.H = H;
  a.q_sb = strides[0];
  a.q_sh = strides[1];
  a.k_sb = strides[2];
  a.k_sl = strides[3];
  a.k_sh = strides[4];
  a.v_sb = strides[5];
  a.v_sl = strides[6];
  a.v_sh = strides[7];
  a.m_sb = strides[8];
  a.m_sl = strides[9];
  a.b_sb = strides[10];
  a.b_sh = strides[11];
  a.b_sl = strides[12];
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dtype<float>(D, B, a, s);
    case 1:
      return launch_dtype<__half>(D, B, a, s);
    case 2:
      return launch_dtype<__nv_bfloat16>(D, B, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
