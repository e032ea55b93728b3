// Flash-attention backward for Hopper (sm_90a): the gradients of
// blockwise online-softmax self-attention with respect to q, k and v,
// recomputed from the forward's per-row log-sum-exp.
//
// Two kernels for each route, as the TPU reference has (no atomics, so
// every gradient is the same bit for bit from run to run):
//   - dq replaces tpu_pipelines/ops/flash_attention.py:_dq_kernel.  One CTA
//     per (batch*head, q-block) loops over key blocks and accumulates
//     dQ = scale * dS K, with
//       s  = scale * q k^T,
//       p  = allowed ? exp(s - lse) : 0,
//       dS = p * (dO v^T - Dvec);
//   - dkv replaces _dkv_kernel.  One CTA per (batch*head, key block)
//     keeps its K and V rows in shared memory, loops over q-blocks
//     (streaming Q, dO, lse and Dvec) and accumulates dV = P^T dO and
//     dK = scale * dS^T Q;
//   - flash_bwd_dvec_kernel computes Dvec = rowsum(dO * O) in f32, laid out
//     [B*H, L] like lse (the reference computes it with jnp before its
//     pallas_calls).
//
// Semantics kept from the TPU kernels: a key is allowed iff it lies inside
// the sequence, its mask entry is > 0 and (when causal) its position is <=
// the query's; p is a select on that set, never a product with it, because
// an all-masked row has lse = -1e30 and exp(s - lse) overflows there.  Such
// a row gets dq = 0 and adds nothing to dk or dv.  Gradients are written in
// the input dtype.  q, k, v and dO are read as [B, L, H, D] through their
// strides and the [B, L] mask directly (the TPU path transposes four
// tensors to [B*H, L, D] and repeats the mask per head); a CTA's loop takes
// the place of the TPU's sequential grid axis; ragged L is masked in the
// kernel; blocks above the causal diagonal are skipped (_causal_live).
//
// What bounds them: at the BERT-base training shape (B=256, L=128, H=12,
// D=64, bf16, ragged lengths) dq must read q and dO, k and v at the allowed
// keys, lse and Dvec, and write dq: ~0.06 ms of bytes at 3.35 TB/s against
// ~10 GFLOP of products (~0.01 ms on the bf16 tensor cores); dkv reads the
// same and writes dk and dv.  Both are bound by bytes once their products
// run on the tensor cores.
//
// Block configurations.  The bf16 and fp16 kernels are built once per block
// pair (BQ query rows, BK keys; both kernels take the same pair, as the
// reference's do), each pair a translation unit and a library of its own
// (-DTPP_BQ=.. -DTPP_BK=..; ops/_build.py, ops/flash_attention.py
// FLASH_BLOCKS): BQ in {64, 128}, BK in {32, 64, 128}, at head dims 64 and
// 128; the default 64 x 64 library also holds D = 16 and 32, the f32
// kernels (which keep 64 x 64) and Dvec.  The C entries take the pair and
// refuse any other than their library's.
//
// bf16 and fp16: the tensor-core kernels (flash_bwd_dq_mma_kernel,
// flash_bwd_dkv_mma_kernel).  One warp per 16 rows of the CTA's block (the
// q-block's rows for dq, BQ/16 warps; the key block's for dkv, BK/16
// warps); every product is mma.sync m16n8k16 with f32 accumulation, its
// operands read from shared memory by ldmatrix (.trans where the product
// needs the tile transposed).  Tiles stay in the input dtype with an XOR
// swizzle on 16-byte chunks, so ldmatrix and the cp.async writes are free
// of bank conflicts.  The streamed tiles (K, V for dq; Q, dO, lse, Dvec for
// dkv) go through a two-stage ring of 16-byte cp.async.cg copies: block
// j+1 is in flight while block j is computed.  The scores are computed in
// the orientation whose accumulator layout is the A operand of the second
// product: dq computes S = Q K^T and dP = dO V^T, then dS (16 rows x 32
// keys per warp and chunk) becomes the A fragments of dQ += dS K in
// registers; dkv computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T
// feed dV += P^T dO and dK += dS^T Q directly.  p and dS never touch shared
// memory.  p and dS are rounded to the input dtype for the second
// products, as SDPA and dense bf16 attention do (the plain versions keep
// them in f32; the checks bound the difference per element).  Blocks are
// skipped from the mask itself, not from a length: dq reads the CTA's
// batch row of the mask once into a bit set and skips key blocks with no
// allowed key; a dkv CTA whose own keys are all masked writes zeros and
// returns.  Registers, not shared memory, limit how many CTAs share an
// SM, so each block is computed in chunks of 32 keys (dq) or
// queries (dkv; 16 at D = 128, where dK and dV alone take 128 registers a
// thread): only one chunk's S, dP and A fragments are live at a time, and
// the launch bounds ask for 4 (dq) and 3 (dkv) CTAs of 4 warps per SM at
// D <= 64 (as many registers a thread for other warp counts).
// exp is the SFU's ex2.approx on log2e-scaled scores.  mma.sync and
// cp.async rather than wgmma and TMA: at the training shape the products
// need ~20% of the tensor cores' peak to stay under the byte bound, and
// the inputs are strided [B, L, H, D] views that TMA would need a tensor
// map (and -lcuda) for.
//
// f32: the FMA kernels below (flash_bwd_dq_kernel, flash_bwd_dkv_kernel):
// every product and sum in f32 from shared memory staged as f32, 4 x 8
// register tiles per thread, row strides padded against bank conflicts.
// f32 is the dtype the tolerance checks against dense attention run in,
// and TF32 tensor cores would break them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_sm90.cuh"

#ifndef TPP_BQ
#define TPP_BQ 64
#endif
#ifndef TPP_BK
#define TPP_BK 64
#endif

namespace {

constexpr int BQ = TPP_BQ;  // query rows per block
constexpr int BK = TPP_BK;  // keys per block
static_assert((BQ == 64 || BQ == 128) && (BK == 32 || BK == 64 || BK == 128),
              "block configuration");
// The default configuration's library also builds D = 16 and 32, the f32
// kernels and Dvec; every other one builds the 16-bit kernels at D = 64
// and 128.
constexpr bool DEFAULT_BLOCKS = BQ == 64 && BK == 64;

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

// ------------------------------------------------- bf16 / fp16: tensor cores

// The helpers (Tc, ldmatrix, cp.async, swizzled tiles) are in tc_sm90.cuh.

// CTAs of 4 warps per SM the launch bounds ask registers for at D <= 64:
// dq 4 (128 registers a thread), dk/dv 3 (168).  Left to itself the
// compiler takes 180-200 registers, so only 2 CTAs (8 warps) share an SM to
// hide the copies' latency, and both kernels ran slower on the card that
// way.  A CTA of another warp count asks for the same registers a thread
// (dk/dv at 8 warps: no bound, one such CTA an SM).
constexpr int DQ_MIN_CTAS = 4;
constexpr int DKV_MIN_CTAS = 3;
constexpr int DQ_THREADS = BQ / 16 * 32;
constexpr int DKV_THREADS = BK / 16 * 32;

template <int D>
constexpr int dq_mma_smem_bytes() {
  // sQ, sdO (BQ rows) and two stages of sK, sV (BK rows); the mask bit set
  // (ceil(L / 32) words) is added at launch.
  return (2 * BQ + 4 * BK) * D * 2;
}

// Grid: x = batch*head, y = q-block.  Block: DQ_THREADS.  Warp w owns rows
// 16w .. 16w+15 of the q-block; in the m16n8 layouts a thread holds rows
// g = lane/4 and g + 8 and columns 2*(lane%4) + {0, 1} of each 8-column
// tile.
template <typename T, int D>
__global__ void __launch_bounds__(DQ_THREADS,
                                  D <= 64 ? DQ_MIN_CTAS * NTHREADS / DQ_THREADS : 1)
    flash_bwd_dq_mma_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  constexpr int QT = BQ * D * 2;  // bytes of the Q (dO) tile
  constexpr int KT = BK * D * 2;  // bytes of one K (V) tile
  constexpr int KD = D / 16;      // k-steps over the head dim
  constexpr int NT = DQ_THREADS;
  const uint32_t sbase = smem_u32(tc_smem);
  const uint32_t sQ = sbase, sdO = sbase + QT;
  unsigned* sBits = reinterpret_cast<unsigned*>(tc_smem + 2 * QT + 4 * KT);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
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

  // Q and dO start on their way while the mask is read.
  load_tile<D, BQ, NT>(sQ, qp, a.q_sl, q0, L);
  load_tile<D, BQ, NT>(sdO, op, a.o_sl, q0, L);

  // The batch row's allowed keys as a bit set (bit k%32 of word k/32); bits
  // past L stay 0.  A key block is live iff one of its BK/32 words is not 0.
  const int nwords = (L + 31) / 32;
  for (int base = warp * 32; base < L; base += NT) {
    const int key = base + lane;
    const bool ok = key < L && (mp == nullptr || mp[key] > 0);
    const unsigned bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) sBits[base / 32] = bits;
  }
  int n_kv = (L + BK - 1) / BK;
  if (a.causal) {
    // _causal_live: kv-block kb is live iff kb*BK <= q0 + BQ - 1.
    const int last_live = (q0 + BQ - 1) / BK + 1;
    n_kv = n_kv < last_live ? n_kv : last_live;
  }
  __syncthreads();
  auto word = [&](int w) { return w < nwords ? sBits[w] : 0u; };
  auto live = [&](int kb) {
    unsigned any = 0u;
#pragma unroll
    for (int i = 0; i < BK / 32; ++i) any |= word(kb * (BK / 32) + i);
    return any != 0u;
  };
  auto next_live = [&](int kb) {
    while (kb < n_kv && !live(kb)) ++kb;
    return kb;
  };
  auto load_kv = [&](int kb, int stage) {
    const uint32_t sK = sbase + 2 * QT + 2 * stage * KT;
    load_tile<D, BK, NT>(sK, kp, a.k_sl, kb * BK, L);
    load_tile<D, BK, NT>(sK + KT, vp, a.v_sl, kb * BK, L);
    cp_async_commit();
  };

  int kb = next_live(0);
  if (kb < n_kv) load_kv(kb, 0);  // one commit group with Q and dO

  // This thread's two query rows: lse (in log2 units) and Dvec.
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], dvr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = rows[i] < L ? lp[rows[i]] * LOG2E : 0.f;
    dvr[i] = rows[i] < L ? dp_vec[rows[i]] : 0.f;
  }
  const float sl2 = a.scale * LOG2E;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int stage = 0;
  while (kb < n_kv) {
    cp_async_wait_all();
    __syncthreads();  // block kb landed; every warp is done with the other stage
    const int nxt = next_live(kb + 1);
    if (nxt < n_kv) load_kv(nxt, stage ^ 1);
    const uint32_t sK = sbase + 2 * QT + 2 * stage * KT, sV = sK + KT;

    // The block in chunks of 32 keys (one mask word each), so that a
    // chunk's S, dP and dS fragments are all a thread keeps live.
#pragma unroll 1
    for (int ch = 0; ch < BK / 32; ++ch) {
      // S = Q K^T and dP = dO V^T: 16 rows x 32 keys per warp.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KD; ++kc) {
        uint32_t aq[4], ao[4];
        const uint32_t arow = tile_off<D>(warp * 16 + (lane & 15), 2 * kc + (lane >> 4));
        ldsm_x4(aq, sQ + arow);
        ldsm_x4(ao, sdO + arow);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const uint32_t brow = tile_off<D>(32 * ch + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                            2 * kc + ((lane >> 3) & 1));
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, sK + brow);
          ldsm_x4(bv, sV + brow);
          Tc<T>::mma(s[2 * np], aq, bk[0], bk[1]);
          Tc<T>::mma(s[2 * np + 1], aq, bk[2], bk[3]);
          Tc<T>::mma(dp[2 * np], ao, bv[0], bv[1]);
          Tc<T>::mma(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
      }

      // p and dS in f32; dS rounded into the A fragments of dQ += dS K
      // (key step kk takes column tiles 2kk and 2kk + 1).
      const int c0 = kb * BK + 32 * ch;  // the chunk's first key
      const unsigned w = word(c0 / 32);
      uint32_t ads[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const int row = rows[e >> 1];
          const bool ok = ((w >> c) & 1u) != 0u && row < L && (!a.causal || row >= c0 + c);
          const float p = ok ? exp2_approx(fmaf(s[j][e], sl2, -lse2[e >> 1])) : 0.f;
          ds[e] = p * (dp[j][e] - dvr[e >> 1]);
        }
        ads[j / 2][(j % 2) * 2] = Tc<T>::pack(ds[0], ds[1]);
        ads[j / 2][(j % 2) * 2 + 1] = Tc<T>::pack(ds[2], ds[3]);
      }

      // dQ += dS K: K read transposed (keys are the reduction dim).
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int dn = 0; dn < KD; ++dn) {
          uint32_t bk[4];
          ldsm_x4_t(bk, sK + tile_off<D>(32 * ch + kk * 16 + (lane & 7) +
                                             (((lane >> 3) & 1) << 3),
                                         2 * dn + (lane >> 4)));
          Tc<T>::mma(acc[2 * dn], ads[kk], bk[0], bk[1]);
          Tc<T>::mma(acc[2 * dn + 1], ads[kk], bk[2], bk[3]);
        }
      }
    }
    kb = nxt;
    stage ^= 1;
  }

  // scale * dQ through the sQ tile, then 16-byte stores.
  cp_async_wait_all();
  __syncthreads();
  acc_to_tile<T, D>(tc_smem, acc, warp * 16, a.scale);
  __syncthreads();
  store_tile<D, BQ, NT>(static_cast<T*>(a.dq), tc_smem, b, q0, L, a.H, h);
}

template <int D>
constexpr int dkv_mma_smem_bytes() {
  // sK, sV; two stages of sQ, sdO; two stages of lse and Dvec (f32).
  return 2 * BK * D * 2 + 4 * BQ * D * 2 + 4 * BQ * 4;
}

// Grid: x = batch*head, y = kv-block.  Block: DKV_THREADS.  Warp w owns
// keys 16w .. 16w+15 of the kv-block (the rows of S^T, dP^T, dK and dV).
template <typename T, int D>
__global__ void __launch_bounds__(
    DKV_THREADS, D <= 64 && DKV_MIN_CTAS * NTHREADS / DKV_THREADS > 1
                     ? DKV_MIN_CTAS * NTHREADS / DKV_THREADS : 1)
    flash_bwd_dkv_mma_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  constexpr int QB = BQ;
  // Queries per chunk: 16 at D = 128, where dK and dV alone take 128
  // registers a thread.
  constexpr int CW = D == 128 ? 16 : 32;
  constexpr int KT = BK * D * 2;  // bytes of the K (V) tile
  constexpr int QT = QB * D * 2;  // bytes of one Q (dO) tile
  constexpr int KD = D / 16;
  constexpr int NT = DKV_THREADS;
  const uint32_t sbase = smem_u32(tc_smem);
  const uint32_t sK = sbase, sV = sbase + KT;
  float* sRow = reinterpret_cast<float*>(tc_smem + 2 * KT + 4 * QT);  // [2][lse, Dvec][QB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
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
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);

  // A key block with no allowed key gets nothing from any query.
  const int my_key = k0 + tid;
  const bool mine = tid < BK && my_key < L && (mp == nullptr || mp[my_key] > 0);
  if (!__syncthreads_or(mine)) {
    constexpr int CH = D / 8;
    for (int i = tid; i < BK * CH; i += NT) {
      const int row = k0 + i / CH;
      if (row >= L) continue;
      const int64_t at = ((static_cast<int64_t>(b) * L + row) * a.H + h) * D + (i % CH) * 8;
      *reinterpret_cast<uint4*>(dkp + at) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dvp + at) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  load_tile<D, BK, NT>(sK, kp, a.k_sl, k0, L);
  load_tile<D, BK, NT>(sV, vp, a.v_sl, k0, L);
  auto load_q = [&](int qb, int stage) {
    const int q0 = qb * QB;
    const uint32_t sQ = sbase + 2 * KT + stage * 2 * QT;
    load_tile<D, QB, NT>(sQ, qp, a.q_sl, q0, L);
    load_tile<D, QB, NT>(sQ + QT, op, a.o_sl, q0, L);
    const uint32_t srow = smem_u32(sRow + stage * 2 * QB);
    for (int i = tid; i < QB; i += NT) {
      const int row = q0 + i;
      const int at = row < L ? row : 0;
      cp_async4(srow + 4 * i, lp + at, row < L ? 4 : 0);
      cp_async4(srow + 4 * (QB + i), dp_vec + at, row < L ? 4 : 0);
    }
    cp_async_commit();
  };

  const int n_q = (L + QB - 1) / QB;
  // _causal_live: q-block qb is live iff k0 <= qb*QB + QB - 1.
  int qb = a.causal ? k0 / QB : 0;
  load_q(qb, 0);

  // This thread's two keys.
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    key_ok[i] = keys[i] < L && (mp == nullptr || mp[keys[i]] > 0);
  const float sl2 = a.scale * LOG2E;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  int stage = 0;
  for (; qb < n_q; ++qb) {
    cp_async_wait_all();
    __syncthreads();  // block qb landed; every warp is done with the other stage
    if (qb + 1 < n_q) load_q(qb + 1, stage ^ 1);
    const uint32_t sQ = sbase + 2 * KT + stage * 2 * QT, sdO = sQ + QT;
    const float* lse_s = sRow + stage * 2 * QB;
    const float* dvec_s = lse_s + QB;
    const int q0 = qb * QB;

    // The block in chunks of CW queries, as in the dq kernel.
#pragma unroll 1
    for (int ch = 0; ch < QB / CW; ++ch) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x CW queries per warp.
      float s[CW / 8][4], dp[CW / 8][4];
#pragma unroll
      for (int j = 0; j < CW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KD; ++kc) {
        uint32_t ak[4], av[4];
        const uint32_t arow = tile_off<D>(warp * 16 + (lane & 15), 2 * kc + (lane >> 4));
        ldsm_x4(ak, sK + arow);
        ldsm_x4(av, sV + arow);
#pragma unroll
        for (int np = 0; np < CW / 16; ++np) {
          const uint32_t brow = tile_off<D>(CW * ch + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                            2 * kc + ((lane >> 3) & 1));
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, sQ + brow);
          ldsm_x4(bo, sdO + brow);
          Tc<T>::mma(s[2 * np], ak, bq[0], bq[1]);
          Tc<T>::mma(s[2 * np + 1], ak, bq[2], bq[3]);
          Tc<T>::mma(dp[2 * np], av, bo[0], bo[1]);
          Tc<T>::mma(dp[2 * np + 1], av, bo[2], bo[3]);
        }
      }

      // P^T and dS^T in f32, rounded into the A fragments of the second
      // products (query step kk takes column tiles 2kk and 2kk + 1).
      uint32_t ap[CW / 16][4], ads[CW / 16][4];
#pragma unroll
      for (int j = 0; j < CW / 8; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = CW * ch + 8 * j + 2 * t + (e & 1);
          const int query = q0 + c;
          const int key = keys[e >> 1];
          const bool ok = key_ok[e >> 1] && query < L && (!a.causal || query >= key);
          p[e] = ok ? exp2_approx(fmaf(s[j][e], sl2, -lse_s[c] * LOG2E)) : 0.f;
          ds[e] = p[e] * (dp[j][e] - dvec_s[c]);
        }
        ap[j / 2][(j % 2) * 2] = Tc<T>::pack(p[0], p[1]);
        ap[j / 2][(j % 2) * 2 + 1] = Tc<T>::pack(p[2], p[3]);
        ads[j / 2][(j % 2) * 2] = Tc<T>::pack(ds[0], ds[1]);
        ads[j / 2][(j % 2) * 2 + 1] = Tc<T>::pack(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q read transposed.
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk) {
#pragma unroll
        for (int dn = 0; dn < KD; ++dn) {
          const uint32_t brow = tile_off<D>(CW * ch + kk * 16 + (lane & 7) +
                                                (((lane >> 3) & 1) << 3),
                                            2 * dn + (lane >> 4));
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, sdO + brow);
          ldsm_x4_t(bq, sQ + brow);
          Tc<T>::mma(dv[2 * dn], ap[kk], bo[0], bo[1]);
          Tc<T>::mma(dv[2 * dn + 1], ap[kk], bo[2], bo[3]);
          Tc<T>::mma(dk[2 * dn], ads[kk], bq[0], bq[1]);
          Tc<T>::mma(dk[2 * dn + 1], ads[kk], bq[2], bq[3]);
        }
      }
    }
    stage ^= 1;
  }

  // scale * dK and dV through the sK and sV tiles, then 16-byte stores.
  __syncthreads();
  acc_to_tile<T, D>(tc_smem, dk, warp * 16, a.scale);
  acc_to_tile<T, D>(tc_smem + KT, dv, warp * 16, 1.f);
  __syncthreads();
  store_tile<D, BK, NT>(dkp, tc_smem, b, k0, L, a.H, h);
  store_tile<D, BK, NT>(dvp, tc_smem + KT, b, k0, L, a.H, h);
}

// Dvec = rowsum(dO * O), f32, out [B*H, L].  Each row of D elements is read
// by LANES = D * sizeof(T) / 16 neighbouring lanes, one 16-byte load of O
// and of dO each, and reduced with shuffles; rows are taken in [B, L, H]
// order so that neighbouring lanes read neighbouring bytes.
constexpr int DVEC_THREADS = 256;

template <typename T, int D>
__global__ void __launch_bounds__(DVEC_THREADS)
    flash_bwd_dvec_kernel(const T* o, const T* dout, float* dvec, int L, int H, int64_t rows,
                          int64_t o_sb, int64_t o_sl, int64_t o_sh, int64_t g_sb, int64_t g_sl,
                          int64_t g_sh) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int LANES = D / VEC;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * DVEC_THREADS + threadIdx.x;
  const int64_t row = i / LANES;
  const int part = static_cast<int>(i % LANES);
  const int h = static_cast<int>(row % H);
  const int l = static_cast<int>((row / H) % L);
  const int64_t b = row / (static_cast<int64_t>(H) * L);
  float sum = 0.f;
  if (row < rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * o_sb + l * o_sl + h * o_sh +
                                                     part * VEC);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + b * g_sb + l * g_sl + h * g_sh +
                                                     part * VEC);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) sum = fmaf(to_f32(ge[e]), to_f32(oe[e]), sum);
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && part == 0) dvec[(b * H + h) * L + l] = sum;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, dim3 grid, const BwdArgs& a,
                   cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory a kernel must opt in; set on every
  // launch so that each device the caller uses gets the attribute.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, int B, cudaStream_t stream) {
  return launch(flash_bwd_dq_kernel<T, D>, NTHREADS, dq_smem_floats<D>() * sizeof(float),
                dim3(B * a.H, (a.L + BQ - 1) / BQ), a, stream);
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, int B, cudaStream_t stream) {
  return launch(flash_bwd_dkv_kernel<T, D>, NTHREADS, dkv_smem_floats<D>() * sizeof(float),
                dim3(B * a.H, (a.L + BK - 1) / BK), a, stream);
}

template <typename T, int D>
cudaError_t launch_dq_mma(const BwdArgs& a, int B, cudaStream_t stream) {
  const size_t bits = static_cast<size_t>((a.L + 31) / 32) * sizeof(unsigned);
  return launch(flash_bwd_dq_mma_kernel<T, D>, DQ_THREADS, dq_mma_smem_bytes<D>() + bits,
                dim3(B * a.H, (a.L + BQ - 1) / BQ), a, stream);
}

template <typename T, int D>
cudaError_t launch_dkv_mma(const BwdArgs& a, int B, cudaStream_t stream) {
  return launch(flash_bwd_dkv_mma_kernel<T, D>, DKV_THREADS, dkv_mma_smem_bytes<D>(),
                dim3(B * a.H, (a.L + BK - 1) / BK), a, stream);
}

// Whether this library builds (T, D): every dtype and head dim at 64 x 64;
// bf16 and fp16 at D = 64 and 128 in the other configurations, where both
// kernels' fixed tiles fit the shared memory a block may opt into.
template <typename T, int D>
constexpr bool built() {
  if constexpr (std::is_same<T, float>::value) {
    return DEFAULT_BLOCKS;
  } else {
    return (DEFAULT_BLOCKS || D >= 64) && dq_mma_smem_bytes<D>() <= MAX_SMEM &&
           dkv_mma_smem_bytes<D>() <= MAX_SMEM;
  }
}

// One instantiation per (route, head dim); which = 0 for dq, 1 for dk/dv.
// f32 takes the FMA kernels, bf16 and fp16 the tensor-core kernels.
template <typename T>
cudaError_t dispatch_dim(int which, int D, const BwdArgs& a, int B, cudaStream_t s) {
  constexpr bool kFma = std::is_same<T, float>::value;
#define TPP_BWD_CASE(DIM)                                                        \
  case DIM:                                                                      \
    if constexpr (!built<T, DIM>()) {                                            \
      return cudaErrorInvalidValue;                                              \
    } else if constexpr (kFma) {                                                 \
      return which == 0 ? launch_dq<T, DIM>(a, B, s) : launch_dkv<T, DIM>(a, B, s); \
    } else {                                                                     \
      return which == 0 ? launch_dq_mma<T, DIM>(a, B, s)                         \
                        : launch_dkv_mma<T, DIM>(a, B, s);                       \
    }
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

// Registers and local memory (spills) a thread of the kernel that
// dispatch_dim would launch, and its dynamic shared memory at length L.
template <typename T, int D>
cudaError_t kernel_info(int which, int L, int* info) {
  if constexpr (!built<T, D>()) {
    return cudaErrorInvalidValue;
  } else {
    cudaFuncAttributes attr;
    cudaError_t err;
    size_t smem;
    if constexpr (std::is_same<T, float>::value) {
      err = which == 0 ? cudaFuncGetAttributes(&attr, flash_bwd_dq_kernel<T, D>)
                       : cudaFuncGetAttributes(&attr, flash_bwd_dkv_kernel<T, D>);
      smem = (which == 0 ? dq_smem_floats<D>() : dkv_smem_floats<D>()) * sizeof(float);
    } else {
      err = which == 0 ? cudaFuncGetAttributes(&attr, flash_bwd_dq_mma_kernel<T, D>)
                       : cudaFuncGetAttributes(&attr, flash_bwd_dkv_mma_kernel<T, D>);
      smem = which == 0 ? dq_mma_smem_bytes<D>() + ((L + 31) / 32) * sizeof(unsigned)
                        : dkv_mma_smem_bytes<D>();
    }
    info[0] = attr.numRegs;
    info[1] = static_cast<int>(attr.localSizeBytes);
    info[2] = static_cast<int>(smem);
    return err;
  }
}

template <typename T>
cudaError_t info_dim(int which, int D, int L, int* info) {
  switch (D) {
    case 16:
      return kernel_info<T, 16>(which, L, info);
    case 32:
      return kernel_info<T, 32>(which, L, info);
    case 64:
      return kernel_info<T, 64>(which, L, info);
    case 128:
      return kernel_info<T, 128>(which, L, info);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t launch_dvec(const void* o, const void* dout, void* dvec, int B, int L, int H,
                        const int64_t* st, cudaStream_t stream) {
  if constexpr (!DEFAULT_BLOCKS) {
    return cudaErrorInvalidValue;  // Dvec is built in the 64 x 64 library only
  } else {
    constexpr int LANES = D * static_cast<int>(sizeof(T)) / 16;
    const int64_t rows = static_cast<int64_t>(B) * L * H;
    const int64_t blocks = (rows * LANES + DVEC_THREADS - 1) / DVEC_THREADS;
    flash_bwd_dvec_kernel<T, D><<<static_cast<unsigned>(blocks), DVEC_THREADS, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(dvec), L,
        H, rows, st[0], st[1], st[2], st[3], st[4], st[5]);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_dvec(int D, const void* o, const void* dout, void* dvec, int B, int L,
                          int H, const int64_t* st, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_dvec<T, 16>(o, dout, dvec, B, L, H, st, s);
    case 32:
      return launch_dvec<T, 32>(o, dout, dvec, B, L, H, st, s);
    case 64:
      return launch_dvec<T, 64>(o, dout, dvec, B, L, H, st, s);
    case 128:
      return launch_dvec<T, 128>(o, dout, dvec, B, L, H, st, s);
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

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  block_q x block_k must be
// this library's configuration (TPP_BQ x TPP_BK) and (dtype, D) built in
// it, else cudaErrorInvalidValue.  strides: 12 int64 in
// elements, (batch, len, head) of q, k, v and dout in that order; the last
// dimension of each must be contiguous, and for float16 / bfloat16 every
// row must start on a 16-byte boundary.  mask is [B, L] int32 or null;
// lse and dvec are contiguous [B*H, L] float32; dq (dk, dv) are contiguous
// [B, L, H, D] tensors of the input dtype.  Each returns the cudaError_t of
// its launch.
extern "C" int tpp_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* mask, const void* lse,
                                const void* dvec, void* dq, int dtype, int B, int L,
                                int H, int D, const int64_t* strides, int causal,
                                float scale, int block_q, int block_k, void* stream) {
  if (block_q != BQ || block_k != BK) return cudaErrorInvalidValue;
  const BwdArgs a = pack(q, k, v, dout, mask, lse, dvec, dq, nullptr, nullptr, L, H,
                         strides, causal, scale);
  return dispatch(0, dtype, D, a, B, stream);
}

extern "C" int tpp_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* mask, const void* lse,
                                 const void* dvec, void* dk, void* dv, int dtype, int B,
                                 int L, int H, int D, const int64_t* strides, int causal,
                                 float scale, int block_q, int block_k, void* stream) {
  if (block_q != BQ || block_k != BK) return cudaErrorInvalidValue;
  const BwdArgs a = pack(q, k, v, dout, mask, lse, dvec, nullptr, dk, dv, L, H,
                         strides, causal, scale);
  return dispatch(1, dtype, D, a, B, stream);
}

// Dvec of out and dout ([B, L, H, D] of one dtype, rows on 16-byte
// boundaries, last dim contiguous) into a contiguous float32 [B*H, L]; in
// the 64 x 64 library only.
// strides: 6 int64 in elements, (batch, len, head) of out, then of dout.
extern "C" int tpp_flash_bwd_dvec(const void* out, const void* dout, void* dvec, int dtype,
                                  int B, int L, int H, int D, const int64_t* strides,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dvec<float>(D, out, dout, dvec, B, L, H, strides, s);
    case 1:
      return dispatch_dvec<__half>(D, out, dout, dvec, B, L, H, strides, s);
    case 2:
      return dispatch_dvec<__nv_bfloat16>(D, out, dout, dvec, B, L, H, strides, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Resources of the dq (which = 0) or dk/dv (which = 1) kernel for dtype,
// head dim D and block_q x block_k (this library's configuration): info[0]
// registers a thread, info[1] local memory bytes a thread (spills), info[2]
// dynamic shared memory bytes at length L.
extern "C" int tpp_flash_bwd_kernel_info(int which, int dtype, int D, int L, int block_q,
                                         int block_k, int* info) {
  if (block_q != BQ || block_k != BK) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return info_dim<float>(which, D, L, info);
    case 1:
      return info_dim<__half>(which, D, L, info);
    case 2:
      return info_dim<__nv_bfloat16>(which, D, L, info);
    default:
      return cudaErrorInvalidValue;
  }
}
