// Flash-attention forward for Hopper (sm_90a): blockwise online-softmax
// self-attention with key padding, optional causal masking and a per-row
// log-sum-exp output.
//
// Replaces tpu_pipelines/ops/flash_attention.py:_fwd_kernel (the Pallas TPU
// kernel driven by _flash_forward).  It computes the same function:
//   - s = D^-0.5 * q k^T, with f32 products and sums;
//   - a key is allowed iff it lies inside the sequence, its mask entry is
//     > 0 and (when causal) its position is <= the query's;
//   - m, l and the output accumulator follow the online-softmax recurrence;
//     a row with no allowed key outputs exactly 0 and lse = -1e30, as the
//     reference does;
//   - out is written in the input dtype, lse in f32 (natural log) as
//     [B*H, L].
//
// What differs from the TPU kernel, and why:
//   - q/k/v are read as [B, L, H, D] through their strides (last dim
//     contiguous) instead of a transposed [B*H, L, D] copy, and the [B, L]
//     mask is read directly instead of being repeated per head;
//   - one CTA owns one (batch*head, 64-row q-block) pair and loops over
//     64-key blocks (the TPU's sequential grid axis); blocks above the
//     causal diagonal are skipped;
//   - ragged L is masked inside the kernel, so there is no divisibility rule.
//
// What bounds it: at the BERT-base shapes (L=128, H=12, D=64, bf16; B=32
// serving, B=256 training, ragged lengths) the function must read q, write
// out and lse, and read k and v only at allowed keys: ~19 MB at B=32, about
// 5.4 us at 3.35 TB/s.  Its products, 4*H*D*L per allowed key (~1 GFLOP at
// B=32), take ~1 us on the bf16 tensor cores but ~15 us at the 67 TFLOP/s
// f32 FMA rate.  So the 16-bit route runs its products on the tensor cores
// and is bound by bytes.
//
// bf16 and fp16: flash_fwd_mma_kernel.  4 warps; warp w owns q rows 16w ..
// 16w+15 of the CTA's block, and the q-blocks of one batch*head run in
// neighbouring CTAs so that K and V come from memory once.  Q comes in once
// by cp.async into a swizzled tile and its A fragments stay in registers; K
// and V stream in 64-key blocks through a two-stage ring of 16-byte
// cp.async.cg copies, so block j+1 is in flight while block j is computed.
// The CTA reads its batch row of the mask once into a bit set (a warp ballot
// per 32 keys) and skips every 64-key block with no allowed key, so the
// bytes of masked padding are never read; block 0 is asked for before the
// mask is read (it is live for nearly every row), and dropped if it is dead.
// S = Q K^T is mma.sync m16n8k16 with f32 accumulation, 32 keys at a time:
// each 32-key chunk is one step of the online softmax on the S accumulators
// in registers (a 64-key step made the kernel spill at every D <= 64).  A
// thread holds two rows of the m16n8 layout; its lanes' allowed keys come
// from one mask word as a per-thread bit set, the mask is a select before
// the max, and a row's max is taken across its quad of 4 lanes with 2
// shuffles (no shared memory, no barrier); p = 2^(log2e * (s - m) * scale)
// by the SFU; O is rescaled once per chunk.  l is summed in f32 from the
// unrounded p (each lane its share, the quad's shares added at the end).
// p is rounded to the input dtype straight into the A fragments of
// O += P V, V read by ldmatrix.trans: S and P never touch shared memory,
// and the only barrier per block is the ring's.  The epilogue writes O / l through the Q
// tile (swizzled) with 16-byte stores, and lse = m * scale + log(l) in
// natural units (exactly -1e30 for a row with no allowed key, including one
// whose every block was skipped).  m is kept as the raw score q.k, so no
// log2 <-> natural conversion touches lse.  Rounding p before P V is what
// SDPA and dense bf16 attention do; the plain version keeps p in f32, and
// the check bounds the difference per element (ops/flash_attention.py:
// fwd_rounding_terms).  mma.sync and cp.async rather than wgmma and TMA: the
// products need under 10% of the tensor cores' peak to stay under the byte
// bound, and the inputs are strided [B, L, H, D] views that TMA would need a
// tensor map (and -lcuda) for.
//
// f32: flash_fwd_kernel, every product an f32 FMA from shared memory staged
// as f32 (4 x 8 register tiles per thread, padded rows against bank
// conflicts) and an online softmax through shared memory.  f32 is the
// dtype the checks against dense attention run in; TF32 tensor cores would
// break them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------ f32: FMAs

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

// ------------------------------------------------- bf16 / fp16: tensor cores

// CTAs per SM the launch bounds ask registers for at D <= 64 (128
// registers a thread); shared memory (five 64-row tiles, 40 KB at D = 64)
// would let 5 fit, but at 96 registers a thread the kernel spills.
constexpr int FWD_MIN_CTAS = 4;
// Keys per online-softmax step: with 64 (a whole ring block) S and P take
// 48 registers a thread, and the kernel spilled at every D <= 64.
constexpr int CK = 32;

template <int D>
constexpr int fwd_mma_smem_bytes() {
  // sQ and two stages of sK, sV: five 64-row tiles; the mask bit set
  // (ceil(L / 32) words) is added at launch.
  return 5 * BQ * D * 2;
}

// Grid: one CTA per (batch*head, q-block), x = batch*head * n_q + q-block:
// the q-blocks of one batch*head run next to each other, so the second
// CTA to read a K/V block finds it in L2.  Block: NTHREADS.  Warp w owns
// rows 16w .. 16w+15 of the q-block; in the m16n8 layouts a thread holds
// rows g = lane/4 and g + 8 and columns 2*(lane%4) + {0, 1} of each
// 8-column tile.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, D <= 64 ? FWD_MIN_CTAS : 1)
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int32_t* __restrict__ mask,
                         T* __restrict__ out, float* __restrict__ lse,
                         int L, int H,
                         int64_t q_sb, int64_t q_sl, int64_t q_sh,
                         int64_t k_sb, int64_t k_sl, int64_t k_sh,
                         int64_t v_sb, int64_t v_sl, int64_t v_sh,
                         int causal, float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  constexpr int TILE = BQ * D * 2;
  constexpr int KD = D / 16;  // k-steps over the head dim
  const uint32_t sbase = smem_u32(tc_smem);
  const uint32_t sQ = sbase;
  unsigned* sBits = reinterpret_cast<unsigned*>(tc_smem + 5 * TILE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_q = (L + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_q;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (blockIdx.x % n_q) * BQ;

  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;
  const int32_t* mp = mask == nullptr ? nullptr : mask + static_cast<int64_t>(b) * L;

  auto load_kv = [&](int kb, int stage) {
    const uint32_t sK = sbase + (1 + 2 * stage) * TILE;
    load_tile<D, BK>(sK, kp, k_sl, kb * BK, L);
    load_tile<D, BK>(sK + TILE, vp, v_sl, kb * BK, L);
    cp_async_commit();
  };

  // Q starts on its way, in a commit group of its own, and so does the
  // first K/V block, while the mask is read: block 0 is live for nearly
  // every row, and waiting for the mask before asking for it put a second
  // memory latency in front of every CTA.
  load_tile<D, BQ>(sQ, qp, q_sl, q0, L);
  cp_async_commit();
  load_kv(0, 0);

  // The batch row's allowed keys as a bit set (bit k%32 of word k/32); bits
  // past L stay 0.  A 64-key block is live iff its two words are not 0.
  const int nwords = (L + 31) / 32;
  for (int base = warp * 32; base < L; base += NTHREADS) {
    const int key = base + lane;
    const bool ok = key < L && (mp == nullptr || mp[key] > 0);
    const unsigned bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) sBits[base / 32] = bits;
  }
  int n_kv = (L + BK - 1) / BK;
  if (causal) {
    // _causal_live: kv-block kb is live iff kb*BK <= q0 + BQ - 1.
    const int last_live = (q0 + BQ - 1) / BK + 1;
    n_kv = n_kv < last_live ? n_kv : last_live;
  }
  __syncthreads();
  auto word = [&](int w) { return w < nwords ? sBits[w] : 0u; };
  auto next_live = [&](int kb) {
    while (kb < n_kv && (word(2 * kb) | word(2 * kb + 1)) == 0u) ++kb;
    return kb;
  };

  // This thread's two query rows; m is the running max of the raw scores
  // q.k at allowed keys (NEG_INF while there is none), l this lane's share
  // of the running sum of p.
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float sl2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int kb = next_live(0);
  if (kb != 0) {  // block 0 is dead: its copy lands before stage 0 is reused
    cp_async_wait_all();
    if (kb < n_kv) load_kv(kb, 0);
  }
  uint32_t aq[KD][4];
  if (kb < n_kv) {
    cp_async_wait<1>();  // Q landed; the first K/V block may still be in flight
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KD; ++kc)
      ldsm_x4(aq[kc], sQ + tile_off<D>(warp * 16 + (lane & 15), 2 * kc + (lane >> 4)));
  }

  int stage = 0;
  while (kb < n_kv) {
    cp_async_wait_all();
    __syncthreads();  // block kb landed; every warp is done with the other stage
    const int nxt = next_live(kb + 1);
    if (nxt < n_kv) load_kv(nxt, stage ^ 1);
    const uint32_t sK = sbase + (1 + 2 * stage) * TILE, sV = sK + TILE;

    // The block in chunks of CK keys, each one step of the online softmax.
#pragma unroll 1
    for (int ch = 0; ch < BK / CK; ++ch) {
      // S = Q K^T: 16 rows x CK keys per warp.
      float s[CK / 8][4];
#pragma unroll
      for (int j = 0; j < CK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KD; ++kc) {
#pragma unroll
        for (int np = 0; np < CK / 16; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, sK + tile_off<D>(ch * CK + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                       2 * kc + ((lane >> 3) & 1)));
          Tc<T>::mma(s[2 * np], aq[kc], bk[0], bk[1]);
          Tc<T>::mma(s[2 * np + 1], aq[kc], bk[2], bk[3]);
        }
      }

      // Element (j, e) is key c0 + 8j + 2t + (e & 1) of row rows[e >> 1];
      // bit 2j + (e & 1) of rm[e >> 1] says whether it is allowed.
      const int c0 = kb * BK + ch * CK;
      unsigned keys = 0;
#pragma unroll
      for (int j = 0; j < CK / 8; ++j)
        keys |= ((word(c0 / 32 + j / 4) >> (8 * (j % 4) + 2 * t)) & 3u) << (2 * j);
      unsigned rm[2] = {keys, keys};
      if (causal) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int lim = rows[i] - (c0 + 2 * t);  // allowed iff 8j + (e & 1) <= lim
          unsigned cb = 0;
#pragma unroll
          for (int j = 0; j < CK / 8; ++j)
            cb |= (static_cast<unsigned>(8 * j <= lim) |
                   (static_cast<unsigned>(8 * j + 1 <= lim) << 1)) << (2 * j);
          rm[i] &= cb;
        }
      }
      auto allowed = [&](int j, int e) {
        return ((rm[e >> 1] >> (2 * j + (e & 1))) & 1u) != 0u;
      };

      // The row max over the allowed keys (a select), across the quad.
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < CK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (allowed(j, e)) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float corr[2], mneg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // 1 while the row has no allowed key; 0 when its first one arrives.
        corr[i] = exp2_approx((m[i] - m_new) * sl2);
        m[i] = m_new;
        mneg[i] = -m_new * sl2;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // p in f32 into l, and rounded into the A fragments of O += P V (key
      // step kk takes column tiles 2kk and 2kk + 1).
      uint32_t ap[CK / 16][4];
#pragma unroll
      for (int j = 0; j < CK / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = allowed(j, e) ? exp2_approx(fmaf(s[j][e], sl2, mneg[e >> 1])) : 0.f;
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
        ap[j / 2][(j % 2) * 2] = Tc<T>::pack(p[0], p[1]);
        ap[j / 2][(j % 2) * 2 + 1] = Tc<T>::pack(p[2], p[3]);
      }

      // O += P V: V read transposed (keys are the reduction dim).
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
#pragma unroll
        for (int dn = 0; dn < KD; ++dn) {
          uint32_t bv[4];
          ldsm_x4_t(bv, sV + tile_off<D>(ch * CK + kk * 16 + (lane & 7) +
                                             (((lane >> 3) & 1) << 3),
                                         2 * dn + (lane >> 4)));
          Tc<T>::mma(acc[2 * dn], ap[kk], bv[0], bv[1]);
          Tc<T>::mma(acc[2 * dn + 1], ap[kk], bv[2], bv[3]);
        }
      }
    }
    kb = nxt;
    stage ^= 1;
  }

  // The quad's shares of l; O / l through the Q tile, then 16-byte stores.
  // Every copy has landed before any warp writes the tile (with no live
  // block, Q's copies may still be in flight here).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float denom[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] /= denom[0];
    acc[n][1] /= denom[0];
    acc[n][2] /= denom[1];
    acc[n][3] /= denom[1];
  }
  cp_async_wait_all();
  __syncthreads();
  acc_to_tile<T, D>(tc_smem, acc, warp * 16, 1.f);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < L)
        lse[static_cast<int64_t>(bh) * L + rows[i]] =
            l[i] > 0.f ? m[i] * scale + logf(l[i]) : NEG_INF;
  }
  __syncthreads();
  store_tile<D, BQ>(out, tc_smem, b, q0, L, H, h);
}

// ------------------------------------------------------------- dispatch

template <typename T>
using FwdKernel = void (*)(const T*, const T*, const T*, const int32_t*, T*, float*, int, int,
                           int64_t, int64_t, int64_t, int64_t, int64_t, int64_t, int64_t,
                           int64_t, int64_t, int, float);

// The kernel for (T, D) and its dynamic shared memory at length L: f32
// takes the FMA kernel, bf16 and fp16 the tensor-core kernel.
template <typename T>
struct Pick {
  FwdKernel<T> kernel;
  size_t smem;
};

template <typename T, int D>
Pick<T> pick(int L) {
  if constexpr (std::is_same<T, float>::value) {
    return {flash_fwd_kernel<T, D>, smem_floats<D>() * sizeof(float)};
  } else {
    return {flash_fwd_mma_kernel<T, D>,
            fwd_mma_smem_bytes<D>() + static_cast<size_t>((L + 31) / 32) * sizeof(unsigned)};
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* mask,
                   void* out, float* lse, int B, int L, int H,
                   int64_t q_sb, int64_t q_sl, int64_t q_sh,
                   int64_t k_sb, int64_t k_sl, int64_t k_sh,
                   int64_t v_sb, int64_t v_sl, int64_t v_sh,
                   int causal, float scale, cudaStream_t stream) {
  const Pick<T> p = pick<T, D>(L);
  // Above 48 KB of dynamic shared memory a kernel must opt in; set on every
  // launch so that each device the caller uses gets the attribute.
  cudaError_t err = cudaFuncSetAttribute(
      p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  const int n_q = (L + BQ - 1) / BQ;
  const dim3 grid = std::is_same<T, float>::value ? dim3(B * H, n_q) : dim3(B * H * n_q);
  p.kernel<<<grid, NTHREADS, p.smem, stream>>>(
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

// Registers and local memory (spills) a thread of the kernel that launch
// would run for (T, D), and its dynamic shared memory at length L.
template <typename T, int D>
cudaError_t kernel_info(int L, int* info) {
  const Pick<T> p = pick<T, D>(L);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, p.kernel);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(p.smem);
  return err;
}

template <typename T>
cudaError_t info_dim(int D, int L, int* info) {
  switch (D) {
    case 16:
      return kernel_info<T, 16>(L, info);
    case 32:
      return kernel_info<T, 32>(L, info);
    case 64:
      return kernel_info<T, 64>(L, info);
    case 128:
      return kernel_info<T, 128>(L, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Strides are in elements;
// the last dimension of q/k/v must be contiguous, and for float16 /
// bfloat16 every row must start on a 16-byte boundary.  mask is [B, L]
// int32 or null (every key allowed).  out is a contiguous [B, L, H, D]
// tensor of the input dtype and lse a contiguous [B*H, L] float32 tensor.
// Returns the cudaError_t of the launch.
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

// Resources of the forward kernel for dtype and head dim D: info[0]
// registers a thread, info[1] local memory bytes a thread (spills),
// info[2] dynamic shared memory bytes at length L.
extern "C" int tpp_flash_fwd_kernel_info(int dtype, int D, int L, int* info) {
  switch (dtype) {
    case 0:
      return info_dim<float>(D, L, info);
    case 1:
      return info_dim<__half>(D, L, info);
    case 2:
      return info_dim<__nv_bfloat16>(D, L, info);
    default:
      return cudaErrorInvalidValue;
  }
}
