// Flash-decode attention for Hopper (sm_90a): one query per (batch, head)
// attends over a padded KV cache, with key validity and an additive score
// bias (T5's relative positions).  The KV range is split across the CTAs of
// one thread-block cluster, and the splits are merged through distributed
// shared memory inside the same launch.
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
// What bounds it: for each allowed key the function reads k and v (4*D bytes
// in bf16) and does about 4*D operations (2*D for q.k, 2*D for p*v), about
// 1 operation per byte, far below Hopper's bf16 line of about 295 operations
// per byte: it is bound by the k/v bytes at the allowed keys (plus q, out,
// the mask and the bias).  At B=32, L=4096, H=8, D=64, bf16 the k/v bytes
// are 268 MB, about 0.080 ms at 3.35 TB/s.  Reaching that rate takes tens of
// KB of loads in flight on every SM, and at a short cache the kernel's
// fixed latencies (launch, mask, merge) are most of its time; what the
// design does about it:
//
//   1. Enough CTAs.  The wrapper picks S splits (ops/flash_attention.py
//      decode_splits: about 2 CTAs per SM over B*H, at most 8, at least two
//      BLOCK_K-key blocks a split, none for a cache of at most 4 blocks,
//      where the merge would cost more than the walk it shortens) and the
//      grid has S*B*H CTAs.  Split r takes a contiguous run of whole
//      blocks, [r*nb/S, (r+1)*nb/S).  A one-row beam request (B=4, H=8) at
//      a 4096-key cache runs 256 CTAs instead of 32.  BLOCK_K is the
//      library's block configuration (-DTPP_BLOCK_K=..; ops/_build.py,
//      ops/flash_attention.py DECODE_BLOCKS): 32, 64 or 128 for bf16 and
//      fp16 at head dims 64 and 128; the default 64 library also holds
//      D = 16 and 32 and f32, which keeps 64.  It sets the split's grain
//      and the split rule's counts; the walk's steps (2 keys a group) are
//      the same in every built configuration.
//   2. The validity mask off the critical path.  A CTA reads the mask of a
//      chunk of up to 2048 of its keys in one pass (every load in flight at
//      once, int32 or bool read in place through its strides, batch stride
//      0 included) into a bit set in shared memory, and notes the chunk's
//      last allowed key.  The key walk then tests bits in shared memory and
//      never waits on a mask load; keys past the last allowed one are never
//      visited, so with the engine's pos <= validity the blocks past a row's
//      position cost neither k/v bytes nor math (a split that holds none of
//      the row's keys does nothing but its mask pass).  A masked key inside
//      the walk costs no k/v bytes; a warp whose keys of a step are all
//      masked skips the step's math.  (A bool mask cannot be staged with
//      cp.async, whose smallest copy is 4 bytes; one pass of plain loads
//      serves every mask type.)
//   3. Loads ahead of math.  Threads form key groups of D * sizeof(T) / 16
//      lanes, each lane holding 16 bytes of a row, so a group reads one key
//      row with one load per lane.  The walk goes in steps of up to 2 keys
//      per group; the k/v loads (streaming, ld.global.cs: each byte is read
//      once) and the bias entries of step t+1 are issued before the math of
//      step t (a register double buffer: two step buffers that swap roles,
//      so no copy waits on a load).  Each group runs its own online softmax
//      in f32 over the keys it took, one update (one max, one rescale) per
//      step.  Deeper buffers and 4-key steps were no faster on the card at
//      the long cache and slower at short ones.
//   4. Merge without a second launch.  The groups' (m, l, acc) are merged in
//      shared memory by the max/denominator rule into the CTA's partial.
//      Every rank of the cluster arrives at a cluster barrier on entry and
//      waits on it after its walk, so that the whole cluster has started
//      before any store crosses CTAs.  Then each rank writes its partial
//      into rank 0's shared memory through cluster.map_shared_rank
//      (distributed shared memory), arrives at the barrier's next phase
//      (release) and is done; rank 0 waits (acquire) and its first D
//      threads merge the partials in rank order, so two launches agree bit
//      for bit, and write out.  No CTA reads another's shared memory, so no
//      CTA has to outlive its readers.  A split with no allowed key carries m = NEG_INF and l =
//      acc = 0 and adds nothing; when no split has one, out = 0 / 1e-30 =
//      0.  No global scratch and no atomics; S = 1 launches without a
//      cluster and writes out directly.
//   5. q, k, v, the mask and the bias are read where they lie, through 13
//      strides, so the engine's [:b, :kv] arena views and the stride-0
//      broadcast bias are read in place.  Ragged L is masked inside the
//      kernel, so there is no divisibility rule.
//
// The f32 kernel is the same template and takes the same split; bf16,
// fp16 and f32 differ only in how many elements a 16-byte load holds.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

#ifndef TPP_BLOCK_K
#define TPP_BLOCK_K 64
#endif

namespace {

constexpr int NTHREADS = 128;   // 4 warps
constexpr int MIN_BLOCKS = 4;   // CTAs per SM the registers must allow
constexpr int BLOCK_K = TPP_BLOCK_K;  // keys per block; a split is whole blocks
static_assert(BLOCK_K == 32 || BLOCK_K == 64 || BLOCK_K == 128, "block configuration");
// The default configuration's library builds every dtype and head dim;
// every other one bf16 and fp16 at D = 64 and 128.
constexpr bool DEFAULT_BLOCK = BLOCK_K == 64;
constexpr int MAX_UNROLL = 2;   // keys a group takes per step
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int CHUNK = 2048;     // keys whose mask one pass reads into bits
constexpr int WORDS = CHUNK / 32;
constexpr float NEG_INF = -1e30f;

struct DecodeArgs {
  const void* q;         // [B, 1, H, D]
  const void* k;         // [B, L, H, D]
  const void* v;         // [B, L, H, D]
  const void* mask;      // [B, L] int32 or bool, or null (every key allowed)
  const float* bias;     // [1|B, H, 1, L] or null (zero)
  void* out;             // contiguous [B, 1, H, D]
  int L, H, splits;
  int mask_bytes;        // 4: int32, 1: bool / uint8
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

// The validity of keys [c0, c1) into s_bits (bit o of the set: key c0 + o),
// every load of the pass issued before the first ballot; s_last gets the
// last word that holds an allowed key (-1: none).  MASK is the mask's
// element size: 4 int32, 1 bool / uint8, 0 no mask (every key allowed);
// row is the batch row's first entry and stride the bytes between entries.
template <int MASK>
__device__ __forceinline__ void read_mask_bits(const char* row, int64_t stride,
                                               int c0, int c1, uint32_t* s_bits,
                                               int* s_last) {
  constexpr int PER_THREAD = CHUNK / NTHREADS;
  const int tid = threadIdx.x;
  bool ok[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int j = c0 + i * NTHREADS + tid;
    ok[i] = j < c1;
    if constexpr (MASK == 4) {
      ok[i] = ok[i] && *reinterpret_cast<const int32_t*>(row + j * stride) > 0;
    } else if constexpr (MASK == 1) {
      ok[i] = ok[i] && row[j * stride] != 0;
    }
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const uint32_t word = __ballot_sync(0xffffffffu, ok[i]);
    if (tid % 32 == 0) {
      const int w = i * (NTHREADS / 32) + tid / 32;
      s_bits[w] = word;
      if (word != 0u) atomicMax(s_last, w);
    }
  }
}

// One step's keys of one thread: up to UNROLL keys of its group, their k/v
// rows (this lane's 16 bytes of each), bias entries and allowed flags.
template <int UNROLL>
struct StepKeys {
  uint4 k[UNROLL], v[UNROLL];
  float bias[UNROLL];
  bool ok[UNROLL];
};

// Grid: S*B*H CTAs, clusters of S along x; blockIdx.x = (b*H + h)*S + r.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
flash_decode_kernel(const DecodeArgs a) {
  constexpr int VEC = 16 / sizeof(T);           // elements per lane per row
  constexpr int LANES = D / VEC;                // lanes that share one key row
  constexpr int GROUPS = NTHREADS / LANES;      // keys one pass of the CTA takes
  constexpr int PER_GROUP = BLOCK_K / GROUPS;   // keys per group per block
  constexpr int UNROLL = PER_GROUP < MAX_UNROLL ? PER_GROUP : MAX_UNROLL;
  constexpr int STEP = GROUPS * UNROLL;         // keys of the CTA per step
  static_assert(LANES >= 2 && LANES <= 32 && 32 % LANES == 0, "lanes per key");
  static_assert(PER_GROUP >= 1 && PER_GROUP % UNROLL == 0, "keys per group");
  static_assert(CHUNK % STEP == 0 && CHUNK % BLOCK_K == 0, "chunk of steps");

  __shared__ uint32_t s_bits[WORDS];
  __shared__ int s_last;
  __shared__ float s_acc[GROUPS][D];
  __shared__ float s_m[GROUPS];
  __shared__ float s_l[GROUPS];
  // Rank 0's copy of every rank's partial (unused in the other ranks).
  __shared__ float r_acc[MAX_SPLITS][D];
  __shared__ float r_m[MAX_SPLITS];
  __shared__ float r_l[MAX_SPLITS];

  const int tid = threadIdx.x;
  const int g = tid / LANES;
  const int lane = tid % LANES;
  const int split = blockIdx.x % a.splits;
  const int bh = blockIdx.x / a.splits;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int d0 = lane * VEC;
  // Every CTA of the cluster arrives at kernel entry; each waits just before
  // its first store into rank 0's shared memory, so that no store reaches a
  // CTA that has not started.  The walk hides the wait.
  if (a.splits > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // This split's keys: whole blocks [split*nb/S, (split+1)*nb/S).
  const int nb = (a.L + BLOCK_K - 1) / BLOCK_K;
  const int k_begin = split * nb / a.splits * BLOCK_K;
  const int k_end = min(a.L, (split + 1) * nb / a.splits * BLOCK_K);

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + d0;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + d0;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + d0;
  const float* bp = a.bias == nullptr ? nullptr : a.bias + b * a.b_sb + h * a.b_sh;

  float qv[VEC];
  unpack<T>(*reinterpret_cast<const uint4*>(qp), qv);
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] *= a.scale;

  float m = NEG_INF, l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int c0 = k_begin; c0 < k_end; c0 += CHUNK) {
    const int c1 = min(k_end, c0 + CHUNK);
    __syncthreads();  // the previous chunk's bits are no longer read
    if (tid == 0) s_last = -1;
    __syncthreads();
    const char* mrow = static_cast<const char*>(a.mask) + b * a.m_sb * a.mask_bytes;
    const int64_t mstride = a.m_sl * a.mask_bytes;
    if (a.mask == nullptr) {
      read_mask_bits<0>(nullptr, 0, c0, c1, s_bits, &s_last);
    } else if (a.mask_bytes == 4) {
      read_mask_bits<4>(mrow, mstride, c0, c1, s_bits, &s_last);
    } else {
      read_mask_bits<1>(mrow, mstride, c0, c1, s_bits, &s_last);
    }
    __syncthreads();
    // Steps up to the one that holds the chunk's last allowed key.
    const int span = min((s_last + 1) * 32, c1 - c0);
    const int n_steps = (span + STEP - 1) / STEP;

    // Step t covers keys c0 + t*STEP + u*GROUPS + g, u < UNROLL.
    auto issue = [&](StepKeys<UNROLL>& s, int t) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int o = t * STEP + u * GROUPS + g;
        s.ok[u] = t < n_steps && ((s_bits[o >> 5] >> (o & 31)) & 1u);
        s.k[u] = s.v[u] = make_uint4(0u, 0u, 0u, 0u);
        s.bias[u] = 0.f;
        if (s.ok[u]) {  // masked keys cost no k/v bytes
          const int64_t j = c0 + o;
          // Streaming loads (ld.global.cs): each k/v byte is read once.
          s.k[u] = __ldcs(reinterpret_cast<const uint4*>(kp + j * a.k_sl));
          s.v[u] = __ldcs(reinterpret_cast<const uint4*>(vp + j * a.v_sl));
          if (bp != nullptr) s.bias[u] = bp[j * a.b_sl];
        }
      }
    };
    // The shuffles run with the whole warp (the skip below is warp-uniform).
    // The step's keys take one online-softmax update together: one max and
    // one rescale per step, so the group's chain of dependent updates is
    // a step long, not a key long.
    auto consume = [&](const StepKeys<UNROLL>& s) {
      bool any = false;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) any |= s.ok[u];
      if (!__any_sync(0xffffffffu, any)) return;
      float sc[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float kv[VEC];
        unpack<T>(s.k[u], kv);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(qv[i], kv[i], dot);
        // Butterfly over the group's lanes: every lane ends with the same sum.
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        sc[u] = s.ok[u] ? dot + s.bias[u] : NEG_INF;
      }
      float m_new = m;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) m_new = fmaxf(m_new, sc[u]);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] *= corr;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (s.ok[u]) {  // a masked key never enters the sums
          const float p = expf(sc[u] - m_new);
          float vv[VEC];
          unpack<T>(s.v[u], vv);
          l += p;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
        }
      }
      m = m_new;
    };

    StepKeys<UNROLL> s0, s1;
    issue(s0, 0);
    for (int t = 0; t < n_steps; t += 2) {
      issue(s1, t + 1);
      consume(s0);
      if (t + 1 >= n_steps) break;
      issue(s0, t + 2);
      consume(s1);
    }
  }

  // Groups -> CTA.  A group that took no allowed key has m = NEG_INF and
  // l = acc = 0, so it adds nothing.
#pragma unroll
  for (int i = 0; i < VEC; ++i) s_acc[g][d0 + i] = acc[i];
  if (lane == 0) {
    s_m[g] = m;
    s_l[g] = l;
  }
  __syncthreads();
  float mx = NEG_INF, den = 0.f, o = 0.f;
  if (tid < D) {
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) mx = fmaxf(mx, s_m[i]);
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) {
      const float c = expf(s_m[i] - mx);
      den = fmaf(s_l[i], c, den);
      o = fmaf(s_acc[i][tid], c, o);
    }
  }
  T* op = static_cast<T*>(a.out) + static_cast<int64_t>(bh) * D + tid;
  if (a.splits == 1) {
    if (tid < D) *op = from_f32<T>(o / fmaxf(den, 1e-30f));
    return;
  }

  // CTAs -> cluster: once the whole cluster has started (the barrier phase
  // begun at entry), every rank writes its partial into rank 0's shared
  // memory (distributed shared memory stores), then arrives at the cluster
  // barrier with release semantics and is done; rank 0 waits with acquire
  // semantics and merges the partials in rank order.  Rank 0's shared
  // memory is the only one read across CTAs, and rank 0 exits last.
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < D) *cluster.map_shared_rank(&r_acc[split][tid], 0) = o;
  if (tid == 0) {
    *cluster.map_shared_rank(&r_m[split], 0) = mx;
    *cluster.map_shared_rank(&r_l[split], 0) = den;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (split != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (tid < D) {
    float gm = NEG_INF;
    for (int r = 0; r < a.splits; ++r) gm = fmaxf(gm, r_m[r]);
    float gden = 0.f, go = 0.f;
    for (int r = 0; r < a.splits; ++r) {
      const float c = expf(r_m[r] - gm);
      gden = fmaf(r_l[r], c, gden);
      go = fmaf(r_acc[r][tid], c, go);
    }
    *op = from_f32<T>(go / fmaxf(gden, 1e-30f));
  }
}

using KernelFn = void (*)(DecodeArgs);

// Whether this library builds (T, D).
template <typename T, int D>
constexpr bool built() {
  return DEFAULT_BLOCK || (!std::is_same<T, float>::value && D >= 64);
}

template <typename T, int D>
KernelFn kernel_if_built() {
  if constexpr (built<T, D>()) {
    return flash_decode_kernel<T, D>;
  } else {
    return nullptr;
  }
}

// The kernel for (dtype, D), or null.
template <typename T>
KernelFn kernel_for_dim(int D) {
  switch (D) {
    case 16: return kernel_if_built<T, 16>();
    case 32: return kernel_if_built<T, 32>();
    case 64: return kernel_if_built<T, 64>();
    case 128: return kernel_if_built<T, 128>();
    default: return nullptr;
  }
}

KernelFn kernel_for(int dtype, int D) {
  switch (dtype) {
    case 0: return kernel_for_dim<float>(D);
    case 1: return kernel_for_dim<__half>(D);
    case 2: return kernel_for_dim<__nv_bfloat16>(D);
    default: return nullptr;
  }
}

// A launch config of `ctas` CTAs in clusters of `splits` (no cluster for 1).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(unsigned ctas, int splits, cudaStream_t stream) {
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = splits > 1 ? 1 : 0;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  mask_code: 0 = no mask
// (every key allowed), 1 = int32, 2 = bool / uint8.  Strides are in
// elements, 13 of them: q (batch, head), k (batch, len, head), v (batch,
// len, head), mask (batch, len), bias (batch, head, len); the last
// dimension of q/k/v must be contiguous and every q/k/v row 16-byte
// aligned.  bias is float32 or null (zero).  out is a contiguous
// [B, 1, H, D] tensor of the input dtype.  splits: S in 1..8, the CTAs
// (one cluster) per (batch, head).  block_k must be this library's block
// (TPP_BLOCK_K) and (dtype, D) built in it, else cudaErrorInvalidValue.
// Returns the cudaError_t of the launch.
extern "C" int tpp_flash_decode(const void* q, const void* k, const void* v,
                                const void* mask, const void* bias, void* out,
                                int dtype, int mask_code, int B, int L, int H,
                                int D, int splits, int block_k, const int64_t* strides,
                                float scale, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS || mask_code < 0 || mask_code > 2 ||
      block_k != BLOCK_K)
    return cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask_code == 0 ? nullptr : mask;
  a.mask_bytes = mask_code == 1 ? 4 : 1;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.L = L;
  a.H = H;
  a.splits = splits;
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
  const KernelFn fn = kernel_for(dtype, D);
  if (fn == nullptr) return cudaErrorInvalidValue;
  ClusterLaunch launch(static_cast<unsigned>(splits) * B * H, splits,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t err = cudaLaunchKernelEx(&launch.cfg, fn, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Resources of the kernel for (dtype, D) at S splits and this library's
// block_k: info[0] registers a thread, [1] local (spill) bytes a thread,
// [2] static shared memory bytes, [3] CTAs an SM can hold, [4] clusters of S
// the card can run at once (S CTAs each; for S = 1, the CTAs of the whole
// card).  Returns a cudaError_t.
extern "C" int tpp_flash_decode_kernel_info(int dtype, int d, int splits, int block_k,
                                            int* info) {
  const KernelFn fn = kernel_for(dtype, d);
  if (fn == nullptr || splits < 1 || splits > MAX_SPLITS || block_k != BLOCK_K)
    return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn, NTHREADS, 0);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess || splits == 1) {
    info[4] = info[3] * sms;
    return err;
  }
  // Any grid that holds whole clusters will do for the query.
  ClusterLaunch launch(static_cast<unsigned>(splits) * sms, splits, nullptr);
  return cudaOccupancyMaxActiveClusters(&info[4], fn, &launch.cfg);
}
