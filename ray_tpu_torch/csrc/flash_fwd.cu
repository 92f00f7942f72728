// Flash-attention forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel (launched
// by _flash_fwd_impl through pl.pallas_call). Same function: softmax(Q K^T /
// sqrt(D)) V, causal or full, with an online softmax whose running max m,
// running sum l and accumulator stay in fp32; masked scores are -1e30;
// O = acc / max(l, 1e-30) in the input dtype and lse = m + log(l) in fp32.
//
// What changed against the TPU kernel:
// - q is read as (B, S, H, D) and k, v as (B, S, KVH, D) through their
//   strides: query head h reads KV head h / (H / KVH), which is what the JAX
//   model's jnp.repeat(k, H / KVH, axis=2) produces. No transpose, no repeat.
// - Any S >= 1: the ragged last tile is masked here (keys >= S score -1e30,
//   query rows >= S are not stored), so every prefill bucket runs the kernel.
// - One block of 4 warps per (64-row q tile, batch*head). Blocks run in
//   parallel in no order, so the TPU's sequential k-block grid becomes a loop
//   inside the block. Causal q tiles are issued longest first.
//
// Products run on the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32
// accumulate). fp32 inputs are split into bf16 hi + lo parts and each product
// is taken as hi*hi + hi*lo + lo*hi, which keeps about 16 mantissa bits: close
// enough to an fp32 product for the fp32 comparison, at 3x the mma count.
// P is rounded to bf16 (hi, plus lo for fp32 inputs) before P V, as the
// reference rounds its probabilities to the input dtype before P V.
//
// What bounds it on this card: at the serving shapes (S up to 2048, D = 128)
// attention does 2*S*D FLOPs per (q, k) pair for 4*D bytes per row of q, k,
// v and o, so it is bound by the tensor cores (989 TFLOP/s bf16 dense), not
// by HBM (3.35 TB/s): at B=8, H=16, S=2048 causal the bound is about 0.14 ms
// of tensor-core work against 0.06 ms of bytes. This simple design leaves a
// lot on the table: mma.sync reaches a fraction of wgmma's rate, the K/V
// tiles are loaded by the threads with plain loads (no TMA, no cp.async
// pipelining, no double buffering), the V operand is gathered from shared
// memory 16 bits at a time instead of with ldmatrix.trans, and one tile of
// 64 queries keeps only 4 warps per block. Those are the later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KVH,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 float scale_log2, int causal) {
  constexpr int kTileWords = kBlockK * lds<D>();
  constexpr int kKSteps = D / 16;          // k-steps of Q K^T
  constexpr int kSTiles = kBlockK / 8;     // n-tiles of the score tile
  constexpr int kOTiles = D / 8;           // n-tiles of the output

  extern __shared__ uint32_t smem[];
  uint32_t* sQ = smem;
  uint32_t* sK = sQ + kTileWords;
  uint32_t* sV = sK + kTileWords;
  uint32_t* sQl = sV + kTileWords;         // used only when SPLIT
  uint32_t* sKl = sQl + kTileWords;
  uint32_t* sVl = sKl + kTileWords;

  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  // causal: the last q tiles see the most keys, so issue them first
  const int qt = causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBlockQ;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row within an 8-row group of the fragment
  const int t = lane % 4;   // thread within the quad

  // Q tile -> A fragments in registers (kept for the whole loop)
  load_tile<T, D, SPLIT>(qb, q_ss, q0, S, kBlockQ, sQ, sQl);
  __syncthreads();
  uint32_t qf[kKSteps][4];
  uint32_t qlf[SPLIT ? kKSteps : 1][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    load_a<D>(sQ, warp * 16, ks, g, t, qf[ks]);
    if constexpr (SPLIT) load_a<D>(sQl, warp * 16, ks, g, t, qlf[ks]);
  }

  float acc[kOTiles][4];
#pragma unroll
  for (int i = 0; i < kOTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // rows row_a = q0 + warp*16 + g and row_b = row_a + 8
  float m_a = kMasked, m_b = kMasked;
  float l_a = 0.f, l_b = 0.f;  // this thread's partial row sums
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  const int n_kt = (k_end + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, SPLIT>(kb, k_ss, k0, S, kBlockK, sK, sKl);
    load_tile<T, D, SPLIT>(vb, v_ss, k0, S, kBlockK, sV, sVl);
    __syncthreads();

    // scores: s[n] covers keys k0 + n*8 + 2t + {0,1} for rows a (0,1), b (2,3)
    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        uint32_t b0, b1, bl0 = 0u, bl1 = 0u;
        load_b_rows<D>(sK, n * 8, ks, g, t, &b0, &b1);
        if constexpr (SPLIT) load_b_rows<D>(sKl, n * 8, ks, g, t, &bl0, &bl1);
        mma_split<SPLIT>(s[n], qf[ks], qlf[SPLIT ? ks : 0], b0, b1, bl0, bl1);
      }
    }

    // scale into the log2 domain, mask, row max
    float mx_a = kMasked, mx_b = kMasked;
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + 2 * t + (i & 1);
        const int row = i < 2 ? row_a : row_b;
        float x = s[n][i] * scale_log2;
        if (col >= S || (causal && col > row)) x = kMasked;
        s[n][i] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a);
    const float alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      s[n][0] = exp2f(s[n][0] - mn_a);
      s[n][1] = exp2f(s[n][1] - mn_a);
      s[n][2] = exp2f(s[n][2] - mn_b);
      s[n][3] = exp2f(s[n][3] - mn_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int i = 0; i < kOTiles; ++i) {
      acc[i][0] *= alpha_a;
      acc[i][1] *= alpha_a;
      acc[i][2] *= alpha_b;
      acc[i][3] *= alpha_b;
    }

    // acc += P V: the score C fragments of n-tiles 2j, 2j+1 are the A
    // fragment of k-step j
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t pa[4], pl[4];
      c_to_a<SPLIT>(s[2 * j], s[2 * j + 1], pa, pl);
      // B[k][n] = V[key j*16 + k][d n*8 + g]
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        uint32_t b0, b1, bl0 = 0u, bl1 = 0u;
        load_b_cols<D>(sV, j * 16, n * 8, g, t, &b0, &b1);
        if constexpr (SPLIT) load_b_cols<D>(sVl, j * 16, n * 8, g, t, &bl0, &bl1);
        mma_split<SPLIT>(acc[n], pa, pl, b0, b1, bl0, bl1);
      }
    }
  }

  // full row sums across the quad
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float ls_a = fmaxf(l_a, 1e-30f);
  const float ls_b = fmaxf(l_b, 1e-30f);
  const float inv_a = 1.f / ls_a;
  const float inv_b = 1.f / ls_b;

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < S)
      store_pair(ob + (long long)row_a * o_ss + col, acc[n][0] * inv_a,
                 acc[n][1] * inv_a);
    if (row_b < S)
      store_pair(ob + (long long)row_b * o_ss + col, acc[n][2] * inv_b,
                 acc[n][3] * inv_b);
  }
  if (t == 0) {
    float* lb = lse + (long long)bh * S;
    if (row_a < S) lb[row_a] = m_a * kLn2 + logf(ls_a);
    if (row_b < S) lb[row_b] = m_b * kLn2 + logf(ls_b);
  }
}

template <typename T, int D, bool SPLIT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, int KVH,
                   const long long* st, int causal, cudaStream_t stream) {
  constexpr int kTileBytes = kBlockK * (D + 8) * 2;
  constexpr int kSmem = (SPLIT ? 6 : 3) * kTileBytes;
  auto kernel = flash_fwd_kernel<T, D, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = kLog2e / sqrtf((float)D);
  dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, KVH, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32. strides (in elements) of dims b, s, h for
// q, k, v, o in that order; the last dim of each is contiguous. Returns a
// cudaError_t (0 on success); an unsupported head_dim or dtype returns
// cudaErrorInvalidValue.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int dtype, int B, int S, int H, int KVH,
                         int D, const long long* strides, int causal,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<__nv_bfloat16, 64, false>(q, k, v, o, lse, B, S, H, KVH,
                                            strides, causal, st);
  if (dtype == 0 && D == 128)
    return launch<__nv_bfloat16, 128, false>(q, k, v, o, lse, B, S, H, KVH,
                                             strides, causal, st);
  if (dtype == 1 && D == 64)
    return launch<float, 64, true>(q, k, v, o, lse, B, S, H, KVH, strides,
                                   causal, st);
  if (dtype == 1 && D == 128)
    return launch<float, 128, true>(q, k, v, o, lse, B, S, H, KVH, strides,
                                    causal, st);
  return (int)cudaErrorInvalidValue;
}
