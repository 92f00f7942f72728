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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block (16 per warp)
constexpr int kBlockK = 64;   // keys per tile of the inner loop
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Split a pair of floats into bf16 hi and bf16 lo = x - hi (packed pairs).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t* hi,
                                           uint32_t* lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  *hi = *reinterpret_cast<uint32_t*>(&h);
  *lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// Copy rows [row0, row0 + rows) of one head into shared memory as bf16 pairs
// (hi, and lo when the input is fp32); rows >= S are zero.
template <typename T, int D, bool SPLIT>
__device__ __forceinline__ void load_tile(const T* base, long long row_stride,
                                          int row0, int S, int rows,
                                          uint32_t* hi, uint32_t* lo) {
  constexpr int kPairs = D / 2;
  constexpr int kLds = (D + 8) / 2;  // shared row stride in 32-bit words
  for (int idx = threadIdx.x; idx < rows * kPairs; idx += kThreads) {
    const int r = idx / kPairs;
    const int c = idx % kPairs;
    const int row = row0 + r;
    uint32_t h = 0u, l = 0u;
    if (row < S) {
      const T* src = base + (long long)row * row_stride + 2 * c;
      if constexpr (SPLIT) {
        const float2 x = *reinterpret_cast<const float2*>(src);
        split_pair(x.x, x.y, &h, &l);
      } else {
        h = *reinterpret_cast<const uint32_t*>(src);
      }
    }
    hi[r * kLds + c] = h;
    if constexpr (SPLIT) lo[r * kLds + c] = l;
  }
}

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
  constexpr int kLds = (D + 8) / 2;        // words per shared row (padded)
  constexpr int kTileWords = kBlockK * kLds;
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
  {
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int c = ks * 8 + t;  // word column (2 bf16 each)
      qf[ks][0] = sQ[r0 * kLds + c];
      qf[ks][1] = sQ[(r0 + 8) * kLds + c];
      qf[ks][2] = sQ[r0 * kLds + c + 4];
      qf[ks][3] = sQ[(r0 + 8) * kLds + c + 4];
      if constexpr (SPLIT) {
        qlf[ks][0] = sQl[r0 * kLds + c];
        qlf[ks][1] = sQl[(r0 + 8) * kLds + c];
        qlf[ks][2] = sQl[r0 * kLds + c + 4];
        qlf[ks][3] = sQl[(r0 + 8) * kLds + c + 4];
      }
    }
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

  const unsigned short* sVh16 = reinterpret_cast<const unsigned short*>(sV);
  const unsigned short* sVl16 = reinterpret_cast<const unsigned short*>(sVl);

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
      const int krow = (n * 8 + g) * kLds;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint32_t b0 = sK[krow + ks * 8 + t];
        const uint32_t b1 = sK[krow + ks * 8 + t + 4];
        mma_bf16(s[n], qf[ks], b0, b1);
        if constexpr (SPLIT) {
          mma_bf16(s[n], qf[ks], sKl[krow + ks * 8 + t],
                   sKl[krow + ks * 8 + t + 4]);
          mma_bf16(s[n], qlf[ks], b0, b1);
        }
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
      if constexpr (SPLIT) {
        split_pair(s[2 * j][0], s[2 * j][1], &pa[0], &pl[0]);
        split_pair(s[2 * j][2], s[2 * j][3], &pa[1], &pl[1]);
        split_pair(s[2 * j + 1][0], s[2 * j + 1][1], &pa[2], &pl[2]);
        split_pair(s[2 * j + 1][2], s[2 * j + 1][3], &pa[3], &pl[3]);
      } else {
        pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      }
      // B[k][n] = V[key j*16 + k][d n*8 + g]; k = 2t, 2t+1 (b0) and +8 (b1)
      const int key = j * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        const int col = n * 8 + g;
        const int e0 = key * (2 * kLds) + col;
        const int e1 = e0 + 2 * kLds;
        const int e8 = e0 + 8 * (2 * kLds);
        const int e9 = e8 + 2 * kLds;
        const uint32_t b0 = (uint32_t)sVh16[e0] | ((uint32_t)sVh16[e1] << 16);
        const uint32_t b1 = (uint32_t)sVh16[e8] | ((uint32_t)sVh16[e9] << 16);
        mma_bf16(acc[n], pa, b0, b1);
        if constexpr (SPLIT) {
          const uint32_t c0 = (uint32_t)sVl16[e0] | ((uint32_t)sVl16[e1] << 16);
          const uint32_t c1 = (uint32_t)sVl16[e8] | ((uint32_t)sVl16[e9] << 16);
          mma_bf16(acc[n], pa, c0, c1);
          mma_bf16(acc[n], pl, b0, b1);
        }
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
    if (row_a < S) {
      T* dst = ob + (long long)row_a * o_ss + col;
      if constexpr (SPLIT) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[n][0] * inv_a, acc[n][1] * inv_a);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[n][0] * inv_a, acc[n][1] * inv_a);
      }
    }
    if (row_b < S) {
      T* dst = ob + (long long)row_b * o_ss + col;
      if constexpr (SPLIT) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[n][2] * inv_b, acc[n][3] * inv_b);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[n][2] * inv_b, acc[n][3] * inv_b);
      }
    }
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
