// Flash-attention backward for Hopper (sm_90a), bound to Python through
// ctypes: two kernels, dQ and dK/dV.
//
// Replaces the TPU kernels ray_tpu/ops/attention.py:_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (launched by flash_attention_bwd through
// pl.pallas_call). Same function, with the softmax rebuilt from the lse the
// forward saved (P = exp(s * scale - lse), masked scores -1e30) and
// Delta = rowsum(dO * O) computed beforehand by the caller:
//   dP = dO V^T,  dS = P * (dP - Delta) * scale,
//   dQ = dS K,    dK = dS^T Q,    dV = P^T dO,
// with fp32 accumulation; dq is stored in q's dtype, dk and dv in k's.
//
// What changed against the TPU kernels:
// - q and dO are read as (B, S, H, D), k and v as (B, S, KVH, D), through
//   their strides (query head h reads KV head h / (H / KVH)), as in the
//   forward. The JAX model repeats K/V to H heads, so its dK and dV come out
//   per query head and autodiff sums them over each group. Here the dK/dV
//   kernel runs one block per (64-key tile, batch * KV head) and loops over
//   the H / KVH query heads of the group, so the group's sum is taken in the
//   block's fp32 accumulators: no (B, S, H, D) temporary, no atomics, and the
//   result does not depend on the order blocks run in.
// - Any S >= 1: keys >= S and query rows >= S get P = 0, so they add nothing,
//   and rows >= S are not stored.
// - The TPU's sequential grid dimension (k blocks for dQ, q blocks for dK/dV)
//   becomes a loop inside one block of 4 warps. Blocks with the longest loop
//   are issued first (the last q tiles for dQ, the first k tiles for dK/dV
//   when causal).
// - The dK/dV kernel computes S^T = K Q^T and dP^T = V dO^T directly, so
//   P^T and dS^T come out of the products as C fragments, which are the A
//   fragments of P^T dO and dS^T Q with no trip through shared memory.
//   Likewise dS in the dQ kernel is the A fragment of dS K.
//
// Products run on the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32
// accumulate). For bf16 inputs P and dS are rounded to bf16 before the
// products that take them (the plain version keeps them in fp32; the
// tolerance of the comparison follows from that). fp32 inputs go through
// the hi/lo split of flash_common.cuh, P and dS included.
//
// What bounds it on this card: the dQ kernel takes 3 products per (q, k)
// pair (Q K^T, dO V^T, dS K: 6 D FLOPs), the dK/dV kernel 4 (K Q^T,
// V dO^T, P^T dO, dS^T Q: 8 D FLOPs), against 8 D bytes per row of q, k, v,
// dO and the outputs. At the 1b training shape (B=4, S=2048, H=16, KVH=8,
// D=128, causal) that is 0.10 ms and 0.14 ms of tensor-core work against
// about 0.04 ms of bytes each: both are bound by the tensor cores. This
// design is the simple one and leaves most of that on the table: mma.sync
// instead of wgmma, tiles loaded by the threads with plain loads (no TMA, no
// cp.async pipelining), the B operands of dS K, P^T dO and dS^T Q gathered
// from shared memory 16 bits at a time instead of with ldmatrix.trans, and
// the dK/dV kernel reads the A fragments of K and V from shared memory at
// every use to keep its registers for the two accumulators (2 x 16 x D fp32
// per warp). Those are later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

// dQ: one block per (64-row q tile, batch * head); warp w owns rows
// q0 + 16 w .. q0 + 16 w + 15 and keeps their Q and dO fragments in
// registers. Over the k tiles up to the diagonal it forms, 16 keys at a
// time, S and dP, then dS, and adds dS K into the dQ accumulator.
template <typename T, int D, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int KVH,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long do_sb, long long do_ss, long long do_sh,
                    long long dq_sb, long long dq_ss, long long dq_sh,
                    float scale, float scale_log2, int causal) {
  constexpr int kTileWords = kBlockK * lds<D>();
  constexpr int kKSteps = D / 16;  // k-steps of Q K^T and dO V^T
  constexpr int kOTiles = D / 8;   // n-tiles of dQ

  extern __shared__ uint32_t smem[];
  uint32_t* sK = smem;
  uint32_t* sV = sK + kTileWords;
  uint32_t* sKl = sV + kTileWords;  // used only when SPLIT
  uint32_t* sVl = sKl + kTileWords;

  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  // causal: the last q tiles see the most keys, so issue them first
  const int qt = causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBlockQ;

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // Q and dO tiles -> A fragments in registers, through the K and V buffers
  load_tile<T, D, SPLIT>(q + b * q_sb + h * q_sh, q_ss, q0, S, kBlockQ, sK,
                         sKl);
  load_tile<T, D, SPLIT>(dout + b * do_sb + h * do_sh, do_ss, q0, S, kBlockQ,
                         sV, sVl);
  __syncthreads();
  uint32_t qf[kKSteps][4], dof[kKSteps][4];
  uint32_t qlf[SPLIT ? kKSteps : 1][4], dolf[SPLIT ? kKSteps : 1][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    load_a<D>(sK, warp * 16, ks, g, t, qf[ks]);
    load_a<D>(sV, warp * 16, ks, g, t, dof[ks]);
    if constexpr (SPLIT) {
      load_a<D>(sKl, warp * 16, ks, g, t, qlf[ks]);
      load_a<D>(sVl, warp * 16, ks, g, t, dolf[ks]);
    }
  }

  // this thread's rows: row_a (C values 0, 1) and row_b = row_a + 8 (2, 3)
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;
  const float lse_a = row_a < S ? lse_bh[row_a] * kLog2e : 0.f;
  const float lse_b = row_b < S ? lse_bh[row_b] * kLog2e : 0.f;
  const float dl_a = row_a < S ? delta_bh[row_a] : 0.f;
  const float dl_b = row_b < S ? delta_bh[row_b] : 0.f;

  float acc[kOTiles][4];
#pragma unroll
  for (int i = 0; i < kOTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  const int n_kt = (k_end + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tiles
    load_tile<T, D, SPLIT>(kb, k_ss, k0, S, kBlockK, sK, sKl);
    load_tile<T, D, SPLIT>(vb, v_ss, k0, S, kBlockK, sV, sVl);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      // S and dP for keys k0 + 16 j .. + 15: n-tiles 2j and 2j + 1
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.f;
        dp[nn][0] = dp[nn][1] = dp[nn][2] = dp[nn][3] = 0.f;
        const int n0 = (2 * j + nn) * 8;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t b0, b1, bl0 = 0u, bl1 = 0u;
          load_b_rows<D>(sK, n0, ks, g, t, &b0, &b1);
          if constexpr (SPLIT) load_b_rows<D>(sKl, n0, ks, g, t, &bl0, &bl1);
          mma_split<SPLIT>(s[nn], qf[ks], qlf[SPLIT ? ks : 0], b0, b1, bl0,
                           bl1);
          load_b_rows<D>(sV, n0, ks, g, t, &b0, &b1);
          if constexpr (SPLIT) load_b_rows<D>(sVl, n0, ks, g, t, &bl0, &bl1);
          mma_split<SPLIT>(dp[nn], dof[ks], dolf[SPLIT ? ks : 0], b0, b1, bl0,
                           bl1);
        }
      }
      // P = exp(s * scale - lse), zero where masked or out of range; then
      // dS = P (dP - Delta) scale, in place of s
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + (2 * j + nn) * 8 + 2 * t + (i & 1);
          const int row = i < 2 ? row_a : row_b;
          const bool keep = row < S && col < S && (!causal || col <= row);
          const float p =
              keep ? exp2f(s[nn][i] * scale_log2 - (i < 2 ? lse_a : lse_b))
                   : 0.f;
          s[nn][i] = p * (dp[nn][i] - (i < 2 ? dl_a : dl_b)) * scale;
        }
      }
      uint32_t da[4], dla[4];
      c_to_a<SPLIT>(s[0], s[1], da, dla);
      // dQ += dS K: B[k][n] = K[key 16 j + k][d 8 n + g]
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        uint32_t b0, b1, bl0 = 0u, bl1 = 0u;
        load_b_cols<D>(sK, j * 16, n * 8, g, t, &b0, &b1);
        if constexpr (SPLIT) load_b_cols<D>(sKl, j * 16, n * 8, g, t, &bl0, &bl1);
        mma_split<SPLIT>(acc[n], da, dla, b0, b1, bl0, bl1);
      }
    }
  }

  T* dqb = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < S)
      store_pair(dqb + (long long)row_a * dq_ss + col, acc[n][0], acc[n][1]);
    if (row_b < S)
      store_pair(dqb + (long long)row_b * dq_ss + col, acc[n][2], acc[n][3]);
  }
}

// dK and dV: one block per (64-key tile, batch * KV head); warp w owns keys
// k0 + 16 w .. k0 + 16 w + 15. The K and V tiles stay in shared memory; for
// each query head of the group and each q tile from the diagonal on, the
// block loads Q, dO, lse and Delta and, 16 queries at a time, forms S^T and
// dP^T, then P^T and dS^T, and adds P^T dO and dS^T Q into the accumulators.
template <typename T, int D, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int KVH,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long do_sb, long long do_ss, long long do_sh,
                     long long dk_sb, long long dk_ss, long long dk_sh,
                     long long dv_sb, long long dv_ss, long long dv_sh,
                     float scale, float scale_log2, int causal) {
  constexpr int kTileWords = kBlockK * lds<D>();
  constexpr int kKSteps = D / 16;  // k-steps of K Q^T and V dO^T
  constexpr int kOTiles = D / 8;   // n-tiles of dK and dV

  extern __shared__ uint32_t smem[];
  uint32_t* sK = smem;
  uint32_t* sV = sK + kTileWords;
  uint32_t* sQ = sV + kTileWords;
  uint32_t* sO = sQ + kTileWords;  // dO
  uint32_t* sKl = sO + kTileWords;  // lo parts: used only when SPLIT
  uint32_t* sVl = sKl + kTileWords;
  uint32_t* sQl = sVl + kTileWords;
  uint32_t* sOl = sQl + kTileWords;
  float* sLse = reinterpret_cast<float*>(smem + (SPLIT ? 8 : 4) * kTileWords);
  float* sDelta = sLse + kBlockQ;

  const int kt = blockIdx.y;  // causal: the first k tiles have the most work
  const int bkv = blockIdx.x;
  const int b = bkv / KVH;
  const int kvh = bkv % KVH;
  const int group = H / KVH;
  const int k0 = kt * kBlockK;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_tile<T, D, SPLIT>(k + b * k_sb + kvh * k_sh, k_ss, k0, S, kBlockK, sK,
                         sKl);
  load_tile<T, D, SPLIT>(v + b * v_sb + kvh * v_sh, v_ss, k0, S, kBlockK, sV,
                         sVl);

  // this thread's keys: key_a (C values 0, 1) and key_b = key_a + 8 (2, 3)
  const int key_a = k0 + warp * 16 + g;
  const int key_b = key_a + 8;

  float dka[kOTiles][4], dva[kOTiles][4];
#pragma unroll
  for (int i = 0; i < kOTiles; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  const int qt0 = causal ? k0 / kBlockQ : 0;

  for (int r = 0; r < group; ++r) {
    const int h = kvh * group + r;
    const int bh = b * H + h;
    const T* qb = q + b * q_sb + h * q_sh;
    const T* dob = dout + b * do_sb + h * do_sh;
    const float* lse_bh = lse + (long long)bh * S;
    const float* delta_bh = delta + (long long)bh * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // every warp is done with the previous tiles
      load_tile<T, D, SPLIT>(qb, q_ss, q0, S, kBlockQ, sQ, sQl);
      load_tile<T, D, SPLIT>(dob, do_ss, q0, S, kBlockQ, sO, sOl);
      for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
        const int row = q0 + i;
        sLse[i] = row < S ? lse_bh[row] * kLog2e : 0.f;
        sDelta[i] = row < S ? delta_bh[row] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int j = 0; j < kBlockQ / 16; ++j) {
        // S^T and dP^T for queries q0 + 16 j .. + 15: n-tiles 2j and 2j + 1
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          st[nn][0] = st[nn][1] = st[nn][2] = st[nn][3] = 0.f;
          dpt[nn][0] = dpt[nn][1] = dpt[nn][2] = dpt[nn][3] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t ka[4], kla[4], va[4], vla[4];
          load_a<D>(sK, warp * 16, ks, g, t, ka);
          load_a<D>(sV, warp * 16, ks, g, t, va);
          if constexpr (SPLIT) {
            load_a<D>(sKl, warp * 16, ks, g, t, kla);
            load_a<D>(sVl, warp * 16, ks, g, t, vla);
          }
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const int n0 = (2 * j + nn) * 8;
            uint32_t b0, b1, bl0 = 0u, bl1 = 0u;
            load_b_rows<D>(sQ, n0, ks, g, t, &b0, &b1);
            if constexpr (SPLIT) load_b_rows<D>(sQl, n0, ks, g, t, &bl0, &bl1);
            mma_split<SPLIT>(st[nn], ka, kla, b0, b1, bl0, bl1);
            load_b_rows<D>(sO, n0, ks, g, t, &b0, &b1);
            if constexpr (SPLIT) load_b_rows<D>(sOl, n0, ks, g, t, &bl0, &bl1);
            mma_split<SPLIT>(dpt[nn], va, vla, b0, b1, bl0, bl1);
          }
        }
        // P^T = exp(s * scale - lse[query]), zero where masked or out of
        // range, in place of S^T; dS^T = P^T (dP^T - Delta[query]) scale in
        // place of dP^T
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ql = (2 * j + nn) * 8 + 2 * t + (i & 1);
            const int query = q0 + ql;
            const int key = i < 2 ? key_a : key_b;
            const bool keep =
                query < S && key < S && (!causal || key <= query);
            const float p =
                keep ? exp2f(st[nn][i] * scale_log2 - sLse[ql]) : 0.f;
            st[nn][i] = p;
            dpt[nn][i] = p * (dpt[nn][i] - sDelta[ql]) * scale;
          }
        }
        uint32_t pa[4], pla[4], da[4], dla[4];
        c_to_a<SPLIT>(st[0], st[1], pa, pla);
        c_to_a<SPLIT>(dpt[0], dpt[1], da, dla);
        // dV += P^T dO and dK += dS^T Q: B[k][n] = X[query 16 j + k][d 8 n + g]
#pragma unroll
        for (int n = 0; n < kOTiles; ++n) {
          uint32_t b0, b1, bl0 = 0u, bl1 = 0u;
          load_b_cols<D>(sO, j * 16, n * 8, g, t, &b0, &b1);
          if constexpr (SPLIT) load_b_cols<D>(sOl, j * 16, n * 8, g, t, &bl0, &bl1);
          mma_split<SPLIT>(dva[n], pa, pla, b0, b1, bl0, bl1);
          load_b_cols<D>(sQ, j * 16, n * 8, g, t, &b0, &b1);
          if constexpr (SPLIT) load_b_cols<D>(sQl, j * 16, n * 8, g, t, &bl0, &bl1);
          mma_split<SPLIT>(dka[n], da, dla, b0, b1, bl0, bl1);
        }
      }
    }
  }

  T* dkb = dk + b * dk_sb + kvh * dk_sh;
  T* dvb = dv + b * dv_sb + kvh * dv_sh;
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int col = n * 8 + 2 * t;
    if (key_a < S) {
      store_pair(dkb + (long long)key_a * dk_ss + col, dka[n][0], dka[n][1]);
      store_pair(dvb + (long long)key_a * dv_ss + col, dva[n][0], dva[n][1]);
    }
    if (key_b < S) {
      store_pair(dkb + (long long)key_b * dk_ss + col, dka[n][2], dka[n][3]);
      store_pair(dvb + (long long)key_b * dv_ss + col, dva[n][2], dva[n][3]);
    }
  }
}

template <typename T, int D, bool SPLIT>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int S, int H, int KVH,
                      const long long* st, int causal, cudaStream_t stream) {
  constexpr int kTileBytes = kBlockK * lds<D>() * 4;
  constexpr int kSmem = (SPLIT ? 4 : 2) * kTileBytes;
  auto kernel = flash_bwd_dq_kernel<T, D, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)D);
  dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, H, KVH, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
      st[14], scale, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename T, int D, bool SPLIT>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H, int KVH,
                       const long long* st, int causal, cudaStream_t stream) {
  constexpr int kTileBytes = kBlockK * lds<D>() * 4;
  constexpr int kSmem = (SPLIT ? 8 : 4) * kTileBytes + 2 * kBlockQ * 4;
  auto kernel = flash_bwd_dkv_kernel<T, D, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)D);
  dim3 grid(B * KVH, (S + kBlockK - 1) / kBlockK);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, KVH, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14], st[15], st[16], st[17], scale, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

}  // namespace

// Both entry points: dtype 0 = bf16, 1 = fp32; lse and delta are fp32
// (B * H, S), contiguous. strides (in elements) of dims b, s, h of q, k, v,
// dO, then the outputs (dq; or dk, dv), each with a contiguous last dim.
// They return a cudaError_t (0 on success); an unsupported head_dim or dtype
// returns cudaErrorInvalidValue.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int dtype, int B,
                            int S, int H, int KVH, int D,
                            const long long* strides, int causal,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dq<__nv_bfloat16, 64, false>(q, k, v, dout, lse, delta, dq,
                                               B, S, H, KVH, strides, causal,
                                               st);
  if (dtype == 0 && D == 128)
    return launch_dq<__nv_bfloat16, 128, false>(q, k, v, dout, lse, delta, dq,
                                                B, S, H, KVH, strides, causal,
                                                st);
  if (dtype == 1 && D == 64)
    return launch_dq<float, 64, true>(q, k, v, dout, lse, delta, dq, B, S, H,
                                      KVH, strides, causal, st);
  if (dtype == 1 && D == 128)
    return launch_dq<float, 128, true>(q, k, v, dout, lse, delta, dq, B, S, H,
                                       KVH, strides, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int dtype,
                             int B, int S, int H, int KVH, int D,
                             const long long* strides, int causal,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dkv<__nv_bfloat16, 64, false>(q, k, v, dout, lse, delta, dk,
                                                dv, B, S, H, KVH, strides,
                                                causal, st);
  if (dtype == 0 && D == 128)
    return launch_dkv<__nv_bfloat16, 128, false>(q, k, v, dout, lse, delta,
                                                 dk, dv, B, S, H, KVH, strides,
                                                 causal, st);
  if (dtype == 1 && D == 64)
    return launch_dkv<float, 64, true>(q, k, v, dout, lse, delta, dk, dv, B,
                                       S, H, KVH, strides, causal, st);
  if (dtype == 1 && D == 128)
    return launch_dkv<float, 128, true>(q, k, v, dout, lse, delta, dk, dv, B,
                                        S, H, KVH, strides, causal, st);
  return (int)cudaErrorInvalidValue;
}
