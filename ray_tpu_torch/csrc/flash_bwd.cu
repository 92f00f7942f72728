// Flash-attention backward for Hopper (sm_90a), bound to Python through
// ctypes.
//
// Replaces the TPU kernels ray_tpu/ops/attention.py:_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (launched by flash_attention_bwd through
// pl.pallas_call). Same function, with the softmax rebuilt from the lse the
// forward saved (P = exp(s * scale - lse), masked scores -1e30) and
// Delta = rowsum(dO * O) computed beforehand by the caller:
//   dP = dO V^T,  dS = P * (dP - Delta) * scale,
//   dQ = dS K,    dK = dS^T Q,    dV = P^T dO,
// with fp32 accumulation; dk and dv are stored in k's dtype, dq in q's.
//
// Entry points (at the bottom of this file), and which TPU kernel each
// stands for:
// - flash_bwd (bf16): both TPU kernels in one, flash_bwd_kernel<D, true>.
//   What the bf16 backward runs (ops/attention.py:flash_attention_bwd).
// - flash_bwd_dkv: _flash_bwd_dkv_kernel. bf16 on flash_bwd_kernel<D,
//   false> (the same kernel without dQ), fp32 on the mma.sync kernel.
// - flash_bwd_dq: _flash_bwd_dq_kernel on the mma.sync kernel, bf16 and
//   fp32. fp32's backward is this pair.
// - flash_bwd_dkv_mma: the mma.sync dK/dV in bf16, which with flash_bwd_dq
//   is the earlier bf16 pair, kept only as the chip smoke's yardstick.
// - flash_bwd_prep: Delta = rowsum(dO * O) in fp32, which the JAX package
//   computes with plain XLA (ray_tpu/ops/attention.py:236-239, not a
//   Pallas kernel), and in the same launch the zeros that flash_bwd adds
//   dQ into and orders its adds with. Both dtypes' backward runs it first
//   (fp32 for Delta alone). As one torch expression Delta cost more than
//   the fused kernel: fp32 copies of o and dO and a batched product of
//   1 x D by D x 1; this kernel reads o and dO once.
// - flash_bwd_delta: Delta alone, the earlier design of the prep's Delta,
//   kept only as the chip smoke's yardstick.
//
// What changed against the TPU kernels, in both designs:
// - q and dO are read as (B, S, H, D), k and v as (B, S, KVH, D), through
//   their strides (query head h reads KV head h / (H / KVH)), as in the
//   forward. The JAX model repeats K/V to H heads, so its dK and dV come out
//   per query head and autodiff sums them over each group. Here a block that
//   owns a key tile of one KV head loops over the H / KVH query heads of the
//   group, so the group's sum is taken in its fp32 accumulators: no
//   (B, S, H, D) temporary, and dK, dV do not depend on the order blocks run
//   in.
// - Any S >= 1: keys >= S and query rows >= S get P = 0, so they add nothing,
//   and rows >= S are not stored.
// - The TPU's sequential grid dimension becomes a loop inside the block.
// - S^T = K Q^T and dP^T = V dO^T are computed directly, so P^T and dS^T
//   come out of the products as accumulators that are the A operands of
//   P^T dO and dS^T Q in registers.
// For bf16 inputs P and dS are rounded to bf16 before the products that
// take them (the plain version keeps them in fp32; the tolerance of the
// comparison follows from that). fp32 inputs go through the hi/lo split of
// flash_common.cuh, P and dS included.
//
// What bounds it on this card. The split pair recomputes S and dP in both
// kernels: 14 D FLOPs per (q, k) pair. flash_bwd does five products a pair
// (S, dP, dV, dK, dQ: 10 D FLOPs), which at the 1b training shape (B=4,
// S=2048, H=16, KVH=8, D=128, causal; 1.343e8 pairs) is 0.1738 ms of
// tensor-core work at 989 TFLOP/s, against 0.20 GB of traffic counted once
// each (q, k, v, dO 0.134 GB and lse, Delta read; dk, dv 0.034 GB and the
// fp32 dQ accumulator 0.067 GB written), 0.06 ms at 3.35 TB/s. So it is
// bound by the tensor cores.
//
// bf16 (head dims 64 and 128): flash_bwd_kernel, warp-specialised like the
// forward (flash_fwd.cu). A persistent grid of one block of three
// warpgroups per SM; a work item is a 128-key tile of one (batch, KV head),
// dealt longest first when causal (the first key tiles see the most q
// tiles). What it does about each limit of the mma.sync pair:
// - products on wgmma instead of mma.sync.m16n8k16: S^T and dP^T as
//   m64n64k16 with both operands in shared memory, dV and dK as m64n{D}k16
//   with P^T, dS^T from registers, dQ as m64n64k16 from shared memory;
// - loads overlap products: warpgroup 0 gives up registers and one thread
//   issues every TMA copy, K and V of the item once (resident) and Q, dO
//   into a ring of stages (2 at D = 128, 3 at D = 64) running ahead across
//   items, with full and empty mbarriers; both consumers read every stage,
//   so a stage's empty barrier waits for both. The stage's 64 values of
//   lse and of Delta come by TMA too, through tensor maps that see each as
//   one flat dimension of B * H * S values: a (B * H, S) map would need
//   S * 4 bytes to be a multiple of 16, which S = 77 breaks. (Plain loads
//   by a second producer warp spilled its 24 registers.);
// - B operands that the pair gathered 16 bits at a time (dO, Q and K taken
//   as they lie) are read MN-major through descriptors;
// - 2 consumer warpgroups of 64 keys each (240 registers each with
//   setmaxnreg) keep dK and dV, 64 + 64 fp32 a thread at D = 128, in
//   registers across the item, where the pair re-read K's and V's fragments
//   from shared memory at every use to spare registers;
// - dQ is folded in, which saves recomputing S and dP: each consumer
//   writes its dS^T half into a shared tile (two, by the parity of the tile
//   count), swizzled as the descriptor reads it MN-major; after a named
//   barrier across the consumers, consumer cw takes dQ's columns 64 cw ..
//   + 63 over all 128 keys (D = 128; at D = 64 all columns over its own
//   keys), and one thread adds the fp32 result into the accumulator from a
//   staging tile with a TMA reduce-add, which skips rows >= S. Those fp32
//   adds come from different blocks; a counter a q tile puts them in a
//   fixed order (dq_index), so dQ is the same in every run, as dK and dV
//   are, which stay in one block's registers;
// - causal: a consumer whose keys lie wholly above a q tile's diagonal
//   skips its products (its dS half is zeros) but arrives on every
//   barrier; only tiles that cross the diagonal or S pay for the mask. TMA
//   fills key rows past S with zeros, which score 0, not -1e30, so the mask
//   covers keys >= S too. Query rows past S read zero Q and dO rows and
//   some other row's lse, so their P is kept finite (bwd_probs) and adds
//   nothing; they are not stored.
// dK and dV leave through the staging tile as bf16 with TMA stores.
//
// fp32, flash_bwd_dq and flash_bwd_dkv_mma: the mma.sync design, one block
// of 4 warps per 64-row tile (q tile for dQ, key tile for dK/dV), tiles
// loaded by the threads between __syncthreads(), B operands gathered from
// shared memory 16 bits at a time.

#include "flash_common.cuh"
#include "hopper.cuh"

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

// -- bf16: TMA ring, warp-specialised wgmma ---------------------------------

constexpr int kWsKeys = 128;          // keys of a work item, 64 a consumer
constexpr int kWsQ = 64;              // query rows of a ring stage
constexpr int kWsThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kWsConsumers = 256;
constexpr int kQBox = kWsQ * 128;     // a 64-row TMA box of 64 bf16: 8 KB
constexpr int kKBox = kWsKeys * 128;  // a 128-row box: 16 KB
// A stage's lse and Delta: 68-value TMA boxes from the row rounded down to
// 16 bytes, 384 bytes apart (TMA writes shared memory 128-byte aligned)
constexpr int kStatBox = kWsQ + 4;
constexpr int kStatStride = 384;
constexpr int kStatBytes = 2 * kStatStride;

// The block's shared memory from a 1024-byte aligned base: K and V of the
// item (resident), the ring's Q and dO tiles, two dS tiles (128 keys x 64
// q, bf16, one per parity of the tile count), each consumer's 16 KB staging
// tile (dQ in fp32 on its way to the reduce-add; dK, dV in bf16 on their
// way out), the ring's lse and Delta, the mbarriers (KV full, KV empty;
// for each stage full, then for each stage empty), then each consumer's
// pending dQ share (dq_index's note). A tile is D / 64 boxes side by side,
// box c holding columns 64c .. 64c + 63.
template <int D>
struct BwdSmem {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kKTile = D / 64 * kKBox;
  static constexpr int kQTile = D / 64 * kQBox;
  static constexpr int kV = kKTile;
  static constexpr int kRing = kV + kKTile;
  static constexpr int kDS = kRing + kStages * 2 * kQTile;
  static constexpr int kDSBytes = kWsKeys * 128;
  static constexpr int kStg = kDS + 2 * kDSBytes;
  static constexpr int kStgBytes = kWsQ * 64 * 4;
  static constexpr int kStats = kStg + 2 * kStgBytes;
  static constexpr int kBars = kStats + kStages * kStatBytes;
  static constexpr int kPend = kBars + 8 * (2 + 2 * kStages);
  static constexpr int kBytes = kPend + 8 + 1024;

  __device__ static uint32_t full(uint32_t base, int s) {
    return base + kBars + 16 + 8 * s;
  }
  __device__ static uint32_t empty(uint32_t base, int s) {
    return base + kBars + 16 + 8 * (kStages + s);
  }
  __device__ static uint32_t q_tile(uint32_t base, int s) {
    return base + kRing + s * 2 * kQTile;
  }
  __device__ static uint32_t do_tile(uint32_t base, int s) {
    return q_tile(base, s) + kQTile;
  }
  __device__ static uint32_t stats(uint32_t base, int s) {
    return base + kStats + s * kStatBytes;
  }
};

// Where the block's next q tile lies in the ring: its stage, the parity of
// the ring's lap (the phase its full barrier completes; its empty barrier
// completed the phase before once the ring has gone round).
template <int kStages>
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  bool wrapped = false;
  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
      wrapped = true;
    }
  }
};

// A work item: the 128-key tile at k0 of one (batch, KV head). Items are
// numbered with the key tile major; blocks take them in the snake order of
// work_index. Without dQ the first key tiles, which see the most q tiles
// when causal, come first. With dQ the last come first (dq_index's note).
// An item walks the group's query heads in turn and, for each, the 64-row
// q tiles from qt0 (the diagonal when causal) on.
struct BwdWork {
  int b, kvh, k0, qt0;
};

__device__ __forceinline__ BwdWork bwd_work(int w, int n_work, int B,
                                            int KVH, int causal,
                                            bool last_first) {
  const int n_bkv = B * KVH;
  if (last_first) w = n_work - 1 - w;
  BwdWork wk;
  wk.b = w % n_bkv / KVH;
  wk.kvh = w % n_bkv % KVH;
  wk.k0 = w / n_bkv * kWsKeys;
  wk.qt0 = causal ? wk.k0 / kWsQ : 0;
  return wk;
}

// The order of dQ's adds. Each q tile's dQ is the sum of the shares of the
// key tiles that see it, added into the fp32 accumulator by TMA
// reduce-adds from different blocks, so their order would change from run
// to run and dQ's last bits with it. A counter a (batch, head, q tile),
// zero at the launch, fixes it: the shares go in from the last key tile
// that sees the q tile down to the first, and each consumer, skipped ones
// too, counts its share in once its adds have landed. At D = 128 the two
// consumers of an item add disjoint columns and go in together; at D = 64
// both add every column, so consumer 1 goes first.
//
// Why the order ends and what it costs: items are dealt last key tile
// first, so a share waits only on items with a lower work index, which no
// block holds behind an item with a higher one; the lowest unfinished item
// never waits, so every item ends. When causal, a key tile's first q tile
// is two past the one before it, so an item keeps behind the items whose
// shares precede its own. Thread 0 of a consumer signals a share at its
// next tile's adds (or at the item's end), when they have long landed, and
// reads the counter while its warpgroup fills the staging tile, so it
// waits neither on its own reduce-add nor on the read; the pending share
// waits in shared memory, since the products need every register. The
// counter takes relaxed loads and adds only: a share's add is issued after
// its wait_group 0 has seen the reduce-adds before it complete, and the
// next share's adds only after its load has seen that count, every access
// at the L2. A wait past 2^25 polls (tens of seconds) traps: an error,
// not a hung card.

// The counter of q tile q0 of (b, h): its index in dq_count.
__device__ __forceinline__ int dq_index(int b, int h, int H, int q0, int S) {
  return (b * H + h) * ((S + kWsQ - 1) / kWsQ) + q0 / kWsQ;
}

// The count at the turn of consumer cw of the item at k0 on q tile q0: the
// key tiles that see q0 are 0 .. last (causal: k0 <= q0), and those after
// k0 go first, two consumers each.
__device__ __forceinline__ int dq_want(int q0, int k0, int S, int causal,
                                       int D, int cw) {
  const int n_kt = (S + kWsKeys - 1) / kWsKeys;
  const int last = causal ? min(q0 / kWsKeys, n_kt - 1) : n_kt - 1;
  return 2 * (last - k0 / kWsKeys) + (D == 64 ? 1 - cw : 0);
}

// `seen`: a load of the counter issued earlier. The poll is one PTX loop:
// written in C++, its count and trap cost the consumers' products spilled
// registers.
__device__ __forceinline__ void dq_wait(const int* count, int want,
                                        int seen) {
  if (seen < want) {
    asm volatile(
        "{\n.reg .pred done, late;\n.reg .s32 v;\n.reg .u32 n;\n"
        "mov.u32 n, 0;\n"
        "WAIT_%=:\n"
        "ld.relaxed.gpu.global.s32 v, [%0];\n"
        "setp.ge.s32 done, v, %1;\n"
        "@done bra.uni DONE_%=;\n"
        "nanosleep.u32 64;\n"
        "add.u32 n, n, 1;\n"
        "setp.gt.u32 late, n, 33554432;\n"
        "@late trap;\n"
        "bra.uni WAIT_%=;\n"
        "DONE_%=:\n}\n" ::"l"(count),
        "r"(want)
        : "memory");
  }
  hopper::fence_proxy_async_global();
}

// The caller's reduce-adds of this share have completed (wait_group 0).
__device__ __forceinline__ void dq_signal(int* count) {
  hopper::fence_proxy_async_global();
  hopper::red_add_relaxed_gpu(count, 1);
}

// Signal the share whose adds are in flight, if any: the index of its
// counter waits in shared memory (`slot`, -1 for none), not in registers,
// which the products need.
__device__ __forceinline__ void dq_flush(int* counters, uint32_t slot) {
  const int pending = (int)hopper::ld_shared_u32(slot);
  if (pending >= 0) {
    hopper::tma_store_wait<0>();
    dq_signal(counters + pending);
    hopper::st_shared(slot, 0xffffffffu);
  }
}

// P^T of one tile in registers, in place of S^T: sc holds S^T of the
// consumer's 64 keys (rows key_a, key_a + 8 of the accumulator) and the
// stage's 64 queries (columns 8n + 2t + {0, 1}); `stats` holds the queries'
// lse. On return sc holds P^T = 2^(s scale log2 e - lse log2 e) in fp32 and
// p the same as bf16 pairs, the A fragments of P^T dO. The exponent is
// clamped at 0: P <= 1 wherever lse is the row's (the forward's sum in
// another order can put it 1e-6 below a score), and rows >= S, whose lse
// slots hold another row's (or zeros past the tensor), meet zero rows of Q
// and dO and are not stored, so a finite P there adds nothing. kMask zeroes
// P where key > query (causal) or key >= S.
template <bool kMask>
__device__ __forceinline__ void bwd_probs(float (&sc)[32], uint32_t (&p)[16],
                                          uint32_t stats, int t, int key_a,
                                          int q0, int S, int causal,
                                          float scale_log2) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint32_t at = stats + (8 * n + 2 * t) * 4;
    const float lse_a = hopper::ld_shared_f32(at) * kLog2e;
    const float lse_b = hopper::ld_shared_f32(at + 4) * kLog2e;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = exp2_approx(fminf(
          fmaf(sc[4 * n + i], scale_log2, -((i & 1) ? lse_b : lse_a)), 0.f));
      if constexpr (kMask) {
        const int key = i < 2 ? key_a : key_a + 8;
        const int query = q0 + 8 * n + 2 * t + (i & 1);
        if (key >= S || (causal && key > query)) x = 0.f;
      }
      sc[4 * n + i] = x;
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// dS^T = P^T (dP^T - Delta) scale from the fp32 P^T in pr and dP^T in dp
// (the same layout), Delta from `stats` + kStatStride; as bf16 pairs in
// ds, the A fragments of dS^T Q.
__device__ __forceinline__ void bwd_dscores(const float (&pr)[32],
                                            float (&dp)[32],
                                            uint32_t (&ds)[16],
                                            uint32_t stats, int t,
                                            float scale) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint32_t at = stats + kStatStride + (8 * n + 2 * t) * 4;
    const float dl_a = hopper::ld_shared_f32(at);
    const float dl_b = hopper::ld_shared_f32(at + 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dp[4 * n + i] =
          pr[4 * n + i] * (dp[4 * n + i] - ((i & 1) ? dl_b : dl_a)) * scale;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) ds[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
}

// One consumer's 64 x D accumulator (rows = keys) as bf16 into its staging
// tile, 128-byte swizzled (16-byte chunk c of row r at c ^ (r % 8)), then
// stored by one thread with TMA, which skips rows >= S. The staging tile's
// earlier TMA operation must have read it first.
template <int D>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[D / 2],
                                                uint32_t stg, int tid,
                                                int warp, int g, int t,
                                                int bar,
                                                const CUtensorMap* map,
                                                int kvh, int row0, int b) {
  if (tid == 0) hopper::tma_store_wait_read<0>();
  hopper::bar_sync<128>(bar);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t at = stg + (j / 8) * kQBox + (16 * warp + g) * 128 +
                        ((j % 8) ^ g) * 16 + 4 * t;
    hopper::st_shared(at, pack_bf16(acc[4 * j], acc[4 * j + 1]));
    hopper::st_shared(at + 8 * 128, pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
  }
  hopper::fence_proxy_async();
  hopper::bar_sync<128>(bar);
  if (tid == 0) {
    for (int c = 0; c < D / 64; ++c)
      hopper::tma_store_4d(map, stg + c * kQBox, 64 * c, kvh, row0, b);
    hopper::tma_store_commit();
  }
}

// dK and dV of one 128-key tile of one (batch, KV head) a work item, and
// with kWithDQ each q tile's share of dQ added into the fp32 accumulator.
// Warpgroup 0 loads, warpgroups 1 and 2 each own 64 of the tile's keys.
template <int D, bool kWithDQ>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tdk,
                 const __grid_constant__ CUtensorMap tdv,
                 const __grid_constant__ CUtensorMap tdq,
                 const __grid_constant__ CUtensorMap tlse,
                 const __grid_constant__ CUtensorMap tdelta,
                 int* __restrict__ dq_count, int B, int S, int H, int KVH,
                 float scale, float scale_log2, int causal) {
  using L = BwdSmem<D>;
  constexpr int kStages = L::kStages;
  constexpr int kBoxes = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_full = base + L::kBars;
  const uint32_t kv_empty = kv_full + 8;
  const int n_work = (S + kWsKeys - 1) / kWsKeys * B * KVH;
  const int group = H / KVH;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    hopper::mbar_init(kv_empty, kWsConsumers);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(L::full(base, s), 1);
      hopper::mbar_init(L::empty(base, s), kWsConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // The ring runs on across work items; every role walks the same tiles
  // and keeps its own RingPos.
  if (threadIdx.x < 128) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      // one thread issues every TMA copy: K and V of the item once both
      // consumers are done with the item before, then a stage's Q, dO and
      // the 64 rows' lse and Delta
      RingPos<kStages> pos;
      for (int round = 0;; ++round) {
        const int w = work_index(round);
        if (w >= n_work) break;
        const BwdWork wk = bwd_work(w, n_work, B, KVH, causal, kWithDQ);
        if (round > 0) hopper::mbar_wait(kv_empty, (round - 1) & 1);
        hopper::mbar_arrive_expect_tx(kv_full, 2 * L::kKTile);
        for (int c = 0; c < kBoxes; ++c) {
          hopper::tma_load_4d(base + c * kKBox, &tk, kv_full, 64 * c, wk.kvh,
                              wk.k0, wk.b);
          hopper::tma_load_4d(base + L::kV + c * kKBox, &tv, kv_full, 64 * c,
                              wk.kvh, wk.k0, wk.b);
        }
        for (int h = wk.kvh * group; h < (wk.kvh + 1) * group; ++h) {
          for (int q0 = wk.qt0 * kWsQ; q0 < S; q0 += kWsQ, pos.next()) {
            if (pos.wrapped)
              hopper::mbar_wait(L::empty(base, pos.stage), pos.phase ^ 1);
            const uint32_t full = L::full(base, pos.stage);
            const uint32_t dst = L::q_tile(base, pos.stage);
            const uint32_t st = L::stats(base, pos.stage);
            hopper::mbar_arrive_expect_tx(full, 2 * L::kQTile + 2 * kStatBox * 4);
            for (int c = 0; c < kBoxes; ++c) {
              hopper::tma_load_4d(dst + c * kQBox, &tq, full, 64 * c, h, q0,
                                  wk.b);
              hopper::tma_load_4d(dst + L::kQTile + c * kQBox, &tdo, full,
                                  64 * c, h, q0, wk.b);
            }
            // the box starts on a 16-byte boundary, which TMA requires:
            // the row rounded down to a multiple of 4 values
            const int row = ((wk.b * H + h) * S + q0) & ~3;
            hopper::tma_load_1d(st, &tlse, full, row);
            hopper::tma_load_1d(st + kStatStride, &tdelta, full, row);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns keys k0 + 64 cw .. k0 + 64 cw + 63
  hopper::setmaxnreg_inc<240>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within an 8-row group of the accumulator
  const int t = lane % 4;  // thread within the quad
  const uint32_t k_rows = base + cw * 64 * 128;  // these 64 keys of box 0
  const uint32_t v_rows = base + L::kV + cw * 64 * 128;
  const uint32_t stg = base + L::kStg + cw * L::kStgBytes;
  // Named barriers: 1 holds the two consumers together around a dS tile
  // (D = 128, where each reads the other's keys); 2 + cw holds one
  // consumer's threads together around its own tiles.
  const int my_bar = 2 + cw;
  // dQ = dS K: at D = 128 consumer cw takes dQ's columns 64 cw .. + 63 over
  // all 128 keys; at D = 64 it takes all 64 columns over its own 64 keys,
  // and the two halves meet in the reduce-add.
  constexpr int kDQSteps = D == 128 ? 8 : 4;
  const int dq_key0 = D == 128 ? 0 : 64 * cw;
  const uint32_t dq_k = base + (D == 128 ? cw * kKBox : 0) + dq_key0 * 128;
  const int dq_col0 = D == 128 ? 64 * cw : 0;

  RingPos<kStages> pos;
  int ds_parity = 0;  // which dS tile this q tile writes
  // thread 0's share whose adds are in flight, signalled at the next
  // tile's adds or at the item's end (dq_index's note)
  const uint32_t pend_slot = base + L::kPend + 4 * cw;
  if (kWithDQ && tid == 0) hopper::st_shared(pend_slot, 0xffffffffu);
  for (int round = 0;; ++round) {
    const int w = work_index(round);
    if (w >= n_work) break;
    const BwdWork wk = bwd_work(w, n_work, B, KVH, causal, kWithDQ);
    const int key_lo = wk.k0 + 64 * cw;  // this consumer's first key
    const int key_a = key_lo + 16 * warp + g;

    // dK and dV accumulators: dk[4j .. 4j + 3] hold columns 8j + 2t +
    // {0, 1} of keys key_a (0, 1) and key_a + 8 (2, 3)
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    hopper::mbar_wait(kv_full, round & 1);

    for (int h = wk.kvh * group; h < (wk.kvh + 1) * group; ++h) {
      for (int q0 = wk.qt0 * kWsQ; q0 < S;
           q0 += kWsQ, pos.next(), ds_parity ^= 1) {
        const int s = pos.stage;
        const uint32_t q_tile = L::q_tile(base, s);
        const uint32_t do_tile = L::do_tile(base, s);
        // causal: keys wholly above the diagonal add nothing to dK, dV or
        // dQ; only tiles that cross the diagonal or S pay for the mask
        const bool skip = causal && key_lo > q0 + kWsQ - 1;
        const bool mask =
            (causal && key_lo + 63 > q0) || key_lo + 63 >= S;
        hopper::mbar_wait(L::full(base, s), pos.phase);
        // this tile's lse and Delta: the stage's boxes start up to 3 values
        // before its first row
        const uint32_t stats =
            L::stats(base, s) + 4 * (((wk.b * H + h) * S + q0) & 3);

        uint32_t p[16], ds[16];  // P^T and dS^T as bf16 pairs
        if (!skip) {
          // S^T = K Q^T and dP^T = V dO^T over the 64 keys, both operands
          // K-major: D / 16 k-steps each; then P, P^T dO issued, and dS
          // computed while P^T dO runs
          float sc[32], dp[32];
          hopper::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            const uint32_t ok = (ks / 4) * kKBox + (ks % 4) * 32;
            const uint32_t oq = (ks / 4) * kQBox + (ks % 4) * 32;
            hopper::wgmma_m64n64k16_ss<0, 0>(
                sc, hopper::desc_kmajor(k_rows + ok),
                hopper::desc_kmajor(q_tile + oq), ks > 0);
          }
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            const uint32_t ok = (ks / 4) * kKBox + (ks % 4) * 32;
            const uint32_t oq = (ks / 4) * kQBox + (ks % 4) * 32;
            hopper::wgmma_m64n64k16_ss<0, 0>(
                dp, hopper::desc_kmajor(v_rows + ok),
                hopper::desc_kmajor(do_tile + oq), ks > 0);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(sc);
          hopper::fence_regs(dp);
          if (mask)
            bwd_probs<true>(sc, p, stats, t, key_a, q0, S, causal,
                            scale_log2);
          else
            bwd_probs<false>(sc, p, stats, t, key_a, q0, S,
                             causal, scale_log2);
          // dV += P^T dO and dK += dS^T Q: A from registers (p + 4 kk is
          // the fragment of queries 16 kk .. + 15), B MN-major (16 query
          // rows are 2048 bytes; the next 64 columns are the next box)
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kWsQ / 16; ++kk) {
            const uint64_t bo = hopper::desc_mnmajor(do_tile + kk * 2048, kQBox);
            if constexpr (D == 128)
              hopper::wgmma_m64n128k16_rs<1>(dv, p + 4 * kk, bo, 1);
            else
              hopper::wgmma_m64n64k16_rs<1>(dv, p + 4 * kk, bo, 1);
          }
          hopper::wgmma_commit();
          bwd_dscores(sc, dp, ds, stats, t, scale);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kWsQ / 16; ++kk) {
            const uint64_t bq = hopper::desc_mnmajor(q_tile + kk * 2048, kQBox);
            if constexpr (D == 128)
              hopper::wgmma_m64n128k16_rs<1>(dk, ds + 4 * kk, bq, 1);
            else
              hopper::wgmma_m64n64k16_rs<1>(dk, ds + 4 * kk, bq, 1);
          }
          hopper::wgmma_commit();
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) p[i] = ds[i] = 0u;
        }

        if constexpr (kWithDQ) {
          // dS^T into the tile of this parity, rows = keys, 64 queries a
          // 128-byte row, swizzled as TMA would have written it, so that
          // the descriptor reads it as the MN-major A of dS K
          const uint32_t ds_tile = base + L::kDS + ds_parity * L::kDSBytes;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const uint32_t at = ds_tile + (64 * cw + 16 * warp + g) * 128 +
                                (jj ^ g) * 16 + 4 * t;
            hopper::st_shared(at, ds[2 * jj]);
            hopper::st_shared(at + 8 * 128, ds[2 * jj + 1]);
          }
          hopper::fence_proxy_async();
          if constexpr (D == 128)
            hopper::bar_sync<kWsConsumers>(1);
          else
            hopper::bar_sync<128>(my_bar);
          // at D = 64 a skipped consumer's share of dQ is zero
          const bool dq_zero = D == 64 && skip;
          float dq[32];
          if (!dq_zero) {
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kDQSteps; ++kk)
              hopper::wgmma_m64n64k16_ss<1, 1>(
                  dq,
                  hopper::desc_mnmajor(
                      ds_tile + (dq_key0 + 16 * kk) * 128, L::kDSBytes),
                  hopper::desc_mnmajor(dq_k + kk * 2048, kKBox), kk > 0);
            hopper::wgmma_commit();
          }
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dk);
          hopper::fence_regs(dv);
          hopper::fence_regs(p);
          hopper::fence_regs(ds);
          if (!dq_zero) hopper::fence_regs(dq);
          hopper::mbar_arrive(L::empty(base, s));
          if (!dq_zero) {
            // dQ (64 q rows x 64 columns, fp32) through the staging tile:
            // two 32-column boxes, 128-byte swizzled, reduce-added by one
            // thread in its turn; the tile's previous TMA operation must
            // have landed, and its share is then signalled
            int seen = 0;
            if (tid == 0) {
              hopper::tma_store_wait<0>();
              dq_flush(dq_count, pend_slot);
              seen = hopper::ld_relaxed_gpu(
                  dq_count + dq_index(wk.b, h, H, q0, S));
            }
            hopper::bar_sync<128>(my_bar);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const uint32_t at = stg + (jj / 4) * kQBox +
                                  (16 * warp + g) * 128 +
                                  ((2 * (jj % 4) + t / 2) ^ g) * 16 +
                                  8 * (t % 2);
              hopper::st_shared_f32x2(at, dq[4 * jj], dq[4 * jj + 1]);
              hopper::st_shared_f32x2(at + 8 * 128, dq[4 * jj + 2],
                                      dq[4 * jj + 3]);
            }
            hopper::fence_proxy_async();
            hopper::bar_sync<128>(my_bar);
            if (tid == 0) {
              const int idx = dq_index(wk.b, h, H, q0, S);
              dq_wait(dq_count + idx, dq_want(q0, wk.k0, S, causal, D, cw),
                      seen);
              for (int c = 0; c < 2; ++c)
                hopper::tma_reduce_add_4d(&tdq, stg + c * kQBox,
                                          dq_col0 + 32 * c, h, q0, wk.b);
              hopper::tma_store_commit();
              hopper::st_shared(pend_slot, (uint32_t)idx);
            }
          } else if (tid == 0) {
            // a skipped consumer's share is zero: only its turn
            int* count = dq_count + dq_index(wk.b, h, H, q0, S);
            dq_wait(count, dq_want(q0, wk.k0, S, causal, D, cw),
                    hopper::ld_relaxed_gpu(count));
            dq_signal(count);
          }
        } else {
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dk);
          hopper::fence_regs(dv);
          hopper::fence_regs(p);
          hopper::fence_regs(ds);
          hopper::mbar_arrive(L::empty(base, s));
        }
      }
    }
    if constexpr (kWithDQ) {
      if (tid == 0) dq_flush(dq_count, pend_slot);
    }
    // K and V are free for the next item; dK and dV go out through the
    // staging tile, rows >= S skipped by TMA
    hopper::mbar_arrive(kv_empty);
    store_rows_bf16<D>(dk, stg, tid, warp, g, t, my_bar, &tdk, wk.kvh, key_lo,
                       wk.b);
    store_rows_bf16<D>(dv, stg, tid, warp, g, t, my_bar, &tdv, wk.kvh, key_lo,
                       wk.b);
  }
  // the block's shared memory must outlive its last store
  if (tid == 0) hopper::tma_store_wait<0>();
}

template <int D, bool kWithDQ>
cudaError_t launch_ws(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, void* dq_acc, void* dq_count,
                      int B, int S, int H, int KVH, const long long* st,
                      int causal, cudaStream_t stream) {
  // strides: q, k, v, dO, dk, dv, then (kWithDQ) the fp32 accumulator
  CUtensorMap tq, tk, tv, tdo, tdk, tdv, tdq, tlse, tdelta;
  if (!hopper::encode_bf16_rows(&tq, q, B, S, H, D, st[0], st[1], st[2],
                                kWsQ) ||
      !hopper::encode_bf16_rows(&tk, k, B, S, KVH, D, st[3], st[4], st[5],
                                kWsKeys) ||
      !hopper::encode_bf16_rows(&tv, v, B, S, KVH, D, st[6], st[7], st[8],
                                kWsKeys) ||
      !hopper::encode_bf16_rows(&tdo, dout, B, S, H, D, st[9], st[10],
                                st[11], kWsQ) ||
      !hopper::encode_bf16_rows(&tdk, dk, B, S, KVH, D, st[12], st[13],
                                st[14], 64) ||
      !hopper::encode_bf16_rows(&tdv, dv, B, S, KVH, D, st[15], st[16],
                                st[17], 64) ||
      !hopper::encode_f32_flat(&tlse, lse, (long long)B * H * S, kStatBox) ||
      !hopper::encode_f32_flat(&tdelta, delta, (long long)B * H * S,
                               kStatBox))
    return cudaErrorInvalidValue;
  if constexpr (kWithDQ) {
    if (!hopper::encode_f32_rows(&tdq, dq_acc, B, S, H, D, st[18], st[19],
                                 st[20], kWsQ))
      return cudaErrorInvalidValue;
  } else {
    tdq = tdk;  // not read
  }
  constexpr int kSmem = BwdSmem<D>::kBytes;
  auto kernel = flash_bwd_kernel<D, kWithDQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, n_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  // persistent: one block per SM (or per item, when there are fewer)
  const int n_work = (S + kWsKeys - 1) / kWsKeys * B * KVH;
  const float scale = 1.f / sqrtf((float)D);
  kernel<<<min(n_work, n_sm), kWsThreads, kSmem, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, tdq, tlse, tdelta,
      static_cast<int*>(dq_count), B, S, H, KVH, scale, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

// -- Delta = rowsum(dO * O) ------------------------------------------------

// D / kVec threads per row (b, s, h) of o and dO, each with one 16-byte
// load of each: they multiply in fp32 and sum across the row's threads; the
// result goes to delta[(b * H + h) * S + s]. The products are exact (bf16
// or fp32 inputs, fp32 arithmetic); only the order of the fp32 sum differs
// from the plain version's. D is 64 or 128, so a row's threads (8 to 32)
// lie in one warp.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int n_rows, int S, int H,
                       long long o_sb, long long o_ss, long long o_sh,
                       long long do_sb, long long do_ss, long long do_sh) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = D / kVec;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  const int row = idx / kLanes;
  const int col = idx % kLanes * kVec;
  float sum = 0.f;
  if (row < n_rows) {
    const int h = row % H, s = row / H % S, b = row / H / S;
    const uint4 x = *reinterpret_cast<const uint4*>(o + b * o_sb + s * o_ss +
                                                    h * o_sh + col);
    const uint4 y = *reinterpret_cast<const uint4*>(
        dout + b * do_sb + s * do_ss + h * do_sh + col);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        sum = fmaf(__uint_as_float(xs[i]), __uint_as_float(ys[i]), sum);
      } else {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
        const float2 c = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
        sum = fmaf(a.x, c.x, fmaf(a.y, c.y, sum));
      }
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < n_rows && col == 0) {
    const int h = row % H, s = row / H % S, b = row / H / S;
    delta[(long long)(b * H + h) * S + s] = sum;
  }
}

template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* dout, void* delta, int B,
                         int S, int H, const long long* st,
                         cudaStream_t stream) {
  const int n_rows = B * S * H;
  const long long threads = (long long)n_rows * (D * sizeof(T) / 16);
  flash_bwd_delta_kernel<T, D><<<(int)((threads + 255) / 256), 256, 0,
                                 stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), n_rows, S, H, st[0], st[1], st[2], st[3],
      st[4], st[5]);
  return cudaGetLastError();
}

// -- the backward's preprocess: Delta and the dQ accumulator cleared ---------

// One launch before flash_bwd: Delta = rowsum(dO * O) and, when given, the
// fp32 dQ accumulator and the int32 counters of its adds' order (dq_index)
// set to zero, which the earlier design left to two torch.zeros, each a
// device operation and an allocation of its own.
//
// A work item is one 64-row q tile (flash_bwd's kWsQ) of one batch over a
// group of hg heads: 64 hg rows (b, s, h), taken s-major so that the rows
// of a contiguous o lie one after the other. kLanes threads share a row, one
// 16-byte chunk of o and of dO each, summed as flash_bwd_delta_kernel sums
// them (the same order, so Delta's bits are the same, and the same from run
// to run); each thread has kPrepUnroll rows' loads in flight, and zeroes its
// share of the same rows of the accumulator with 16-byte stores while they
// land. The rows' sums are staged in shared memory as [h][s] and stored as
// hg runs of up to 64 contiguous floats of Delta's (B * H, S) layout, where
// a thread a row would scatter them S * 4 bytes apart; the item's hg
// counters are cleared with them. The stage is double-buffered by the
// item's parity, so one barrier an item suffices.
//
// A persistent grid of as many blocks as are resident at once strides over
// the items, and the launcher narrows hg (from all H heads, at most
// kPrepMaxHeads) until there are at least as many items as blocks, so
// that small shapes (ViT, one tensor or ring rank) still fill every SM
// and no ramp or tail of thousands of short blocks sets the time.
constexpr int kPrepThreads = 256;
constexpr int kPrepUnroll = 4;
constexpr int kPrepMaxHeads = 32;

// sum + the fp32 dot product of one 16-byte chunk of o and of dO
template <typename T>
__device__ __forceinline__ float chunk_dot(const uint4& x, const uint4& y,
                                           float sum) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      sum = fmaf(__uint_as_float(xs[i]), __uint_as_float(ys[i]), sum);
    } else {
      const float2 a =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
      const float2 c =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
      sum = fmaf(a.x, c.x, fmaf(a.y, c.y, sum));
    }
  }
  return sum;
}

template <typename T, int D>
__global__ void __launch_bounds__(kPrepThreads)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, float* __restrict__ dq_acc,
                      int* __restrict__ dq_count, int B, int S, int H, int hg,
                      long long o_sb, long long o_ss, long long o_sh,
                      long long do_sb, long long do_ss, long long do_sh,
                      long long a_sb, long long a_ss, long long a_sh) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = D / kVec;                // 8, 16 or 32
  constexpr int kRows = kPrepThreads / kLanes;    // rows a step
  constexpr int kZeros = D / 4 / kLanes;          // 16-byte stores a row
  __shared__ float stage[2][kBlockQ * kPrepMaxHeads];
  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  const int n_groups = (H + hg - 1) / hg;
  const int n_items = B * n_qt * n_groups;
  const int lane = threadIdx.x % kLanes;
  const int slot = threadIdx.x / kLanes;
  int parity = 0;
  for (int item = blockIdx.x; item < n_items;
       item += gridDim.x, parity ^= 1) {
    const int h0 = item % n_groups * hg;
    const int qt = item / n_groups % n_qt;
    const int b = item / n_groups / n_qt;
    const int hv = min(hg, H - h0);
    const int q0 = qt * kBlockQ;
    const int n_rows = min(kBlockQ, S - q0) * hv;  // row r: s = q0 + r / hv
    float* sums = stage[parity];
    for (int r0 = 0; r0 < n_rows; r0 += kRows * kPrepUnroll) {
      uint4 x[kPrepUnroll], y[kPrepUnroll];
#pragma unroll
      for (int u = 0; u < kPrepUnroll; ++u) {
        const int r = r0 + slot + kRows * u;
        x[u] = y[u] = make_uint4(0u, 0u, 0u, 0u);
        if (r < n_rows) {
          const int s = q0 + r / hv, h = h0 + r % hv;
          x[u] = __ldg(reinterpret_cast<const uint4*>(
              o + b * o_sb + s * o_ss + h * o_sh) + lane);
          y[u] = __ldg(reinterpret_cast<const uint4*>(
              dout + b * do_sb + s * do_ss + h * do_sh) + lane);
        }
      }
      if (dq_acc != nullptr) {
#pragma unroll
        for (int u = 0; u < kPrepUnroll; ++u) {
          const int r = r0 + slot + kRows * u;
          if (r < n_rows) {
            const int s = q0 + r / hv, h = h0 + r % hv;
            float4* row = reinterpret_cast<float4*>(dq_acc + b * a_sb +
                                                    s * a_ss + h * a_sh);
#pragma unroll
            for (int z = 0; z < kZeros; ++z)
              row[lane + kLanes * z] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPrepUnroll; ++u) {
        float sum = chunk_dot<T>(x[u], y[u], 0.f);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off /= 2)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const int r = r0 + slot + kRows * u;
        if (lane == 0 && r < n_rows) sums[r % hv * kBlockQ + r / hv] = sum;
      }
    }
    if (dq_count != nullptr && (int)threadIdx.x < hv)
      dq_count[(long long)(b * H + h0 + threadIdx.x) * n_qt + qt] = 0;
    __syncthreads();
    for (int idx = threadIdx.x; idx < hv * kBlockQ; idx += kPrepThreads) {
      const int i = idx % kBlockQ;
      if (q0 + i < S)
        delta[(long long)(b * H + h0 + idx / kBlockQ) * S + q0 + i] =
            sums[idx];
    }
  }
}

template <typename T, int D>
cudaError_t launch_prep(const void* o, const void* dout, void* delta,
                        void* dq_acc, void* dq_count, int B, int S, int H,
                        const long long* st, cudaStream_t stream) {
  auto kernel = flash_bwd_prep_kernel<T, D>;
  // blocks resident on an SM at once: the same for every launch
  static int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kPrepThreads, 0);
    if (err != cudaSuccess) return err;
  }
  int device = 0, n_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const long long n_qt = (S + kBlockQ - 1) / kBlockQ;
  const long long resident = (long long)per_sm * n_sm;
  int hg = H < kPrepMaxHeads ? H : kPrepMaxHeads;
  while (hg > 1 && B * n_qt * ((H + hg - 1) / hg) < resident)
    hg = (hg + 1) / 2;
  const long long n_items = B * n_qt * ((H + hg - 1) / hg);
  if (n_items == 0) return cudaSuccess;
  const long long* a = dq_acc != nullptr ? st + 6 : st;  // unused when null
  const int grid = (int)(n_items < resident ? n_items : resident);
  kernel<<<grid, kPrepThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), static_cast<float*>(dq_acc),
      static_cast<int*>(dq_count), B, S, H, hg, st[0], st[1], st[2], st[3],
      st[4], st[5], a[0], a[1], a[2]);
  return cudaGetLastError();
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

// The entry points: dtype 0 = bf16, 1 = fp32; lse and delta are fp32
// (B * H, S), contiguous. strides (in elements) of dims b, s, h of q, k, v,
// dO, then the outputs (dq; or dk, dv; or dk, dv and the dQ accumulator),
// each with a contiguous last dim. bf16 tensors read or written through
// tensor maps (flash_bwd, and flash_bwd_dkv's bf16) need a 16-byte aligned
// base and strides of multiples of 8 elements. They return a cudaError_t (0
// on success); an unsupported head_dim or dtype, or a tensor map that cannot
// be built, returns cudaErrorInvalidValue.
//
// flash_bwd_dq: dQ alone on the mma.sync kernel, bf16 and fp32 (fp32 is half
// of the fp32 backward; bf16 serves flash_attention_bwd_dq and the smoke's
// yardstick of the earlier pair).
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

// flash_bwd_dkv: dK and dV alone; bf16 on the warp-specialised kernel
// without dQ, fp32 on the mma.sync kernel.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int dtype,
                             int B, int S, int H, int KVH, int D,
                             const long long* strides, int causal,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_ws<64, false>(q, k, v, dout, lse, delta, dk, dv, nullptr,
                                nullptr, B, S, H, KVH, strides, causal, st);
  if (dtype == 0 && D == 128)
    return launch_ws<128, false>(q, k, v, dout, lse, delta, dk, dv, nullptr,
                                 nullptr, B, S, H, KVH, strides, causal, st);
  if (dtype == 1 && D == 64)
    return launch_dkv<float, 64, true>(q, k, v, dout, lse, delta, dk, dv, B,
                                       S, H, KVH, strides, causal, st);
  if (dtype == 1 && D == 128)
    return launch_dkv<float, 128, true>(q, k, v, dout, lse, delta, dk, dv, B,
                                        S, H, KVH, strides, causal, st);
  return (int)cudaErrorInvalidValue;
}

// flash_bwd: the bf16 backward in one kernel, flash_bwd_dkv's arguments,
// dq_acc, an fp32 (B, S, H, D) tensor that must hold zeros: each q tile's
// dQ is added into it (dtype 0 only), and dq_count, B * H * ceil(S / 64)
// int32 zeros that order those adds (dq_index's note), so that dQ is the
// same from run to run; the launch counts in them, so each launch needs
// fresh zeros.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, void* dq_acc, void* dq_count,
                         int dtype, int B, int S, int H, int KVH, int D,
                         const long long* strides, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_ws<64, true>(q, k, v, dout, lse, delta, dk, dv, dq_acc,
                               dq_count, B, S, H, KVH, strides, causal, st);
  if (dtype == 0 && D == 128)
    return launch_ws<128, true>(q, k, v, dout, lse, delta, dk, dv, dq_acc,
                                dq_count, B, S, H, KVH, strides, causal, st);
  return (int)cudaErrorInvalidValue;
}

// flash_bwd_dkv_mma: the mma.sync design's bf16 dK/dV, with flash_bwd_dkv's
// arguments (dtype 0 only): with flash_bwd_dq, the earlier pair that the
// chip smoke times beside flash_bwd as a yardstick. Nothing in the package
// calls it.
extern "C" int flash_bwd_dkv_mma(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int dtype, int B, int S, int H, int KVH,
                                 int D, const long long* strides, int causal,
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
  return (int)cudaErrorInvalidValue;
}

// flash_bwd_prep: what the backward needs before flash_bwd, in one launch:
// Delta = rowsum(dO * O), fp32 (B * H, S), from o and dO (B, S, H, D),
// bf16 or fp32, D 64 or 128, 16-byte aligned; and, unless null, dq_acc (an
// fp32 (B, S, H, D) tensor) and dq_count (B * H * ceil(S / 64) int32) set
// to zero, the state flash_bwd starts from. strides: o, dO, then dq_acc's
// when it is given. KVH and causal are unused (the entry points share one
// binding). What the backward runs (ops/attention.py:attention_bwd_prep;
// Delta alone for the fp32 pair and the ring's blocks' callers).
extern "C" int flash_bwd_prep(const void* o, const void* dout, void* delta,
                              void* dq_acc, void* dq_count, int dtype, int B,
                              int S, int H, int KVH, int D,
                              const long long* strides, int causal,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_prep<__nv_bfloat16, 64>(o, dout, delta, dq_acc, dq_count,
                                          B, S, H, strides, st);
  if (dtype == 0 && D == 128)
    return launch_prep<__nv_bfloat16, 128>(o, dout, delta, dq_acc, dq_count,
                                           B, S, H, strides, st);
  if (dtype == 1 && D == 64)
    return launch_prep<float, 64>(o, dout, delta, dq_acc, dq_count, B, S, H,
                                  strides, st);
  if (dtype == 1 && D == 128)
    return launch_prep<float, 128>(o, dout, delta, dq_acc, dq_count, B, S, H,
                                   strides, st);
  return (int)cudaErrorInvalidValue;
}

// flash_bwd_delta: Delta = rowsum(dO * O), fp32 (B * H, S), from o and dO
// (B, S, H, D), bf16 or fp32, D 64 or 128, strides of o then dO, 16-byte
// aligned. KVH and causal are unused (the entry points share one binding).
// The earlier design of flash_bwd_prep's Delta (a thread a 16-byte chunk,
// a block per 256 threads' rows); nothing in the package calls it: the
// chip smoke times it beside the prep as a yardstick.
extern "C" int flash_bwd_delta(const void* o, const void* dout, void* delta,
                               int dtype, int B, int S, int H, int KVH, int D,
                               const long long* strides, int causal,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_delta<__nv_bfloat16, 64>(o, dout, delta, B, S, H, strides,
                                           st);
  if (dtype == 0 && D == 128)
    return launch_delta<__nv_bfloat16, 128>(o, dout, delta, B, S, H, strides,
                                            st);
  if (dtype == 1 && D == 64)
    return launch_delta<float, 64>(o, dout, delta, B, S, H, strides, st);
  if (dtype == 1 && D == 128)
    return launch_delta<float, 128>(o, dout, delta, B, S, H, strides, st);
  return (int)cudaErrorInvalidValue;
}
