// Flash-attention forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel (launched
// by _flash_fwd_impl through pl.pallas_call). Same function: softmax(Q K^T /
// sqrt(D)) V, causal or full, with an online softmax whose running max m,
// running sum l and accumulator stay in fp32; masked scores are -1e30;
// O = acc / max(l, 1e-30) in the input dtype and lse = m + log(l) in fp32,
// laid out (B * H, S).
//
// What changed against the TPU kernel:
// - q is read as (B, S, H, D) and k, v as (B, S, KVH, D) through their
//   strides: query head h reads KV head h / (H / KVH), which is what the JAX
//   model's jnp.repeat(k, H / KVH, axis=2) produces. No transpose, no repeat.
// - Any S >= 1: the ragged last tile is masked here (keys >= S score -1e30,
//   query rows >= S are not stored), so every prefill bucket runs the kernel.
// - Blocks run in parallel in no order, so the TPU's sequential k-block grid
//   becomes a loop inside the block. Causal q tiles are issued longest first.
//
// What bounds it on this card: at the serving and training shapes (S up to
// 2048, D = 128) attention does 2 * S * D FLOPs per (q, k) pair for 4 * D
// bytes per row of q, k, v and o, so it is bound by the tensor cores (989
// TFLOP/s bf16 dense), not by HBM (3.35 TB/s): at B=8, H=16, S=2048 causal
// the bound is about 0.14 ms of tensor-core work against 0.06 ms of bytes.
//
// Two kernels live here, chosen by dtype in flash_fwd below:
//
// bf16 (head dims 64 and 128): flash_fwd_kernel, a warp-specialised design.
// A persistent grid of one block of three warpgroups per SM; each block
// walks its share of the work items, a 128-row q tile of one (batch, head)
// each, the longest first:
// - warpgroup 0 is the producer: it gives up registers (setmaxnreg.dec) and
//   one of its threads issues every load as TMA copies of whole tiles (q
//   once; then K and V, 128 keys a stage) into a ring of shared stages. Each
//   stage has "full" and "empty" mbarriers for K and for V: TMA completes
//   the full ones in bytes, the consumers arrive on "empty" as soon as they
//   are done with the tile, and the producer refills it. Loads run ahead
//   of the products by the depth of the ring (2 stages at D = 128, 3 at
//   D = 64), and across items: the next item's q and first K tile load
//   while the consumers finish the item before,
//   where the mma.sync design loads through registers between two
//   __syncthreads() and so never overlaps loads with products;
// - warpgroups 1 and 2 are consumers, 64 query rows each (setmaxnreg.inc to
//   240 registers). S = Q K^T is wgmma.m64n128k16 with both operands read
//   from the swizzled tiles through descriptors: each k-step reads the
//   warpgroup's 64 q rows and all 128 keys once, where the mma.sync design
//   has 4 warps of 16 rows re-read K from shared memory for every 8 keys and
//   runs mma.sync.m16n8k16, a fraction of wgmma's rate. The softmax runs on
//   the accumulator in registers (wgmma's accumulator is the m16n8k16 C
//   fragment, once per 8 columns). O += P V is wgmma.m64n{D}k16 with P from
//   registers (the bf16 pack of the S accumulator is the A fragment) and V
//   read MN-major through its descriptor (the transpose-B immediate), which
//   replaces the mma.sync design's 16-bit gathers of V's columns;
// - the products are issued so that the tensor cores never wait on the
//   softmax: a warpgroup issues S of tile i, then P V of tile i - 1, and
//   runs the softmax of tile i while P V runs; and the two warpgroups take
//   turns to issue (a pair of named barriers), so that one's softmax runs
//   while the other's products do;
// - TMA fills key rows past S with zeros, which score 0, not -1e30, so the
//   one tile that crosses S or the causal diagonal is masked explicitly. The
//   key tiles are walked from the last down, so that tile comes first and
//   every later tile runs without the mask.
//
// fp32 (and flash_fwd_mma's bf16): flash_fwd_mma_kernel, the mma.sync design.
// One block of 4 warps per (64-row q tile, batch * head), K and V tiles
// loaded by the threads, products on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate). fp32 inputs are split into bf16 hi + lo parts and each
// product is taken as hi*hi + hi*lo + lo*hi, which keeps about 16 mantissa
// bits: close enough to an fp32 product for the fp32 comparison, at 3x the
// mma count. P is rounded to bf16 (hi, plus lo for fp32 inputs) before P V,
// as the reference rounds its probabilities to the input dtype before P V.
// Its bf16 instantiation is kept only as flash_fwd_mma, the yardstick that
// the chip smoke times beside the new kernel; no caller of this library's
// flash_fwd reaches it.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

// -- bf16: TMA ring, warp-specialised wgmma ---------------------------------

constexpr int kTileQ = 128;           // query rows of a block, 64 a consumer
constexpr int kTileK = 128;           // keys of a ring stage
constexpr int kBoxBytes = 128 * 128;  // one TMA box: 128 rows of 64 bf16
constexpr int kWsThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kConsumerThreads = 256;

// The block's shared memory from a 1024-byte aligned base: the Q tile, the
// ring's K tiles, its V tiles, the O tile on its way out, then the mbarriers
// (Q full, Q empty; for each stage K full, V full, K empty, V empty). A tile
// is D / 64 boxes side by side in memory, box c holding columns 64c .. 64c
// + 63 of 128 rows; the O tile holds each consumer's 64 rows the same way.
template <int D>
struct Smem {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kTileBytes = D / 64 * kBoxBytes;
  static constexpr int kK = kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kO = kV + kStages * kTileBytes;  // 64 rows a consumer
  static constexpr int kBars = kO + kTileBytes;
  static constexpr int kBytes = kBars + 8 * (2 + 4 * kStages) + 1024;

  // barrier i of stage s (0 K full, 1 V full, 2 K empty, 3 V empty)
  __device__ static uint32_t bar(uint32_t base, int i, int s) {
    return base + kBars + 8 * (2 + i * kStages + s);
  }
  __device__ static uint32_t k_tile(uint32_t base, int s) {
    return base + kK + s * kTileBytes;
  }
  __device__ static uint32_t v_tile(uint32_t base, int s) {
    return base + kV + s * kTileBytes;
  }
};

// Issue S = Q K^T (64 x 128) for the warpgroup's 64 q rows: D / 16 k-steps
// of 16 columns, box ks / 4, 32 bytes a step inside its 128-byte rows.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_rows,
                                         uint32_t k_tile) {
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
    hopper::wgmma_m64n128k16_ss<0, 0>(sc, hopper::desc_kmajor(q_rows + off),
                                      hopper::desc_kmajor(k_tile + off),
                                      ks > 0);
  }
  hopper::wgmma_commit();
}

// Issue O += P V: 8 k-steps of 16 keys, P from registers (p[4j .. 4j + 3]
// is the A fragment of keys 16j .. 16j + 15), V read MN-major (16 key rows
// are 2048 bytes; the next 64 columns are the next box).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[32],
                                         uint32_t v_tile) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    const uint64_t dv = hopper::desc_mnmajor(v_tile + kk * 2048, kBoxBytes);
    if constexpr (D == 128)
      hopper::wgmma_m64n128k16_rs<1>(acc, p + 4 * kk, dv, 1);
    else
      hopper::wgmma_m64n64k16_rs<1>(acc, p + 4 * kk, dv, 1);
  }
  hopper::wgmma_commit();
}

// O *= alpha, row a's columns (acc[4j], acc[4j + 1]) and row b's.
template <int D>
__device__ __forceinline__ void rescale_o(float (&acc)[D / 2], float alpha_a,
                                          float alpha_b) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= alpha_a;
    acc[4 * j + 1] *= alpha_a;
    acc[4 * j + 2] *= alpha_b;
    acc[4 * j + 3] *= alpha_b;
  }
}

// Online softmax of one score tile in the log2 domain. sc[4n .. 4n + 3]
// hold keys 8n + 2t + {0, 1} of rows a (0, 1) and b (2, 3); on return they
// hold p = 2^(s * scale_log2 - m) in fp32, m and the thread's partial row
// sums l are updated, and alpha is the factor that rescales what O holds.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float scale_log2,
                                             float& m_a, float& m_b,
                                             float& l_a, float& l_b,
                                             float& alpha_a, float& alpha_b) {
  float mx_a = sc[0], mx_b = sc[2];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(m_a, mx_a * scale_log2);
  const float mn_b = fmaxf(m_b, mx_b * scale_log2);
  alpha_a = exp2_approx(m_a - mn_a);
  alpha_b = exp2_approx(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    sc[4 * n] = exp2_approx(fmaf(sc[4 * n], scale_log2, -mn_a));
    sc[4 * n + 1] = exp2_approx(fmaf(sc[4 * n + 1], scale_log2, -mn_a));
    sc[4 * n + 2] = exp2_approx(fmaf(sc[4 * n + 2], scale_log2, -mn_b));
    sc[4 * n + 3] = exp2_approx(fmaf(sc[4 * n + 3], scale_log2, -mn_b));
    sum_a += sc[4 * n] + sc[4 * n + 1];
    sum_b += sc[4 * n + 2] + sc[4 * n + 3];
  }
  l_a = l_a * alpha_a + sum_a;
  l_b = l_b * alpha_b + sum_b;
}

// One work item of the persistent grid: a 128-row q tile of one (batch,
// head). Items are numbered with the q tile major and, when causal, the
// last q tiles (the longest loops) first; blocks take them in the snake
// order of work_index (flash_common.cuh).
struct Work {
  int b, h, kvh, q0;
  int n_kt;  // key tiles, walked from the last down
};

__device__ __forceinline__ Work work_item(int w, int n_bh, int H, int KVH,
                                          int S, int causal) {
  const int n_qt = (S + kTileQ - 1) / kTileQ;
  const int qt = causal ? n_qt - 1 - w / n_bh : w / n_bh;
  const int bh = w % n_bh;
  Work wk;
  wk.b = bh / H;
  wk.h = bh % H;
  wk.kvh = wk.h / (H / KVH);
  wk.q0 = qt * kTileQ;
  const int k_end = causal ? min(S, wk.q0 + kTileQ) : S;
  wk.n_kt = (k_end + kTileK - 1) / kTileK;
  return wk;
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to,
                 float* __restrict__ lse, int S, int H, int KVH, int n_bh,
                 float scale_log2, int causal) {
  using L = Smem<D>;
  constexpr int kStages = L::kStages;
  constexpr int kBoxes = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_q = base + L::kBars;
  const uint32_t empty_q = full_q + 8;
  const int n_work = (S + kTileQ - 1) / kTileQ * n_bh;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    hopper::mbar_init(empty_q, kConsumerThreads);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(L::bar(base, 0, s), 1);
      hopper::mbar_init(L::bar(base, 1, s), 1);
      hopper::mbar_init(L::bar(base, 2, s), kConsumerThreads);
      hopper::mbar_init(L::bar(base, 3, s), kConsumerThreads);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // The K and V ring runs on across work items: the block's key tile number
  // kv + it (kv = tiles of its earlier items) lies in stage
  // (kv + it) % kStages, and its barriers' phase flips every lap of the ring.
  if (threadIdx.x < 128) {
    // producer: one thread issues every TMA copy, in the order the
    // consumers use the tiles: Q, K 0, then K it + 1 before V it
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int kv = 0;
      for (int round = 0;; ++round) {
        const int w = work_index(round);
        if (w >= n_work) break;
        const Work wk = work_item(w, n_bh, H, KVH, S, causal);
        // Q of the item before must be released by both consumers
        if (round > 0) hopper::mbar_wait(empty_q, (round - 1) & 1);
        hopper::mbar_arrive_expect_tx(full_q, L::kTileBytes);
        for (int c = 0; c < kBoxes; ++c)
          hopper::tma_load_4d(base + c * kBoxBytes, &tq, full_q, 64 * c, wk.h,
                              wk.q0, wk.b);
        // K (v = 0) or V (v = 1) of tile `it`, once both consumers have
        // released the stage's tile before it
        auto load = [&](int v, int it) {
          const int n = kv + it, s = n % kStages;
          if (n >= kStages)
            hopper::mbar_wait(L::bar(base, 2 + v, s), (n / kStages - 1) & 1);
          const uint32_t full = L::bar(base, v, s);
          const uint32_t dst = v ? L::v_tile(base, s) : L::k_tile(base, s);
          hopper::mbar_arrive_expect_tx(full, L::kTileBytes);
          for (int c = 0; c < kBoxes; ++c)
            hopper::tma_load_4d(dst + c * kBoxBytes, v ? &tv : &tk, full,
                                64 * c, wk.kvh, (wk.n_kt - 1 - it) * kTileK,
                                wk.b);
        };
        load(0, 0);
        for (int it = 0; it < wk.n_kt; ++it) {
          if (it + 1 < wk.n_kt) load(0, it + 1);
          load(1, it);
        }
        kv += wk.n_kt;
      }
    }
    return;
  }

  // consumers: warpgroup cw takes q rows q0 + 64 cw .. q0 + 64 cw + 63
  hopper::setmaxnreg_inc<240>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within an 8-row group of the accumulator
  const int t = lane % 4;  // thread within the quad
  const uint32_t q_rows = base + cw * 64 * 128;  // these 64 rows of box 0
  const uint32_t o_rows = base + L::kO + cw * kBoxes * 64 * 128;
  // The two warpgroups take turns to issue their products (named barriers
  // 1 and 2): while one issues, the other runs its softmax, so the tensor
  // cores see a steady stream. Warpgroup 0 takes the first turn. Barriers
  // 3 and 4 hold each warpgroup's own threads together around its O tile.
  const int my_turn = 1 + cw, their_turn = 2 - cw, my_tile = 3 + cw;
  if (cw == 1) hopper::bar_arrive<kConsumerThreads>(1);

  int kv = 0;
  for (int round = 0;; ++round) {
    const int w = work_index(round);
    if (w >= n_work) break;
    const Work wk = work_item(w, n_bh, H, KVH, S, causal);
    const int n_kt = wk.n_kt;
    const int row_a = wk.q0 + 64 * cw + 16 * warp + g;
    const int row_b = row_a + 8;

    // O accumulator: acc[4j .. 4j + 3] hold columns 8j + 2t + {0, 1} of
    // rows row_a (0, 1) and row_b (2, 3)
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_a = kMasked, m_b = kMasked;  // running max, log2 units
    float l_a = 0.f, l_b = 0.f;          // this thread's partial row sums
    float alpha_a, alpha_b;              // rescales O before the next P V
    float sc[64];                        // scores, then probabilities (fp32)
    uint32_t p[32];                      // probabilities as bf16 pairs

    // Tile 0: S alone. It is the only tile that crosses S or the causal
    // diagonal, so the only one masked.
    {
      const int s = kv % kStages;
      hopper::mbar_wait(full_q, round & 1);
      hopper::mbar_wait(L::bar(base, 0, s), (kv / kStages) & 1);
      hopper::bar_sync<kConsumerThreads>(my_turn);
      issue_qk<D>(sc, q_rows, L::k_tile(base, s));
      hopper::bar_arrive<kConsumerThreads>(their_turn);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::mbar_arrive(L::bar(base, 2, s));
      if (n_kt == 1) hopper::mbar_arrive(empty_q);
    }
    if (causal || S % kTileK != 0) {
      // a masked raw score: -1e30 once scaled into the log2 domain
      const float masked_raw = kMasked / scale_log2;
      const int k0 = (n_kt - 1) * kTileK;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + n * 8 + 2 * t + (i & 1);
          const int row = i < 2 ? row_a : row_b;
          if (col >= S || (causal && col > row)) sc[4 * n + i] = masked_raw;
        }
      }
    }
    softmax_tile(sc, scale_log2, m_a, m_b, l_a, l_b, alpha_a, alpha_b);
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

    // Tile it >= 1: issue S of tile it, then P V of tile it - 1, and run the
    // softmax of tile it while P V is on the tensor cores.
    for (int it = 1; it < n_kt; ++it) {
      const int n = kv + it, s = n % kStages, sp = (n - 1) % kStages;
      hopper::mbar_wait(L::bar(base, 0, s), (n / kStages) & 1);
      hopper::bar_sync<kConsumerThreads>(my_turn);
      issue_qk<D>(sc, q_rows, L::k_tile(base, s));
      rescale_o<D>(acc, alpha_a, alpha_b);
      hopper::mbar_wait(L::bar(base, 1, sp), ((n - 1) / kStages) & 1);
      issue_pv<D>(acc, p, L::v_tile(base, sp));
      hopper::bar_arrive<kConsumerThreads>(their_turn);
      hopper::wgmma_wait<1>();  // S is done; P V may still run
      hopper::fence_regs(sc);
      hopper::mbar_arrive(L::bar(base, 2, s));
      if (it == n_kt - 1) hopper::mbar_arrive(empty_q);
      softmax_tile(sc, scale_log2, m_a, m_b, l_a, l_b, alpha_a, alpha_b);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);  // O read after the wait
      hopper::fence_regs(p);    // P's registers kept until P V read them
      hopper::mbar_arrive(L::bar(base, 3, sp));
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    }

    // P V of the last tile. After the block's last item warpgroup 1 passes
    // no turn, so that each barrier sees as many arrivals as waits.
    {
      const int n = kv + n_kt - 1, sp = n % kStages;
      rescale_o<D>(acc, alpha_a, alpha_b);
      hopper::mbar_wait(L::bar(base, 1, sp), (n / kStages) & 1);
      hopper::bar_sync<kConsumerThreads>(my_turn);
      issue_pv<D>(acc, p, L::v_tile(base, sp));
      if (cw == 0 || work_index(round + 1) < n_work)
        hopper::bar_arrive<kConsumerThreads>(their_turn);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);  // O read after the wait
      hopper::fence_regs(p);    // P's registers kept until P V read them
      hopper::mbar_arrive(L::bar(base, 3, sp));
    }
    kv += n_kt;

    // full row sums across the quad
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float ls_a = fmaxf(l_a, 1e-30f);
    const float ls_b = fmaxf(l_b, 1e-30f);
    const float inv_a = 1.f / ls_a;
    const float inv_b = 1.f / ls_b;

    // O out through shared memory: the warpgroup writes its 64 rows into the
    // O tile in the 128-byte swizzled layout (16-byte chunk c of row r at
    // chunk c ^ (r % 8), so a warp's writes fall in distinct banks), and one
    // thread stores the tile with TMA, which skips rows >= S. The store of
    // the item before must have read the tile first.
    if (tid == 0) hopper::tma_store_wait_read<0>();
    hopper::bar_sync<128>(my_tile);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t at = o_rows + (j / 8) * 64 * 128 + (16 * warp + g) * 128 +
                          ((j % 8) ^ g) * 16 + 4 * t;
      hopper::st_shared(at, pack_bf16(acc[4 * j] * inv_a,
                                      acc[4 * j + 1] * inv_a));
      hopper::st_shared(at + 8 * 128, pack_bf16(acc[4 * j + 2] * inv_b,
                                                acc[4 * j + 3] * inv_b));
    }
    hopper::fence_proxy_async();
    hopper::bar_sync<128>(my_tile);
    if (tid == 0) {
      for (int c = 0; c < kBoxes; ++c)
        hopper::tma_store_4d(&to, o_rows + c * 64 * 128, 64 * c, wk.h,
                             wk.q0 + 64 * cw, wk.b);
      hopper::tma_store_commit();
    }
    if (t == 0) {
      float* lb = lse + (long long)(wk.b * H + wk.h) * S;
      if (row_a < S) lb[row_a] = m_a * kLn2 + logf(ls_a);
      if (row_b < S) lb[row_b] = m_b * kLn2 + logf(ls_b);
    }
  }
  // the block's shared memory must outlive its last store
  if (tid == 0) hopper::tma_store_wait<0>();
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int S, int H, int KVH,
                         const long long* st, int causal,
                         cudaStream_t stream) {
  // q, k, v and o move every call, so their tensor maps are built every
  // call; o is stored 64 rows (one consumer's) at a time
  CUtensorMap tq, tk, tv, to;
  if (!hopper::encode_bf16_rows(&tq, q, B, S, H, D, st[0], st[1], st[2],
                                kTileQ) ||
      !hopper::encode_bf16_rows(&tk, k, B, S, KVH, D, st[3], st[4], st[5],
                                kTileK) ||
      !hopper::encode_bf16_rows(&tv, v, B, S, KVH, D, st[6], st[7], st[8],
                                kTileK) ||
      !hopper::encode_bf16_rows(&to, o, B, S, H, D, st[9], st[10], st[11],
                                kTileQ / 2))
    return cudaErrorInvalidValue;
  constexpr int kSmem = Smem<D>::kBytes;
  auto kernel = flash_fwd_kernel<D>;
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
  const int n_work = (S + kTileQ - 1) / kTileQ * B * H;
  const float scale_log2 = kLog2e / sqrtf((float)D);
  kernel<<<min(n_work, n_sm), kWsThreads, kSmem, stream>>>(
      tq, tk, tv, to, static_cast<float*>(lse), S, H, KVH, B * H, scale_log2,
      causal);
  return cudaGetLastError();
}

// -- fp32, and the bf16 yardstick: the mma.sync design ------------------------

template <typename T, int D, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, int KVH,
                   const long long* st, int causal, cudaStream_t stream) {
  constexpr int kTileBytes = kBlockK * (D + 8) * 2;
  constexpr int kSmem = (SPLIT ? 6 : 3) * kTileBytes;
  auto kernel = flash_fwd_mma_kernel<T, D, SPLIT>;
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
// q, k, v, o in that order; the last dim of each is contiguous. bf16 takes
// the TMA / wgmma kernel, whose tensor maps need a 16-byte aligned q, k and
// v with strides of multiples of 8 elements; fp32 takes the mma.sync
// kernel. Returns a cudaError_t (0 on success); an unsupported head_dim or
// dtype, or a tensor map that cannot be built, returns cudaErrorInvalidValue.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int dtype, int B, int S, int H, int KVH,
                         int D, const long long* strides, int causal,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_wgmma<64>(q, k, v, o, lse, B, S, H, KVH, strides, causal,
                            st);
  if (dtype == 0 && D == 128)
    return launch_wgmma<128>(q, k, v, o, lse, B, S, H, KVH, strides, causal,
                             st);
  if (dtype == 1 && D == 64)
    return launch_mma<float, 64, true>(q, k, v, o, lse, B, S, H, KVH,
                                       strides, causal, st);
  if (dtype == 1 && D == 128)
    return launch_mma<float, 128, true>(q, k, v, o, lse, B, S, H, KVH,
                                        strides, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The mma.sync design's bf16 kernel, with flash_fwd's arguments (dtype 0 only):
// the yardstick that the chip smoke times beside flash_fwd. Nothing in the
// package calls it.
extern "C" int flash_fwd_mma(const void* q, const void* k, const void* v,
                             void* o, void* lse, int dtype, int B, int S,
                             int H, int KVH, int D, const long long* strides,
                             int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_mma<__nv_bfloat16, 64, false>(q, k, v, o, lse, B, S, H, KVH,
                                                strides, causal, st);
  if (dtype == 0 && D == 128)
    return launch_mma<__nv_bfloat16, 128, false>(q, k, v, o, lse, B, S, H,
                                                 KVH, strides, causal, st);
  return (int)cudaErrorInvalidValue;
}
