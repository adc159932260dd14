// Flash-attention backward for Hopper (sm_90a), bf16 or fp16, on the tensor
// cores.
//
// Replaces no TPU kernel: the JAX package's custom_vjp recomputes its plain
// version (src/repro/kernels/flash_attention/ops.py, _bwd) and
// differentiates it. On the H100 that recompute builds the (S, S) scores in
// fp32 and runs a dozen elementwise and softmax passes over them and their
// gradients; at smollm-360m's training shape (B 8, S 2048, 15 heads on 5,
// hd 64) that is ~20 ms a layer, nearly all of it memory traffic. This is
// the backward of flash_fwd_sm90.cu in the form of FlashAttention-2/3's
// (Dao 2023; Shah et al. 2024): nothing of size (S, S) leaves the chip.
//
// What bounds it: operations. Five products over the valid (q, k) pairs,
// 2 * hd FLOPs each: 1.6e11 FLOP a layer at smollm's shape, 0.163 ms at
// 989 TFLOP/s, against ~0.12 ms for q, k, v, o, dO read and dq, dk, dv
// written at 3.35 TB/s. So every product runs on wgmma with fp32
// accumulators, its tiles brought by TMA, and P and dS live in registers
// only. Two kernels, launched in this order on one stream:
//   - flash_bwd_dq_sm90_kernel: one block per (64-query tile, head, batch),
//     shaped like the forward. Its prologue computes D = rowsum(dO * O) of
//     its rows in fp32 and writes each row's (LSE * log2(e), D) out for the
//     second kernel. Then over the key tiles the mask reaches (K / V through
//     a 2-stage TMA ring): S = Q.K^T, P = 2^(S * scale * log2(e) - LSE *
//     log2(e)) (LSE the forward's row log-sum-exp), dP = dO.V^T,
//     dS = P * (dP - D), dQ += dS.K. dQ is written once, scaled.
//   - flash_bwd_dkdv_sm90_kernel: one block per (64-key tile, KV head,
//     batch). K and V are loaded once; the block loops over the query tiles
//     the mask reaches and, for each, the G query heads of its group: Q and
//     dO by TMA, the tile's (LSE, D) pairs by a bulk copy, through a 2-stage
//     ring. It computes the transposed products, so that the keys are the
//     accumulators' rows: S^T = K.Q^T, dP^T = V.dO^T, P^T and dS^T as
//     above, then dV += P^T.dO and dK += dS^T.Q. dK and dV are summed over
//     the G heads in registers and written once: no atomics, and the result
//     does not depend on the order blocks run in.
// In both, S and dP are committed as two wgmma groups, so that P is
// computed while dP is still on the tensor cores; the elementwise work is
// masked only on the tiles that need it (a test per pair on every tile
// cost a third of the dK / dV kernel's time). At smollm's shape the dK / dV
// kernel holds 168 registers a thread, 2 blocks an SM; the dQ kernel 128,
// 3 blocks.
// S and dP are recomputed by both kernels (7 products where one kernel
// with dQ summed by atomics would do 5): the price of writing every
// gradient exactly once, deterministically, and of keeping dQ's
// accumulator out of the key-tile kernel, whose dK and dV already hold
// hd registers a thread. P and dS are rounded to bf16 / fp16 for their
// products, as the forward rounds P; everything else stays in fp32.
//
// Tiles, swizzles and wgmma descriptors are the forward's (head dims 32,
// 64, 80, 96, 128); the wrapper zero-pads any other head dim up to 128,
// and zero columns get exactly zero gradient. Masked pairs get P = 0
// explicitly, on the tiles that cross the diagonal, the window's edge or
// the end of the sequence only. Rows past S load as zeros (TMA) and are
// not written.
//
// Entry point: flash_bwd_sm90(...) with a plain C interface (loaded with
// ctypes), launching on the given stream and returning cudaGetLastError().
#include <atomic>
#include <cmath>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;              // query rows a tile
constexpr int BK = 64;              // keys a tile
constexpr int STAGES = 2;           // depth of each kernel's TMA ring
constexpr int NTHREADS = 128 + 32;  // one consumer warpgroup + one producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Tile {
  // the forward's layout: [atom][64 rows][ROWB bytes], ATOM columns an atom
  static constexpr int ATOM = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int NATOM = HD / ATOM;
  static_assert(HD % ATOM == 0 && HD % 16 == 0, "head dim");
  static constexpr int ROWB = ATOM * 2;
  static constexpr int GROUPB = 8 * ROWB;
  static constexpr Swizzle SWZ = swizzle_for_row_bytes(ROWB);
  static constexpr int BYTES = 64 * HD * 2;  // one 64-row tile (BQ = BK = 64)
  static_assert(BYTES % 1024 == 0, "tiles stay 1024-byte aligned");
};

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, counted against `bar` as TMA's are
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a 64-row tile of (B, S, heads, HD) at (row0, head, b), one TMA box an atom
template <int HD>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int head, int row0, int b) {
  using L = Tile<HD>;
#pragma unroll
  for (int a = 0; a < L::NATOM; ++a)
    tma_load_4d(dst + a * 64 * L::ROWB, map, bar, a * L::ATOM, head, row0, b);
}

// C = A.B^T over HD, both 64-row tiles K-major in shared memory (A's rows
// the accumulator's rows): S = Q.K^T, dP = dO.V^T, S^T = K.Q^T, dP^T = V.dO^T
template <typename T, int HD>
__device__ __forceinline__ void mma_rows(float (&c)[32], uint64_t desc_a, uint64_t desc_b) {
  using L = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int at = kk * 16 / L::ATOM * L::ROWB, cb = kk * 16 % L::ATOM * 2;
    Mma<64>::ss<T, 0, 0>(c, desc_advance(desc_a, at * 64 + cb),
                         desc_advance(desc_b, at * 64 + cb), kk > 0);
  }
}

// acc += A.X over 64 rows of X: A (64 x 64) from registers, X a 64-row tile
// read MN-major (HD contiguous): dQ += dS.K, dV += P^T.dO, dK += dS^T.Q
template <typename T, int HD>
__device__ __forceinline__ void mma_cols(float (&acc)[HD / 2], const uint32_t (&a)[4][4],
                                         uint64_t desc_x) {
  using L = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Mma<HD>::template rs<T, 1>(acc, a[kk], desc_advance(desc_x, kk * 16 * L::ROWB), 1);
}

// the accumulator fragment of a 64 x 64 product in the A-operand layout,
// rounded to T: a[kk] covers columns 16kk .. 16kk + 15
template <typename T>
__device__ __forceinline__ void to_operand(const float (&c)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 32; j += 2) a[j / 8][j % 8 / 2] = pack2<T>(c[j], c[j + 1]);
}

// is (query, key) a pair the mask keeps
__device__ __forceinline__ bool valid_pair(int query, int key, int S, int causal, int window) {
  bool ok = key < S && query < S;
  if (causal) ok = ok && key <= query;
  if (window) ok = ok && key > query - window;
  return ok;
}

// P of one 64 x 64 tile in place of its scores s: p = 2^(s * scale_log2 -
// LSE), LSE in the log2 domain. MASKED: the tile crosses the diagonal, the
// window's edge or the end of the sequence, and pairs the mask drops get
// p = 0; other tiles skip the test. The dQ kernel's tiles have the queries
// as rows (r0, r0 + 8), with LSE and D per row in registers; the dK / dV
// kernel's the keys, with the queries' (LSE, D) per column in shared memory.
template <bool MASKED>
__device__ __forceinline__ void probs_by_row(float (&s)[32], const float (&lse2)[2],
                                             float scale_log2, int r0, int c0, int k0, int S,
                                             int causal, int window) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int half = (j / 2) % 2;
    s[j] = exp2_ftz(fmaf(s[j], scale_log2, -lse2[half]));
    if constexpr (MASKED)
      if (!valid_pair(r0 + 8 * half, k0 + 8 * (j / 4) + c0 + j % 2, S, causal, window))
        s[j] = 0.f;
  }
}

template <bool MASKED>
__device__ __forceinline__ void probs_by_col(float (&s)[32], const float2* rows,
                                             float scale_log2, int r0, int c0, int q0, int S,
                                             int causal, int window) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int half = (j / 2) % 2, col = 8 * (j / 4) + c0 + j % 2;
    s[j] = exp2_ftz(fmaf(s[j], scale_log2, -rows[col].x));
    if constexpr (MASKED)
      if (!valid_pair(q0 + col, r0 + 8 * half, S, causal, window)) s[j] = 0.f;
  }
}

// dS = P * (dP - D) in place of dP
__device__ __forceinline__ void ds_by_row(const float (&p)[32], float (&dp)[32],
                                          const float (&d)[2]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) dp[j] = p[j] * (dp[j] - d[(j / 2) % 2]);
}

__device__ __forceinline__ void ds_by_col(const float (&p)[32], float (&dp)[32],
                                          const float2* rows, int c0) {
#pragma unroll
  for (int j = 0; j < 32; ++j) dp[j] = p[j] * (dp[j] - rows[8 * (j / 4) + c0 + j % 2].y);
}

// this thread's rows of the accumulator (r0, r0 + 8) and its first column
// of each 8-column group (c0)
__device__ __forceinline__ int frag_row() { return 16 * (threadIdx.x / 32) + threadIdx.x % 32 / 4; }
__device__ __forceinline__ int frag_col() { return 2 * (threadIdx.x % 4); }

// ---- dQ (and D) -------------------------------------------------------------

template <typename T, int HD>
struct DqSmem {
  using L = Tile<HD>;
  static constexpr int BYTES = 1024 /* alignment */ + 2 * L::BYTES /* Q, dO */ +
                               2 * STAGES * L::BYTES /* K, V ring */ +
                               (1 + 2 * STAGES) * 8 /* mbarriers */;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS, HD <= 64 ? 3 : 2)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const T* __restrict__ o,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         float2* __restrict__ rowstat, T* __restrict__ dq, int S, int H,
                         int KV, int causal, int window, float scale, float scale_log2) {
  using L = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sdo = sq + L::BYTES;
  uint8_t* sk = sdo + L::BYTES;
  uint8_t* sv = sk + STAGES * L::BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * L::BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the longest rows first
  const int kvh = h / (H / KV);
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_lo / BK, t_end = (k_hi + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * L::BYTES);
      load_tile<HD>(sq, &tq, q_full, h, q0, b);
      load_tile<HD>(sdo, &tdo, q_full, h, q0, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::BYTES);
        load_tile<HD>(sk + s * L::BYTES, &tk, &full[s], kvh, t * BK, b);
        load_tile<HD>(sv + s * L::BYTES, &tv, &full[s], kvh, t * BK, b);
      }
    }
    return;
  }

  const int r0 = q0 + frag_row(), c0 = frag_col();
  const int row_hi = q0 + BQ - 1;

  // prologue, while the tiles land: D = rowsum(dO * O) and LSE (log2
  // domain) of this thread's rows r0 and r0 + 8; the 4 threads of a row
  // take every 4th column pair of it. Both go out as one (LSE, D) pair a
  // row, rows up to the tile's end (0 past S), for the dK / dV kernel
  float dd[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    float acc = 0.f;
    if (row < S) {
      const long long base = ((static_cast<long long>(b) * S + row) * H + h) * HD;
#pragma unroll
      for (int c = c0; c < HD; c += 8) {
        float2 x, y;
        if constexpr (is_f16<T>) {
          x = __half22float2(*reinterpret_cast<const __half2*>(dout + base + c));
          y = __half22float2(*reinterpret_cast<const __half2*>(o + base + c));
        } else {
          x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + base + c));
          y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + base + c));
        }
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dd[r] = acc;
    lse2[r] = row < S ? lse[(static_cast<long long>(b) * H + h) * S + row] * LOG2E : 0.f;
    if (lane % 4 == 0)
      rowstat[(static_cast<long long>(b) * H + h) * gridDim.z * BQ + row] =
          make_float2(lse2[r], acc);
  }

  // S and dP: Q, dO, K and V all K-major; dQ += dS.K reads K MN-major
  const uint64_t q_desc = make_desc(sq, 16, L::GROUPB, L::SWZ);
  const uint64_t do_desc = make_desc(sdo, 16, L::GROUPB, L::SWZ);
  const uint64_t k_desc = make_desc(sk, 16, L::GROUPB, L::SWZ);
  const uint64_t v_desc = make_desc(sv, 16, L::GROUPB, L::SWZ);
  const uint64_t kmn_desc =
      make_desc(sk, L::NATOM > 1 ? BK * L::ROWB : L::GROUPB, L::GROUPB, L::SWZ);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int s = i % STAGES, k0 = t * BK;
    mbar_wait(&full[s], (i / STAGES) & 1);
    // S and dP in two groups: P is computed while dP is still on the
    // tensor cores
    float sc[32], dp[32];
    wgmma_fence();
    mma_rows<T, HD>(sc, q_desc, desc_advance(k_desc, s * L::BYTES));
    wgmma_commit();
    mma_rows<T, HD>(dp, do_desc, desc_advance(v_desc, s * L::BYTES));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    if ((causal && k0 + BK - 1 > q0) || (window && k0 <= row_hi - window) || k0 + BK > S)
      probs_by_row<true>(sc, lse2, scale_log2, r0, c0, k0, S, causal, window);
    else
      probs_by_row<false>(sc, lse2, scale_log2, r0, c0, k0, S, causal, window);
    wgmma_wait<0>();
    fence_regs(dp);
    ds_by_row(sc, dp, dd);
    uint32_t da[4][4];
    to_operand<T>(dp, da);
    wgmma_fence();
    mma_cols<T, HD>(acc, da, desc_advance(kmn_desc, s * L::BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  // dq = scale * acc, rows past S left out
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    T* out = dq + ((static_cast<long long>(b) * S + row) * H + h) * HD + c0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack2<T>(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// ---- dK and dV --------------------------------------------------------------

template <typename T, int HD>
struct DkvSmem {
  using L = Tile<HD>;
  static constexpr int SLOT = 2 * L::BYTES;  // Q, then dO
  static constexpr int ROWSTAT = BQ * 8;     // a tile's (LSE, D) pairs
  static constexpr int BYTES = 1024 + 2 * L::BYTES /* K, V */ + STAGES * SLOT +
                               STAGES * ROWSTAT + (1 + 2 * STAGES) * 8;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS, HD <= 64 ? 2 : 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float2* __restrict__ rowstat, T* __restrict__ dk,
                           T* __restrict__ dv, int S, int H, int KV, int causal, int window,
                           float scale, float scale_log2) {
  using L = Tile<HD>;
  using M = DkvSmem<T, HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sv = sk + L::BYTES;
  uint8_t* ring = sv + L::BYTES;                                         // [stage][Q, dO]
  float2* srow = reinterpret_cast<float2*>(ring + STAGES * M::SLOT);  // [stage][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(srow + STAGES * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;  // causal: the first key tiles have the most rows
  const int G = H / KV;
  // the query tiles that some key of this tile reaches
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(S, k0 + BK - 1 + window) : S;
  const int t_begin = q_lo / BQ, t_end = (q_hi + BQ - 1) / BQ;
  // query tile by query tile, the G heads of each in turn: the blocks of
  // one (KV head, batch) walk the same tiles a few steps apart, so that a
  // (Q, dO) tile read from memory by one is in L2 for the others
  const int n_iter = G * max(0, t_end - t_begin);
  const int s_pad = (S + BQ - 1) / BQ * BQ;  // the dQ kernel's rows of (LSE, D)

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // producer: K and V once, then for each (head, query tile) Q and dO
    // by TMA and the tile's (LSE, D) pairs by a bulk copy
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::BYTES);
      load_tile<HD>(sk, &tk, kv_full, kvh, k0, b);
      load_tile<HD>(sv, &tv, kv_full, kvh, k0, b);
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % STAGES;
        const int h = kvh * G + i % G;
        const int q0 = (t_begin + i / G) * BQ;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], M::SLOT + M::ROWSTAT);
        load_tile<HD>(ring + s * M::SLOT, &tq, &full[s], h, q0, b);
        load_tile<HD>(ring + s * M::SLOT + L::BYTES, &tdo, &full[s], h, q0, b);
        bulk_load(srow + s * BQ, rowstat + (static_cast<long long>(b) * H + h) * s_pad + q0,
                  M::ROWSTAT, &full[s]);
      }
    }
    return;
  }

  const int r0 = k0 + frag_row(), c0 = frag_col();
  const uint64_t k_desc = make_desc(sk, 16, L::GROUPB, L::SWZ);
  const uint64_t v_desc = make_desc(sv, 16, L::GROUPB, L::SWZ);
  const uint64_t ring_desc = make_desc(ring, 16, L::GROUPB, L::SWZ);
  const uint64_t ring_mn = make_desc(ring, L::NATOM > 1 ? BQ * L::ROWB : L::GROUPB,
                                     L::GROUPB, L::SWZ);

  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % STAGES;
    const int q0 = (t_begin + i / G) * BQ;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t q_off = s * M::SLOT, do_off = q_off + L::BYTES;
    // S^T and dP^T in two groups: P is computed while dP^T is still on the
    // tensor cores
    float st[32], dpt[32];
    wgmma_fence();
    mma_rows<T, HD>(st, k_desc, desc_advance(ring_desc, q_off));
    wgmma_commit();
    mma_rows<T, HD>(dpt, v_desc, desc_advance(ring_desc, do_off));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
    const float2* rows = srow + s * BQ;
    if ((causal && k0 + BK - 1 > q0) || (window && k0 <= q0 + BQ - 1 - window) || q0 + BQ > S)
      probs_by_col<true>(st, rows, scale_log2, r0, c0, q0, S, causal, window);
    else
      probs_by_col<false>(st, rows, scale_log2, r0, c0, q0, S, causal, window);
    wgmma_wait<0>();
    fence_regs(dpt);
    ds_by_col(st, dpt, rows, c0);
    uint32_t pa[4][4], da[4][4];
    to_operand<T>(st, pa);
    to_operand<T>(dpt, da);
    wgmma_fence();
    mma_cols<T, HD>(acc_v, pa, desc_advance(ring_mn, do_off));
    mma_cols<T, HD>(acc_k, da, desc_advance(ring_mn, q_off));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    mbar_arrive(&empty[s]);
  }

  // dk = scale * acc_k, dv = acc_v, keys past S left out
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + 8 * r;
    if (key >= S) continue;
    const long long at = ((static_cast<long long>(b) * S + key) * KV + kvh) * HD + c0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
          pack2<T>(acc_k[4 * j + 2 * r] * scale, acc_k[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
          pack2<T>(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
    }
  }
}

// the dynamic shared memory limit of `kern`, set once per device
template <typename K>
cudaError_t allow_smem(K kern, int bytes, std::atomic<int>& set_on) {
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess && set_on.load() != dev) {
    ce = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (ce == cudaSuccess) set_on.store(dev);
  }
  return ce;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* rowstat, int B, int S, int H,
           int KV, int causal, int window, float scale, cudaStream_t stream) {
  using L = Tile<HD>;
  const uint64_t hd = HD, e = 2, s = S, b = B, nh = H, nkv = KV;
  const uint32_t atom = L::ATOM;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_tensor_map<4>(&tq, is_f16<T>, q, {hd, nh, s, b},
                               {hd * e, nh * hd * e, s * nh * hd * e}, {atom, 1, BQ, 1});
  if (!err)
    err = make_tensor_map<4>(&tdo, is_f16<T>, dout, {hd, nh, s, b},
                             {hd * e, nh * hd * e, s * nh * hd * e}, {atom, 1, BQ, 1});
  if (!err)
    err = make_tensor_map<4>(&tk, is_f16<T>, k, {hd, nkv, s, b},
                             {hd * e, nkv * hd * e, s * nkv * hd * e}, {atom, 1, BK, 1});
  if (!err)
    err = make_tensor_map<4>(&tv, is_f16<T>, v, {hd, nkv, s, b},
                             {hd * e, nkv * hd * e, s * nkv * hd * e}, {atom, 1, BK, 1});
  if (err) return err;

  auto dq_kern = flash_bwd_dq_sm90_kernel<T, HD>;
  auto dkv_kern = flash_bwd_dkdv_sm90_kernel<T, HD>;
  static std::atomic<int> dq_set{-1}, dkv_set{-1};
  cudaError_t ce = allow_smem(dq_kern, DqSmem<T, HD>::BYTES, dq_set);
  if (ce == cudaSuccess) ce = allow_smem(dkv_kern, DkvSmem<T, HD>::BYTES, dkv_set);
  if (ce != cudaSuccess) return ce;

  const float scale_log2 = static_cast<float>(1.4426950408889634 * double(scale));
  // dQ first: it writes (LSE, D), which the dK / dV kernel reads
  dq_kern<<<dim3(H, B, (S + BQ - 1) / BQ), NTHREADS, DqSmem<T, HD>::BYTES, stream>>>(
      tq, tk, tv, tdo, static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<float2*>(rowstat), static_cast<T*>(dq), S,
      H, KV, causal, window, scale, scale_log2);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return ce;
  dkv_kern<<<dim3(KV, B, (S + BK - 1) / BK), NTHREADS, DkvSmem<T, HD>::BYTES, stream>>>(
      tq, tk, tv, tdo, static_cast<const float2*>(rowstat), static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, KV, causal, window, scale, scale_log2);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* lse,
             const void* dout, void* dq, void* dk, void* dv, void* rowstat, int B, int S, int H,
             int KV, int hd, int causal, int window, float scale, cudaStream_t st) {
  switch (hd) {
#define FLASH_BWD_CASE(W)                                                                  \
  case W:                                                                                  \
    return launch<T, W>(q, k, v, o, lse, dout, dq, dk, dv, rowstat, B, S, H, KV, causal,   \
                        window, scale, st);
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(80)
    FLASH_BWD_CASE(96)
    FLASH_BWD_CASE(128)
#undef FLASH_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (B,S,H,hd); k, v, dk, dv (B,S,KV,hd); all contiguous,
// 16-byte aligned, of one dtype: bf16 (is_f16 = 0) or fp16 (is_f16 = 1).
// lse (B,H,S) fp32: the forward's row log-sum-exp of the scaled, masked
// scores; rowstat (B,H,S_pad,2) fp32 scratch, S_pad = S rounded up to a
// multiple of 64, 16-byte aligned: the dQ kernel writes each row's (LSE *
// log2(e), rowsum(dout * o)) there, 0 past S, for the dK / dV kernel.
// hd in {32, 64, 80, 96, 128}; scale multiplies Q.K^T (1/sqrt of the head
// dim before any padding), as in the forward.
extern "C" int flash_bwd_sm90(const void* q, const void* k, const void* v, const void* o,
                              const void* lse, const void* dout, void* dq, void* dk, void* dv,
                              void* rowstat, int B, int S, int H, int KV, int hd, int causal,
                              int window, int is_f16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f16 ? dispatch<__half>(q, k, v, o, lse, dout, dq, dk, dv, rowstat, B, S, H, KV,
                                   hd, causal, window, scale, st)
                : dispatch<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, rowstat, B, S,
                                          H, KV, hd, causal, window, scale, st);
}
