// Flash-attention forward for Hopper (sm_90a), bf16 or fp16, on the tensor
// cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_fwd) for 16-bit inputs: GQA
// attention with an online softmax, scale 1/sqrt(hd) (passed in, so that a
// head dim the wrapper zero-pads keeps its own scale), causal / bidirectional
// / sliding-window mask plus a tail mask at seq_len, fully masked key tiles
// skipped, fp32 running max / denominator / accumulator, rows with no valid
// key -> 0, output in the input dtype. fp32 inputs go to flash_fwd.cu.
//
// What bounds it on the H100: operations. At the tinyllama prefill shape
// (B=4, S=1024, H=32, KV=4, hd=64, causal) it does 17.2 GFLOP (two products
// over the valid pairs) against 38 MB of traffic: 0.0174 ms at 989 TFLOP/s
// against 0.011 ms at 3.35 TB/s. So both products run on the tensor cores
// with wgmma, fed by TMA:
//   - one block per (64-query tile, head, batch): one consumer warpgroup
//     and one producer warp, 4 blocks an SM at hd <= 64 (at the serving
//     shape, two or three consumer warpgroups sharing a block's K / V
//     tiles were no faster). The grid's slowest axis counts the query tiles
//     down, so that the blocks with the most key tiles (causal) start in
//     the first wave. The producer loads only the key tiles that some row
//     of the block reaches, so the consumers skip none;
//   - the producer warp loads Q once, and K / V tiles of 64 keys through a
//     ring of 2 stages in shared memory, with TMA: 4-D tensor maps over
//     (hd, heads, S, B), box (<= 64, 1, rows, 1), so that rows past S
//     arrive as zeros. A "full" and an "empty" mbarrier guard each stage;
//   - S = Q.K^T is one wgmma chain, both operands in shared memory (hd
//     contiguous in both: K-major, no transpose);
//   - the online softmax works on the accumulator fragment in registers. A
//     row lives in 4 threads, so its max takes two shuffles; its sum stays a
//     partial sum per thread until the end. Per score it costs one max, one
//     FFMA (scale and max folded), one ex2.approx.ftz and one add; only the
//     tiles that cross the diagonal, the window's edge or the end of the
//     sequence pay for the mask. Masked scores become -inf and their
//     probabilities are set to 0 explicitly, so that a tile masked for a
//     row adds nothing to it;
//   - O += P.V takes P from registers (the fp32 accumulator fragment is
//     already the layout wgmma wants for A; it is rounded to bf16 / fp16, as
//     the plain version rounds its weights) and V from shared memory, read
//     MN-major (hd contiguous) with the transpose bit;
//   - the epilogue divides by the row sum (by 1 where it is 0), stages the
//     tile in shared memory and writes it with coalesced 16-byte stores,
//     rows past S left out. Where the caller passes an `lse` buffer (a
//     backward will run), it also writes each row's log-sum-exp of the
//     scaled, masked scores, ln 2 * (m + log2 l), for flash_bwd_sm90.cu;
//     with a null `lse` it writes nothing more.
// Head dims 32 (64-byte swizzle), 64 (128-byte), 96 (three 32-column
// atoms with the 64-byte swizzle), 128 and 256 (two or four 128-byte
// swizzle atoms side by side) and 80 (hubert-xlarge: five 16-column atoms
// with the 32-byte swizzle, so that no column is padded or copied); P.V is
// one m64nHDk16 wgmma a step whose B operand steps over the atoms by its
// leading byte offset. Every other head dim up to 256 is zero-padded by the
// wrapper to the next of these (zero columns add exactly 0 to Q.K^T). At
// HD = 256 a consumer thread holds 128 accumulator registers and a block
// ~194 KB of shared memory, so one block runs an SM. A head dim over 256 (a
// multiple of 64 once the wrapper has padded it) takes flash_fwd_wide_kernel
// below: output columns in blocks of 256, Q.K^T recomputed by each block
// with Q and K streamed in 64-column chunks.
//
// Entry point: flash_fwd_sm90(...) with a plain C interface (loaded with
// ctypes), launching on the given stream and returning cudaGetLastError().
#include <atomic>
#include <cmath>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;              // query rows per block: one consumer warpgroup
constexpr int BK = 64;              // keys per K / V tile
constexpr int STAGES = 2;           // depth of the K / V ring
constexpr int NTHREADS = 128 + 32;  // + one producer warp
constexpr float NEG_INF = -1e30f;        // the TPU kernel's initial running max
// one bit per score register: which (query, key) pairs of a tile are valid
using ValidMask = std::conditional_t<(BK / 2 > 32), uint64_t, uint32_t>;

template <int HD>
struct Layout {
  // columns per swizzle atom: 64 where they divide HD, else 32 (HD = 32,
  // 96), else 16 (HD = 80, whose 160-byte rows no 64- or 128-byte atom
  // covers)
  static constexpr int ATOM = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int NATOM = HD / ATOM;
  static_assert(HD % ATOM == 0 && HD % 16 == 0, "head dim");
  static constexpr int ROWB = ATOM * 2;           // bytes per row of an atom
  static constexpr int GROUPB = 8 * ROWB;         // one 8-row swizzle group
  static constexpr Swizzle SWZ = swizzle_for_row_bytes(ROWB);
  static constexpr int Q_BYTES = BQ * HD * 2;     // [atom][BQ rows][ROWB]
  static constexpr int KV_BYTES = BK * HD * 2;    // one K or V tile, [atom][BK][ROWB]
  static constexpr int OP = HD + 8;               // output staging pitch, elements
  static constexpr int O_BYTES = BQ * OP * 2;
  static constexpr int SMEM = 1024 /* alignment */ + Q_BYTES + 2 * STAGES * KV_BYTES +
                              O_BYTES + (1 + 2 * STAGES) * 8 /* mbarriers */;
};

// 2^x in one MUFU op; subnormal results flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step over a tile's scores sc (raw Q.K^T, this thread's
// rows r0 and r0 + 8): updates the running max m (log2 domain) and the
// partial row sums l, returns each row's rescale factor in alpha and leaves
// p = 2^(s * scale_log2 - m) in sc. MASKED: the tile crosses the diagonal,
// the window's edge or the end of the sequence, so some pairs are invalid;
// their scores become -inf and their p is set to 0 explicitly. Tiles inside
// every row's reach skip all of that.
template <bool MASKED>
__device__ __forceinline__ void softmax_step(float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int r0, int c0, int k0,
                                             int S, int causal, int window) {
  ValidMask valid = ~ValidMask(0);  // bit j: sc[j] is a valid (query, key) pair
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    const int half = (j / 2) % 2;
    if constexpr (MASKED) {
      const int row = r0 + 8 * half, col = k0 + 8 * (j / 4) + c0 + j % 2;
      bool ok = col < S;
      if (causal) ok = ok && col <= row;
      if (window) ok = ok && col > row - window;
      if (!ok) {
        sc[j] = -INFINITY;
        valid &= ~(ValidMask(1) << j);
      }
    }
    mx[half] = fmaxf(mx[half], sc[j]);  // the scale is positive: max first
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    const int half = (j / 2) % 2;
    float p = exp2_ftz(fmaf(sc[j], scale_log2, neg_m[half]));
    if constexpr (MASKED) p = (valid >> j) & 1 ? p : 0.f;
    sc[j] = p;
    l[half] += p;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS, HD <= 64 ? 4 : HD <= 80 ? 3 : HD <= 128 ? 2 : 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                      float* __restrict__ lse, int S, int H, int KV, int causal, int window,
                      float scale_log2) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + L::Q_BYTES;
  uint8_t* sv = sk + STAGES * L::KV_BYTES;
  T* so = reinterpret_cast<T*>(sv + STAGES * L::KV_BYTES);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * L::KV_BYTES + L::O_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KV);
  // the key tiles that some row of this block reaches
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
    // producer: one thread starts every load
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int a = 0; a < L::NATOM; ++a)
        tma_load_4d(sq + a * BQ * L::ROWB, &tq, q_full, a * L::ATOM, h, q0, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::KV_BYTES);
#pragma unroll
        for (int a = 0; a < L::NATOM; ++a) {
          const int off = s * L::KV_BYTES + a * BK * L::ROWB;
          tma_load_4d(sk + off, &tk, &full[s], a * L::ATOM, kvh, t * BK, b);
          tma_load_4d(sv + off, &tv, &full[s], a * L::ATOM, kvh, t * BK, b);
        }
      }
    }
    return;
  }

  // consumers: the warpgroup owns query rows [q0, q0 + 64); this thread
  // holds rows r0 and r0 + 8, columns c0 + 8j + {0, 1} of each tile
  const int row_hi = q0 + BQ - 1;
  const int r0 = q0 + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);

  // Q and K: K-major. V: MN-major, its swizzle atoms along hd BK rows apart.
  const uint64_t q_desc = make_desc(sq, 16, L::GROUPB, L::SWZ);
  const uint64_t k_desc = make_desc(sk, 16, L::GROUPB, L::SWZ);
  const uint64_t v_desc =
      make_desc(sv, L::NATOM > 1 ? BK * L::ROWB : L::GROUPB, L::GROUPB, L::SWZ);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int s = i % STAGES, k0 = t * BK;
    mbar_wait(&full[s], (i / STAGES) & 1);
    // S = Q.K^T, fp32
    float sc[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int at = kk * 16 / L::ATOM * L::ROWB, cb = kk * 16 % L::ATOM * 2;
      Mma<BK>::ss<T, 0, 0>(sc, desc_advance(q_desc, at * BQ + cb),
                           desc_advance(k_desc, s * L::KV_BYTES + at * BK + cb), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // the online softmax, masked only where the tile crosses the
    // diagonal, the window's edge or the end of the sequence
    float alpha[2];
    if ((causal && k0 + BK - 1 > q0) || (window && k0 <= row_hi - window) ||
        k0 + BK > S)
      softmax_step<true>(sc, m, l, alpha, scale_log2, r0, c0, k0, S, causal, window);
    else
      softmax_step<false>(sc, m, l, alpha, scale_log2, r0, c0, k0, S, causal, window);
    // P in the A-operand layout: pa[kk] covers keys 16kk .. 16kk + 15
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 2; j += 2) pa[j / 8][j % 8 / 2] = pack2<T>(sc[j], sc[j + 1]);

    // O = alpha * O + P.V
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] *= alpha[(j / 2) % 2];
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Mma<HD>::template rs<T, 1>(
          acc, pa[kk], desc_advance(v_desc, s * L::KV_BYTES + kk * 16 * L::ROWB), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  // epilogue: O / l (l = 0 -> 1), staged in shared memory, then 16-byte rows
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = l[r] == 0.f ? 1.f : l[r];
  }
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < S)
        lse[(static_cast<long long>(b) * H + h) * S + row] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : -INFINITY;
    }
  }
  const int lr = r0 - q0;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(so + (lr + 8 * r) * L::OP + 8 * j + c0) =
          pack2<T>(acc[4 * j + 2 * r] / den[r], acc[4 * j + 2 * r + 1] / den[r]);
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup only
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < BQ * CHUNKS; i += 128) {
    const int rr = i / CHUNKS, c = i % CHUNKS, row = q0 + rr;
    if (row < S)
      *reinterpret_cast<uint4*>(o + ((static_cast<long long>(b) * S + row) * H + h) * HD +
                                8 * c) = *reinterpret_cast<const uint4*>(so + rr * L::OP + 8 * c);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
           int H, int KV, int causal, int window, float scale, cudaStream_t stream) {
  using L = Layout<HD>;
  const uint64_t hd = HD, e = 2, s = S, b = B, nh = H, nkv = KV;
  const uint32_t atom = L::ATOM;
  CUtensorMap tq, tk, tv;
  int err = make_tensor_map<4>(&tq, is_f16<T>, q, {hd, nh, s, b},
                               {hd * e, nh * hd * e, s * nh * hd * e}, {atom, 1, BQ, 1});
  if (!err)
    err = make_tensor_map<4>(&tk, is_f16<T>, k, {hd, nkv, s, b},
                             {hd * e, nkv * hd * e, s * nkv * hd * e}, {atom, 1, BK, 1});
  if (!err)
    err = make_tensor_map<4>(&tv, is_f16<T>, v, {hd, nkv, s, b},
                             {hd * e, nkv * hd * e, s * nkv * hd * e}, {atom, 1, BK, 1});
  if (err) return err;
  auto kern = flash_fwd_sm90_kernel<T, HD>;
  // the shared-memory limit is set once per device, not on every launch
  static std::atomic<int> smem_set_on{-1};
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess && smem_set_on.load() != dev) {
    ce = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (ce == cudaSuccess) smem_set_on.store(dev);
  }
  if (ce != cudaSuccess) return ce;
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  const float scale_log2 = static_cast<float>(1.4426950408889634 * double(scale));
  kern<<<grid, NTHREADS, L::SMEM, stream>>>(tq, tk, tv, static_cast<T*>(o), lse, S, H, KV,
                                            causal, window, scale_log2);
  return cudaGetLastError();
}

// ---- head dims over 256 -----------------------------------------------------
// wgmma's n stops at 256, so P.V cannot cover such a head dim in one
// product; and a Q tile with a K / V ring outgrows shared memory (at hd 512
// Q alone is 64 KB, a 2-stage ring of K and V tiles 4 x 64 KB). So:
//   - the output columns are cut into blocks of CW = 256 (the last one
//     ragged, a multiple of 64), one block of the grid each;
//   - every block recomputes S = Q.K^T over the whole head dim, in k-steps
//     of one 64-column atom: the producer streams (Q chunk, K chunk) pairs
//     through a ring of their own, so shared memory does not grow with hd;
//   - P.V covers only the block's columns, one m64n64k16 wgmma per
//     64-column atom of V (their accumulators are the m64n256 layout's
//     quarters, so the epilogue is the one above).
// S is computed ceil(hd / 256) times; at hd 512 that is 3 products of the
// work of 2. Shared memory: the Q / K ring (4 x 16 KB), the V ring (2 x 32
// KB) and the output staging (33 KB), ~163 KB at every hd: one block an SM.
// The wrapper pads hd to a multiple of 64 (zero columns add 0 to Q.K^T).
namespace wide {
constexpr int CW = 256;                      // output columns a block
constexpr int KC = 64;                       // head-dim columns a k-step: one atom
constexpr int ROWB = KC * 2;                 // bytes a row of an atom (128-byte swizzle)
constexpr int CHUNK = BQ * ROWB;             // a Q or K chunk (BQ = BK = 64 rows)
constexpr int QK_STAGES = 4;
constexpr int QK_SLOT = 2 * CHUNK;           // Q chunk, then K chunk
constexpr int V_STAGES = 2;
constexpr int V_ATOM = BK * ROWB;            // 64 keys x 64 columns of V
constexpr int V_SLOT = (CW / KC) * V_ATOM;
constexpr int OP = CW + 8;                   // output staging pitch, elements
constexpr int O_BYTES = BQ * OP * 2;
constexpr int SMEM = 1024 + QK_STAGES * QK_SLOT + V_STAGES * V_SLOT + O_BYTES +
                     2 * (QK_STAGES + V_STAGES) * 8;
static_assert(BQ == BK, "a Q chunk and a K chunk share one layout");
}  // namespace wide

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, T* __restrict__ o, int S,
                      int H, int KV, int HD, int causal, int window, float scale_log2) {
  using namespace wide;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sqk = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sv = sqk + QK_STAGES * QK_SLOT;
  T* so = reinterpret_cast<T*>(sv + V_STAGES * V_SLOT);
  uint64_t* qk_full = reinterpret_cast<uint64_t*>(sv + V_STAGES * V_SLOT + O_BYTES);
  uint64_t* qk_empty = qk_full + QK_STAGES;
  uint64_t* v_full = qk_empty + QK_STAGES;
  uint64_t* v_empty = v_full + V_STAGES;

  const int ncb = (HD + CW - 1) / CW;          // column blocks
  const int h = blockIdx.x / ncb, col0 = blockIdx.x % ncb * CW, b = blockIdx.y;
  const int natom = min(CW, HD - col0) / KC;   // V atoms (output columns / 64) here
  const int nk = HD / KC;                      // k-steps of Q.K^T
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KV);
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_lo / BK, t_end = (k_hi + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < QK_STAGES; ++s) {
      mbar_init(&qk_full[s], 1);
      mbar_init(&qk_empty[s], 128);
    }
    for (int s = 0; s < V_STAGES; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // producer: for each key tile, its nk (Q chunk, K chunk) pairs, then
    // its V atoms of this block's columns; each ring in the order the
    // consumers take it
    if (lane == 0) {
      for (int t = t_begin, i = 0, j = 0; t < t_end; ++t, ++j) {
        for (int c = 0; c < nk; ++c, ++i) {
          const int s = i % QK_STAGES;
          mbar_wait(&qk_empty[s], ((i / QK_STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&qk_full[s], QK_SLOT);
          tma_load_4d(sqk + s * QK_SLOT, &tq, &qk_full[s], c * KC, h, q0, b);
          tma_load_4d(sqk + s * QK_SLOT + CHUNK, &tk, &qk_full[s], c * KC, kvh, t * BK, b);
        }
        const int s = j % V_STAGES;
        mbar_wait(&v_empty[s], ((j / V_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&v_full[s], natom * V_ATOM);
        for (int a = 0; a < natom; ++a)
          tma_load_4d(sv + s * V_SLOT + a * V_ATOM, &tv, &v_full[s], col0 + a * KC, kvh,
                      t * BK, b);
      }
    }
    return;
  }

  const int row_hi = q0 + BQ - 1;
  const int r0 = q0 + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  constexpr Swizzle SWZ = swizzle_for_row_bytes(ROWB);
  // Q and K chunks K-major; V MN-major, one atom a wgmma
  const uint64_t qk_desc = make_desc(sqk, 16, 8 * ROWB, SWZ);
  const uint64_t v_desc = make_desc(sv, 8 * ROWB, 8 * ROWB, SWZ);

  // acc[a]: the m64n64 accumulator of atom a, the m64n256 layout's quarter a
  float acc[CW / KC][KC / 2];
#pragma unroll
  for (int a = 0; a < CW / KC; ++a)
#pragma unroll
    for (int e = 0; e < KC / 2; ++e) acc[a][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = t_begin, i = 0, j = 0; t < t_end; ++t, ++j) {
    const int k0 = t * BK;
    // S = Q.K^T over the whole head dim, one ring slot a k-step
    float sc[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    for (int c = 0; c < nk; ++c, ++i) {
      const int s = i % QK_STAGES;
      mbar_wait(&qk_full[s], (i / QK_STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)  // the first k-step overwrites sc
        Mma<BK>::ss<T, 0, 0>(sc, desc_advance(qk_desc, s * QK_SLOT + kk * 32),
                             desc_advance(qk_desc, s * QK_SLOT + CHUNK + kk * 32),
                             c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&qk_empty[s]);
    }

    float alpha[2];
    if ((causal && k0 + BK - 1 > q0) || (window && k0 <= row_hi - window) || k0 + BK > S)
      softmax_step<true>(sc, m, l, alpha, scale_log2, r0, c0, k0, S, causal, window);
    else
      softmax_step<false>(sc, m, l, alpha, scale_log2, r0, c0, k0, S, causal, window);
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int e = 0; e < BK / 2; e += 2) pa[e / 8][e % 8 / 2] = pack2<T>(sc[e], sc[e + 1]);

    // O = alpha * O + P.V on this block's columns, an atom a wgmma
#pragma unroll
    for (int a = 0; a < CW / KC; ++a) {
#pragma unroll
      for (int e = 0; e < KC / 2; ++e) acc[a][e] *= alpha[(e / 2) % 2];
      fence_regs(acc[a]);
    }
    const int s = j % V_STAGES;
    mbar_wait(&v_full[s], (j / V_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int a = 0; a < CW / KC; ++a)
        if (a < natom)
          Mma<KC>::rs<T, 1>(acc[a], pa[kk],
                            desc_advance(v_desc, s * V_SLOT + a * V_ATOM + kk * 16 * ROWB), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < CW / KC; ++a) fence_regs(acc[a]);
    mbar_arrive(&v_empty[s]);
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = l[r] == 0.f ? 1.f : l[r];
  }
  const int lr = r0 - q0;
#pragma unroll
  for (int e = 0; e < CW / 8; ++e)
    if (e < natom * (KC / 8))
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(so + (lr + 8 * r) * OP + 8 * e + c0) =
            pack2<T>(acc[e / 8][4 * (e % 8) + 2 * r] / den[r],
                     acc[e / 8][4 * (e % 8) + 2 * r + 1] / den[r]);
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  const int chunks = natom * (KC / 8);  // 16-byte chunks a row
  for (int e = threadIdx.x; e < BQ * chunks; e += 128) {
    const int rr = e / chunks, c = e % chunks, row = q0 + rr;
    if (row < S)
      *reinterpret_cast<uint4*>(o + ((static_cast<long long>(b) * S + row) * H + h) * HD +
                                col0 + 8 * c) =
          *reinterpret_cast<const uint4*>(so + rr * OP + 8 * c);
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int KV, int HD, int causal, int window, float scale, cudaStream_t stream) {
  using namespace wide;
  if (HD % KC) return cudaErrorInvalidValue;
  const uint64_t hd = HD, e = 2, s = S, b = B, nh = H, nkv = KV;
  CUtensorMap tq, tk, tv;
  int err = make_tensor_map<4>(&tq, is_f16<T>, q, {hd, nh, s, b},
                               {hd * e, nh * hd * e, s * nh * hd * e}, {KC, 1, BQ, 1});
  if (!err)
    err = make_tensor_map<4>(&tk, is_f16<T>, k, {hd, nkv, s, b},
                             {hd * e, nkv * hd * e, s * nkv * hd * e}, {KC, 1, BK, 1});
  if (!err)
    err = make_tensor_map<4>(&tv, is_f16<T>, v, {hd, nkv, s, b},
                             {hd * e, nkv * hd * e, s * nkv * hd * e}, {KC, 1, BK, 1});
  if (err) return err;
  auto kern = flash_fwd_wide_kernel<T>;
  static std::atomic<int> smem_set_on{-1};
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess && smem_set_on.load() != dev) {
    ce = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (ce == cudaSuccess) smem_set_on.store(dev);
  }
  if (ce != cudaSuccess) return ce;
  const dim3 grid(H * ((HD + CW - 1) / CW), B, (S + BQ - 1) / BQ);
  const float scale_log2 = static_cast<float>(1.4426950408889634 * double(scale));
  kern<<<grid, NTHREADS, SMEM, stream>>>(tq, tk, tv, static_cast<T*>(o), S, H, KV, HD, causal,
                                         window, scale_log2);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
             int H, int KV, int hd, int causal, int window, float scale, cudaStream_t stream) {
  if (hd > 256) {
    if (lse != nullptr) return cudaErrorInvalidValue;  // the column passes write no LSE
    return launch_wide<T>(q, k, v, o, B, S, H, KV, hd, causal, window, scale, stream);
  }
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream);
    case 96: return launch<T, 96>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,H,hd), k/v (B,S,KV,hd), o (B,S,H,hd), all contiguous, 16-byte
// aligned, of one dtype: bf16 (is_f16 = 0) or fp16 (is_f16 = 1); lse null,
// or (B,H,S) fp32 for each row's log-sum-exp (hd <= 256 only).
// hd in {32, 64, 80, 96, 128, 256} or a multiple of 64 over 256; scale
// multiplies Q.K^T (1/sqrt of the head dim before any padding).
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int S, int H, int KV, int hd, int causal, int window,
                              int is_f16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return is_f16 ? dispatch<__half>(q, k, v, o, l, B, S, H, KV, hd, causal, window, scale, st)
                : dispatch<__nv_bfloat16>(q, k, v, o, l, B, S, H, KV, hd, causal, window,
                                          scale, st);
}
