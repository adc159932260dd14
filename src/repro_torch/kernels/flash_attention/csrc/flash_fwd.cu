// Flash-attention forward for Hopper (sm_90a), fp32, exact, on the CUDA cores.
//
// The fp32 route of the port's flash attention; bf16 and fp16 inputs go to
// the tensor-core kernel in flash_fwd_sm90.cu. wgmma takes no fp32 inputs,
// and TF32 keeps ~3 decimal digits, too few for the fp32 tolerance of 2e-5,
// so fp32 stays here.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_fwd) for fp32 inputs: GQA
// attention with an online softmax, scale 1/sqrt(hd), causal / bidirectional
// / sliding-window mask plus a tail mask at seq_len, fully masked key tiles
// skipped, fp32 running max / denominator / accumulator, rows with no valid
// key -> 0.
//
// What bounds it on the H100: the work is 2*B*H*hd*(valid q,k pairs) * 2
// FLOPs against ~B*S*(2H+2KV)*hd elements of traffic, so at the prefill
// shapes (S = 1024, hd = 64) it is bound by operations, not bytes. Both
// products run in fp32 FMAs on the CUDA cores (67 TFLOP/s peak).
//
// Design: one block of BQ = 64 query rows per (64-row q tile, head,
// batch); each row is owned by one thread, or at HD = 256 by two (SPLIT).
// The q tile is staged once in shared memory (rows padded to HD+1 floats so
// that thread t reading row t hits distinct banks); each K/V tile of BK keys
// is staged and read by all threads at the same address (a broadcast). A
// thread keeps its BK scores and its accumulator (HD / SPLIT columns) in
// registers: at HD = 128 that is 160 floats, which is why q lives in shared
// memory and BK drops to 32. At HD = 256 one thread's 256 + 32 floats would
// spill, so the two threads of a pair take the even and the odd columns
// (adjacent words: no bank conflict between them), sum their halves of each
// score with one shuffle (both get the same bits: the sum is commutative),
// run the same softmax and keep 128 accumulator columns each. The
// probabilities go through shared memory (one padded row per thread) on
// their way to the P.V product, so that its key loop need not be unrolled.
// Key tiles outside the causal / window reach of the whole q tile are
// skipped, the same reachability rule as the TPU kernel. Head dims other
// than 32, 64, 80, 96, 128 and 256 are zero-padded by the wrapper to the
// next of these; the scale is passed in (1/sqrt of the unpadded head dim).
// Head dims over 256 take flash_fwd_wide_kernel: output columns in blocks
// of 256, the scores recomputed by each block over 256-column chunks.
//
// Entry point: flash_fwd(...) with a plain C interface (loaded with ctypes),
// launching on the given stream and returning cudaGetLastError().
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;               // query rows per block, one per thread
constexpr float NEG_INF = -1e30f;    // the TPU kernel's mask value

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ bool key_valid(int kp, int row, int S, int causal, int window) {
  bool ok = kp < S;
  if (causal) ok = ok && kp <= row;
  if (window) ok = ok && kp > row - window;
  return ok;
}

template <int HD, int BK, int SPLIT>
__global__ void __launch_bounds__(BQ * SPLIT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int S, int H, int KV, int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int NT = BQ * SPLIT, DH = HD / SPLIT;  // threads; columns a thread owns
  constexpr int QS = HD + 1, PS = BK + 1;
  float* q_s = smem;                 // [BQ][QS]
  float* p_s = q_s + BQ * QS;        // [NT][PS] this tile's probabilities, a row a thread
  float* k_s = p_s + NT * PS;        // [BK][HD]
  float* v_s = k_s + BK * HD;        // [BK][HD]

  const int tid = threadIdx.x;
  const int r = tid / SPLIT, part = tid % SPLIT;  // this thread's row and columns
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = q0 + r;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int rr = i / HD, c = i % HD, s = q0 + rr;
    q_s[rr * QS + c] =
        s < S ? q[(((long long)b * S + s) * H + h) * HD + c] : 0.f;
  }

  // keys any row of this q tile can reach: [k_lo, k_hi)
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;

  float m = NEG_INF, l = 0.f;
  float acc[DH];                     // columns SPLIT * d + part
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();                 // the previous tile has been consumed
    for (int i = tid; i < BK * HD; i += NT) {
      const int s = k0 + i / HD;
      const long long off = (((long long)b * S + s) * KV + kvh) * HD + i % HD;
      k_s[i] = s < S ? k[off] : 0.f;
      v_s[i] = s < S ? v[off] : 0.f;
    }
    __syncthreads();

    float sc[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const int col = SPLIT * d + part;
      const float qd = q_s[r * QS + col];
#pragma unroll
      for (int j = 0; j < BK; ++j) sc[j] = fmaf(qd, k_s[j * HD + col], sc[j]);
    }
    if constexpr (SPLIT == 2) {
#pragma unroll
      for (int j = 0; j < BK; ++j) sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], 1);
    }

    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      sc[j] = key_valid(k0 + j, row, S, causal, window) ? sc[j] * scale : NEG_INF;
      m_cur = fmaxf(m_cur, sc[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = key_valid(k0 + j, row, S, causal, window) ? expf(sc[j] - m_new) : 0.f;
      p_s[tid * PS + j] = p;
      psum += p;
    }
    l = alpha * l + psum;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
    // j is a loop, not unrolled: the probabilities come back from shared
    // memory, which keeps the unrolled body at DH FMAs (and the build short)
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float p = p_s[tid * PS + j];
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, v_s[j * HD + SPLIT * d + part], acc[d]);
    }
    m = m_new;
  }

  // finalize through shared memory so that the store is coalesced
  const float denom = l == 0.f ? 1.f : l;
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) q_s[r * QS + SPLIT * d + part] = acc[d] / denom;
  __syncthreads();
  for (int i = tid; i < BQ * HD; i += NT) {
    const int rr = i / HD, c = i % HD, s = q0 + rr;
    if (s < S) o[(((long long)b * S + s) * H + h) * HD + c] = q_s[rr * QS + c];
  }
}

template <int HD, int BK, int SPLIT = 1>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int H, int KV, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int NT = BQ * SPLIT;
  const int smem =
      (BQ * (HD + 1) + NT * (BK + 1) + 2 * BK * HD) * static_cast<int>(sizeof(float));
  auto kern = flash_fwd_kernel<HD, BK, SPLIT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, causal, window, scale);
  return cudaGetLastError();
}

// Head dims over 256: the q tile, a K / V tile and 288 floats a thread no
// longer fit at once, so the output columns are cut into blocks of CW = 256
// (a grid axis; the last one ragged) and each block recomputes the scores
// over the whole head dim, Q and K staged in chunks of CW columns, two
// threads a row as at HD = 256. V is staged for the block's columns only.
// The scores cost ceil(hd / 256) times their work.
constexpr int CW = 256;

template <int BK>
__global__ void __launch_bounds__(2 * BQ)
flash_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int S, int H,
                      int KV, int HD, int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int SPLIT = 2, NT = BQ * SPLIT, DH = CW / SPLIT;
  constexpr int QS = CW + 1, PS = BK + 1;
  float* q_s = smem;                 // [BQ][QS] a Q chunk; the output tile at the end
  float* p_s = q_s + BQ * QS;        // [NT][PS]
  float* k_s = p_s + NT * PS;        // [BK][CW] a K chunk
  float* v_s = k_s + BK * CW;        // [BK][CW] the block's columns of a V tile

  const int tid = threadIdx.x;
  const int r = tid / SPLIT, part = tid % SPLIT;
  const int ncb = (HD + CW - 1) / CW;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y / ncb, col0 = blockIdx.y % ncb * CW;
  const int wc = min(CW, HD - col0);  // this block's output columns
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = q0 + r;
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;

  float m = NEG_INF, l = 0.f;
  float acc[DH];                     // columns col0 + SPLIT * d + part
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    float sc[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) sc[j] = 0.f;
    for (int c0 = 0; c0 < HD; c0 += CW) {
      const int cw = min(CW, HD - c0);
      __syncthreads();               // the last chunk (and the last tile) is consumed
      // 16-byte loads, several in flight (one block an SM hides no latency);
      // the loops step over whole CW-wide rows, so that / and % are shifts,
      // and columns past the chunk's cw are not read
#pragma unroll 4
      for (int i = tid; i < BQ * CW / 4; i += NT) {
        const int rr = i / (CW / 4), c = 4 * (i % (CW / 4)), s = q0 + rr;
        if (c < cw) {
          const float4 x4 = s < S ? ld4(q + (((long long)b * S + s) * H + h) * HD + c0 + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          float* dst = q_s + rr * QS + c;  // rows of QS floats: not 16-byte aligned
          dst[0] = x4.x;
          dst[1] = x4.y;
          dst[2] = x4.z;
          dst[3] = x4.w;
        }
      }
#pragma unroll 4
      for (int i = tid; i < BK * CW / 4; i += NT) {
        const int s = k0 + i / (CW / 4), c = 4 * (i % (CW / 4));
        const float* row = k + (((long long)b * S + s) * KV + kvh) * HD;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < cw) reinterpret_cast<float4*>(k_s)[i] = s < S ? ld4(row + c0 + c) : zero;
        // the tile's V columns of this block, zero past wc
        if (c0 == 0)
          reinterpret_cast<float4*>(v_s)[i] =
              s < S && c < wc ? ld4(v + (row - k) + col0 + c) : zero;
      }
      __syncthreads();
      // the chunk's cw columns only (a multiple of 64: whole pairs of threads)
#pragma unroll 4
      for (int d = 0; d < cw / SPLIT; ++d) {
        const int col = SPLIT * d + part;
        const float qd = q_s[r * QS + col];
#pragma unroll
        for (int j = 0; j < BK; ++j) sc[j] = fmaf(qd, k_s[j * CW + col], sc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], 1);

    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      sc[j] = key_valid(k0 + j, row, S, causal, window) ? sc[j] * scale : NEG_INF;
      m_cur = fmaxf(m_cur, sc[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = key_valid(k0 + j, row, S, causal, window) ? expf(sc[j] - m_new) : 0.f;
      p_s[tid * PS + j] = p;
      psum += p;
    }
    l = alpha * l + psum;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float p = p_s[tid * PS + j];
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, v_s[j * CW + SPLIT * d + part], acc[d]);
    }
    m = m_new;
  }

  const float denom = l == 0.f ? 1.f : l;
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) q_s[r * QS + SPLIT * d + part] = acc[d] / denom;
  __syncthreads();
  for (int i = tid; i < BQ * wc; i += NT) {
    const int rr = i / wc, c = i % wc, s = q0 + rr;
    if (s < S) o[(((long long)b * S + s) * H + h) * HD + col0 + c] = q_s[rr * QS + c];
  }
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int H, int KV, int HD, int causal, int window, float scale,
                        cudaStream_t stream) {
  constexpr int BK = 32, NT = 2 * BQ;
  constexpr int smem =
      (BQ * (CW + 1) + NT * (BK + 1) + 2 * BK * CW) * static_cast<int>(sizeof(float));
  auto kern = flash_fwd_wide_kernel<BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H * ((HD + CW - 1) / CW), B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, HD, causal, window,
      scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B,
                     int S, int H, int KV, int hd, int causal, int window, float scale,
                     cudaStream_t stream) {
  if (hd > 256) return launch_wide(q, k, v, o, B, S, H, KV, hd, causal, window, scale, stream);
  switch (hd) {
    case 32: return launch<32, 64>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
    case 64: return launch<64, 64>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
    // 80 or 96 + 64 floats of accumulator and scores, up to HD = 128's 160
    case 80: return launch<80, 64>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
    case 96: return launch<96, 64>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
    case 128: return launch<128, 32>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
    // a row over two threads: 128 + 32 floats each
    case 256:
      return launch<256, 32, 2>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,H,hd), k/v (B,S,KV,hd), o (B,S,H,hd), all contiguous fp32.
// hd in {32, 64, 80, 96, 128, 256} or any head dim over 256 (the wrapper
// passes a multiple of 64); scale multiplies Q.K^T (1/sqrt of the head dim
// before any padding).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KV, int hd, int causal,
                         int window, float scale, void* stream) {
  return static_cast<int>(dispatch(q, k, v, o, B, S, H, KV, hd, causal, window, scale,
                                   static_cast<cudaStream_t>(stream)));
}
