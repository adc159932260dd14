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
// Design: one block of BQ = 64 threads per (64-row q tile, head, batch);
// each thread owns one query row. The q tile is staged once in shared memory
// (rows padded to HD+1 floats so that thread t reading row t hits distinct
// banks); each K/V tile of BK keys is staged and read by all threads at the
// same address (a broadcast). A thread keeps its BK scores and its HD-wide
// accumulator in registers: at HD = 128 that is 160 floats, which is why q
// lives in shared memory and BK drops to 32. The probabilities go through
// shared memory (one padded row per thread) on their way to the P.V product,
// so that its key loop need not be unrolled. Key tiles outside the causal /
// window reach of the whole q tile are skipped, the same reachability rule
// as the TPU kernel.
//
// Entry point: flash_fwd(...) with a plain C interface (loaded with ctypes),
// launching on the given stream and returning cudaGetLastError().
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;               // query rows per block, one per thread
constexpr float NEG_INF = -1e30f;    // the TPU kernel's mask value

__device__ __forceinline__ bool key_valid(int kp, int row, int S, int causal, int window) {
  bool ok = kp < S;
  if (causal) ok = ok && kp <= row;
  if (window) ok = ok && kp > row - window;
  return ok;
}

template <int HD, int BK>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int S, int H, int KV, int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = HD + 1, PS = BK + 1;
  float* q_s = smem;                 // [BQ][QS]
  float* p_s = q_s + BQ * QS;        // [BQ][PS] this tile's probabilities
  float* k_s = p_s + BQ * PS;        // [BK][HD]
  float* v_s = k_s + BK * HD;        // [BK][HD]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = q0 + tid;

  for (int i = tid; i < BQ * HD; i += BQ) {
    const int r = i / HD, c = i % HD, s = q0 + r;
    q_s[r * QS + c] =
        s < S ? q[(((long long)b * S + s) * H + h) * HD + c] : 0.f;
  }

  // keys any row of this q tile can reach: [k_lo, k_hi)
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;

  float m = NEG_INF, l = 0.f;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();                 // the previous tile has been consumed
    for (int i = tid; i < BK * HD; i += BQ) {
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
    for (int d = 0; d < HD; ++d) {
      const float qd = q_s[tid * QS + d];
#pragma unroll
      for (int j = 0; j < BK; ++j) sc[j] = fmaf(qd, k_s[j * HD + d], sc[j]);
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
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
    // j is a loop, not unrolled: the probabilities come back from shared
    // memory, which keeps the unrolled body at HD FMAs (and the build short)
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float p = p_s[tid * PS + j];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, v_s[j * HD + d], acc[d]);
    }
    m = m_new;
  }

  // finalize through shared memory so that the store is coalesced
  const float denom = l == 0.f ? 1.f : l;
  __syncthreads();
#pragma unroll
  for (int d = 0; d < HD; ++d) q_s[tid * QS + d] = acc[d] / denom;
  __syncthreads();
  for (int i = tid; i < BQ * HD; i += BQ) {
    const int r = i / HD, c = i % HD, s = q0 + r;
    if (s < S) o[(((long long)b * S + s) * H + h) * HD + c] = q_s[r * QS + c];
  }
}

template <int HD, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int H, int KV, int causal, int window, cudaStream_t stream) {
  const int smem =
      (BQ * (HD + 1) + BQ * (BK + 1) + 2 * BK * HD) * static_cast<int>(sizeof(float));
  auto kern = flash_fwd_kernel<HD, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, BQ, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, causal, window,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B,
                     int S, int H, int KV, int hd, int causal, int window,
                     cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, 64>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 64: return launch<64, 64>(q, k, v, o, B, S, H, KV, causal, window, stream);
    // 80 + 64 floats of accumulator and scores, under HD = 128's 160
    case 80: return launch<80, 64>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 128: return launch<128, 32>(q, k, v, o, B, S, H, KV, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,H,hd), k/v (B,S,KV,hd), o (B,S,H,hd), all contiguous fp32.
// hd in {32, 64, 80, 128}.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KV, int hd, int causal,
                         int window, void* stream) {
  return static_cast<int>(dispatch(q, k, v, o, B, S, H, KV, hd, causal, window,
                                   static_cast<cudaStream_t>(stream)));
}
