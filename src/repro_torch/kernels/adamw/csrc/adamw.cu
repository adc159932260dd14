// AdamW over a whole tree of leaves, for Hopper (sm_90a): two multi-tensor
// passes in place of a loop of small kernels a leaf.
//
// Replaces no Pallas kernel: the JAX package's AdamW (src/repro/optim/adamw.py)
// is plain jnp that XLA fuses. The port's plain version, the loop
// optim/adamw.py adamw_update_plain, issues ~20 kernels a bf16 leaf for the
// update and ~4 for the global norm: 6,791 aten ops for smollm-360m's 290
// leaves, ~214 ms of host time a step, more than the device needs for the
// rest of the step. These kernels make that 3 launches.
//
//   adamw_sumsq_kernel        every gradient's sum of squares, fp32, one
//                             partial a chunk of NORM_CHUNK elements;
//   adamw_norm_finish_kernel  the partials summed in a fixed order, sqrt;
//   adamw_update_kernel       one pass a element, fp32, in the plain loop's
//                             order of operations:
//     g    = g * scale                      (scale absent: clipping off)
//     m    = m * b1 + (1 - b1) * g
//     v    = v * b2 + (1 - b2) * (g * g)
//     step = (m / b1c) / (sqrt(v / b2c) + eps) + wd * p
//     p    = p - lr * step                  rounded once to p's dtype
//
// Every operation is one correctly rounded fp32 intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts into an FMA,
// so p, m and v equal the plain loop's bit for bit: torch runs each of those
// operations as its own kernel, one rounding each, with its Python scalars
// rounded to fp32 (b1, 1 - b1, b2, 1 - b2, eps, wd come in as such floats).
// scale, lr, b1c and b2c are 0-d fp32 device tensors that torch computes
// before the launch; the kernel reads them through their pointers, so the
// host never waits for the device. The norm sums in another order than
// torch's per-leaf sums (a few fp32 ulps apart), with no atomics: the same
// tree gives the same norm bit for bit, run after run.
//
// What bounds it on the H100: bytes. The update reads p, g, m, v and writes
// p, m, v once; the norm reads g once more: 2+2+4+4 + 2+4+4 + 2 = 24 bytes a
// bf16 parameter, 8.7 GB for smollm-360m's 361.8 M, 2.59 ms at 3.35 TB/s.
//
// Design. The leaf table (pointers, sizes, dtype tags) goes by value in the
// kernel parameters (__grid_constant__; up to 32,764 bytes on sm_90 with
// CUDA 12.1+), MAX_LEAVES leaves a launch; a larger tree takes more
// launches. Nothing is copied to the device, so there is no buffer for a
// later call to overwrite while a launch is in flight. Each leaf is cut into
// chunks, one block a chunk; a block finds its leaf by a binary search over
// the chunks' prefix sum. Where p, g, m and v are all 16-byte aligned a
// thread moves 8 elements at a time (16 bytes of a bf16/fp16 tensor, 32 of
// an fp32 one) and the last partial group goes element by element; a leaf
// that is not aligned goes element by element throughout. p and g may each
// be bf16, fp16 or fp32; m and v are fp32.
//
// Entry points: adamw_norm(...) and adamw_update(...), plain C (loaded with
// ctypes), launching on the given stream and returning a CUDA error or 0.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                  // elements a thread moves at a time
constexpr long long CHUNK = 8192;       // elements a block of the update
constexpr long long NORM_CHUNK = 32768; // elements a block of the norm
constexpr int MAX_LEAVES = 512;         // leaves a launch
constexpr int FINISH_THREADS = 1024;
constexpr int ROW = 7;                  // a table row: p, g, m, v, numel, p dtype, g dtype

enum Dtype : int { F32 = 0, BF16 = 1, F16 = 2 };

struct Leaves {
  int n;
  int chunk0[MAX_LEAVES + 1];  // first chunk of each leaf; chunk0[n] = the launch's chunks
  long long numel[MAX_LEAVES];
  void* p[MAX_LEAVES];
  const void* g[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  unsigned char pdt[MAX_LEAVES];
  unsigned char gdt[MAX_LEAVES];
};

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

struct Scalars {
  float scale, lr, b1c, b2c;
  bool has_scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ void load8(const float* ptr, float* out) {
  const float4 a = reinterpret_cast<const float4*>(ptr)[0];
  const float4 b = reinterpret_cast<const float4*>(ptr)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* ptr, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(ptr);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x; out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* ptr, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(ptr);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x; out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* ptr, const float* in) {
  reinterpret_cast<float4*>(ptr)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(ptr)[1] = make_float4(in[4], in[5], in[6], in[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* ptr, const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(ptr) = raw;
}
__device__ __forceinline__ void store8(__half* ptr, const float* in) {
  uint4 raw;
  __half2* h = reinterpret_cast<__half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(ptr) = raw;
}

// the leaf whose chunks hold chunk ``c``: the last l with chunk0[l] <= c
__device__ __forceinline__ int find_leaf(const Leaves& t, int c) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk0[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// one element of the update; returns the new p in fp32, m and v in place
__device__ __forceinline__ float adamw_one(float p, float g, float& m, float& v,
                                           const Scalars& s, const Consts& c) {
  if (s.has_scale) g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)), c.eps);
  const float step = __fadd_rn(__fdiv_rn(__fdiv_rn(m, s.b1c), denom), __fmul_rn(c.wd, p));
  return __fsub_rn(p, __fmul_rn(s.lr, step));
}

template <typename P, typename G>
__device__ void update_chunk(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
                             float* __restrict__ v, long long lo, long long hi, bool vec,
                             const Scalars& s, const Consts& c) {
  if (vec) {
    for (long long i = lo + static_cast<long long>(threadIdx.x) * VEC; i < hi;
         i += static_cast<long long>(THREADS) * VEC) {
      if (i + VEC <= hi) {
        float pf[VEC], gf[VEC], mf[VEC], vf[VEC];
        load8(p + i, pf); load8(g + i, gf); load8(m + i, mf); load8(v + i, vf);
#pragma unroll
        for (int k = 0; k < VEC; ++k) pf[k] = adamw_one(pf[k], gf[k], mf[k], vf[k], s, c);
        store8(p + i, pf); store8(m + i, mf); store8(v + i, vf);
      } else {
        for (long long j = i; j < hi; ++j) {
          float mj = m[j], vj = v[j];
          p[j] = from_f<P>(adamw_one(to_f(p[j]), to_f(g[j]), mj, vj, s, c));
          m[j] = mj; v[j] = vj;
        }
      }
    }
  } else {
    for (long long j = lo + threadIdx.x; j < hi; j += THREADS) {
      float mj = m[j], vj = v[j];
      p[j] = from_f<P>(adamw_one(to_f(p[j]), to_f(g[j]), mj, vj, s, c));
      m[j] = mj; v[j] = vj;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
adamw_update_kernel(const __grid_constant__ Leaves t, const float* scale, const float* lr,
                    const float* b1c, const float* b2c, const Consts c) {
  const int chunk = blockIdx.x;
  const int l = find_leaf(t, chunk);
  const long long lo = static_cast<long long>(chunk - t.chunk0[l]) * CHUNK;
  const long long hi = min(lo + CHUNK, t.numel[l]);
  const Scalars s{scale ? *scale : 1.0f, *lr, *b1c, *b2c, scale != nullptr};
  void* p = t.p[l];
  const void* g = t.g[l];
  float* m = t.m[l];
  float* v = t.v[l];
  const bool vec = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
#define ADAMW_CASE(PD, PT, GD, GT)                                                   \
  case PD * 3 + GD:                                                                  \
    update_chunk(static_cast<PT*>(p), static_cast<const GT*>(g), m, v, lo, hi, vec, s, c); \
    break;
  switch (t.pdt[l] * 3 + t.gdt[l]) {
    ADAMW_CASE(F32, float, F32, float)
    ADAMW_CASE(F32, float, BF16, __nv_bfloat16)
    ADAMW_CASE(F32, float, F16, __half)
    ADAMW_CASE(BF16, __nv_bfloat16, F32, float)
    ADAMW_CASE(BF16, __nv_bfloat16, BF16, __nv_bfloat16)
    ADAMW_CASE(BF16, __nv_bfloat16, F16, __half)
    ADAMW_CASE(F16, __half, F32, float)
    ADAMW_CASE(F16, __half, BF16, __nv_bfloat16)
    ADAMW_CASE(F16, __half, F16, __half)
    default: break;
  }
#undef ADAMW_CASE
}

// this thread's share of a chunk's sum of squares (each square rounded to
// fp32, as torch's ``square`` does)
template <typename G>
__device__ float sumsq_chunk(const G* __restrict__ g, long long lo, long long hi, bool vec) {
  float acc = 0.0f;
  if (vec) {
    for (long long i = lo + static_cast<long long>(threadIdx.x) * VEC; i < hi;
         i += static_cast<long long>(THREADS) * VEC) {
      if (i + VEC <= hi) {
        float x[VEC];
        load8(g + i, x);
#pragma unroll
        for (int k = 0; k < VEC; ++k) x[k] = __fmul_rn(x[k], x[k]);
        acc += ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
      } else {
        for (long long j = i; j < hi; ++j) acc += __fmul_rn(to_f(g[j]), to_f(g[j]));
      }
    }
  } else {
    for (long long j = lo + threadIdx.x; j < hi; j += THREADS)
      acc += __fmul_rn(to_f(g[j]), to_f(g[j]));
  }
  return acc;
}

// the block's sum of ``x`` in a fixed order (warp shuffles, then the warps'
// sums in order); the result is valid in thread 0
template <int NT>
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warps[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) total += warps[w];
  return total;
}

__global__ void __launch_bounds__(THREADS)
adamw_sumsq_kernel(const __grid_constant__ Leaves t, float* partials) {
  const int chunk = blockIdx.x;
  const int l = find_leaf(t, chunk);
  const long long lo = static_cast<long long>(chunk - t.chunk0[l]) * NORM_CHUNK;
  const long long hi = min(lo + NORM_CHUNK, t.numel[l]);
  const void* g = t.g[l];
  const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  float acc = 0.0f;
  switch (t.gdt[l]) {
    case F32: acc = sumsq_chunk(static_cast<const float*>(g), lo, hi, vec); break;
    case BF16: acc = sumsq_chunk(static_cast<const __nv_bfloat16*>(g), lo, hi, vec); break;
    case F16: acc = sumsq_chunk(static_cast<const __half*>(g), lo, hi, vec); break;
    default: break;
  }
  const float total = block_sum<THREADS>(acc);
  if (threadIdx.x == 0) partials[chunk] = total;
}

__global__ void __launch_bounds__(FINISH_THREADS)
adamw_norm_finish_kernel(const float* __restrict__ partials, int n, float* out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += FINISH_THREADS) acc += partials[i];
  const float total = block_sum<FINISH_THREADS>(acc);
  if (threadIdx.x == 0) *out = __fsqrt_rn(total);
}

// the table's leaves [first, first + count) into ``t``, cut into chunks of
// ``chunk`` elements; returns the number of chunks
int fill(Leaves& t, const long long* rows, int first, int count, long long chunk) {
  t.n = count;
  long long c = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = rows + static_cast<long long>(first + i) * ROW;
    t.p[i] = reinterpret_cast<void*>(r[0]);
    t.g[i] = reinterpret_cast<const void*>(r[1]);
    t.m[i] = reinterpret_cast<float*>(r[2]);
    t.v[i] = reinterpret_cast<float*>(r[3]);
    t.numel[i] = r[4];
    t.pdt[i] = static_cast<unsigned char>(r[5]);
    t.gdt[i] = static_cast<unsigned char>(r[6]);
    t.chunk0[i] = static_cast<int>(c);
    c += (r[4] + chunk - 1) / chunk;
    if (c > 0x7fffffffLL) return -1;
  }
  t.chunk0[count] = static_cast<int>(c);
  return static_cast<int>(c);
}

bool valid_rows(const long long* rows, int n) {
  for (int i = 0; i < n; ++i) {
    const long long* r = rows + static_cast<long long>(i) * ROW;
    if (r[4] < 0 || r[5] < F32 || r[5] > F16 || r[6] < F32 || r[6] > F16) return false;
  }
  return true;
}

}  // namespace

// The norm of every gradient of ``table`` (``n`` rows of ROW int64: p, g, m,
// v, numel, p's and g's dtype tags; only g, numel and g's tag are read) into
// the 0-d fp32 ``out``; ``partials`` holds ``capacity`` floats, at least one
// a NORM_CHUNK of each leaf.
extern "C" int adamw_norm(const void* table, int n, void* partials, int capacity, void* out,
                          void* stream) {
  const long long* rows = static_cast<const long long*>(table);
  if (n < 0 || !valid_rows(rows, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  Leaves t;
  int done = 0;
  for (int first = 0; first < n; first += MAX_LEAVES) {
    const int count = n - first < MAX_LEAVES ? n - first : MAX_LEAVES;
    const int c = fill(t, rows, first, count, NORM_CHUNK);
    if (c < 0 || static_cast<long long>(done) + c > capacity)
      return static_cast<int>(cudaErrorInvalidValue);
    if (c > 0) {
      adamw_sumsq_kernel<<<c, THREADS, 0, s>>>(t, part + done);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    done += c;
  }
  adamw_norm_finish_kernel<<<1, FINISH_THREADS, 0, s>>>(part, done, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One AdamW step over every leaf of ``table`` (rows as adamw_norm's), p, m
// and v in place. ``scale`` (or null: no clipping), ``lr``, ``b1c`` and
// ``b2c`` point at fp32 scalars on the device.
extern "C" int adamw_update(const void* table, int n, const void* scale, const void* lr,
                            const void* b1c, const void* b2c, float b1, float omb1, float b2,
                            float omb2, float eps, float wd, void* stream) {
  const long long* rows = static_cast<const long long*>(table);
  if (n < 0 || !valid_rows(rows, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Consts c{b1, omb1, b2, omb2, eps, wd};
  Leaves t;
  for (int first = 0; first < n; first += MAX_LEAVES) {
    const int count = n - first < MAX_LEAVES ? n - first : MAX_LEAVES;
    const int chunks = fill(t, rows, first, count, CHUNK);
    if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (chunks == 0) continue;
    adamw_update_kernel<<<chunks, THREADS, 0, s>>>(
        t, static_cast<const float*>(scale), static_cast<const float*>(lr),
        static_cast<const float*>(b1c), static_cast<const float*>(b2c), c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
