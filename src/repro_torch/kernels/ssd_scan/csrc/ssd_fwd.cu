// Mamba2 SSD chunked scan, forward, fp32 x, for Hopper (sm_90a): CUDA C++ on
// the CUDA cores, exact fp32. This is the fp32 route only; bf16 x goes to
// ssd_fwd_sm90.cu (TF32 wgmma), whose roundings would miss fp32's tolerance.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_scan_fwd) for fp32 x. For each chunk of Q
// steps, in order, with the fp32 state h (N, P) carried from chunk to chunk:
//   lcum = cumsum(la)                              log-decay up to each step
//   y    = ((C.B^T) o L).(x*dt)                    L[i,j] = exp(lcum_i - lcum_j), j <= i
//        + (C.h) * exp(lcum)                       the state before this chunk
//        + D * x
//   h    = h * exp(lcum_last) + B^T.(x*dt*exp(lcum_last - lcum))
// and h_last is the state after the last chunk.
//
// What bounds it on the H100: at the mamba2-2.7b serving shape (b=4, nc=4,
// Q=256, H=80, P=64, N=128) in fp32 the function moves ~185 MB and needs
// ~16.3 GFLOP, 0.24 ms at the CUDA cores' 67 TFLOP/s: operations. It is
// simple and exact: every product runs as fp32 FMAs, and each block
// recomputes C.B^T for its own head (full 64 x 64 tiles on the diagonal),
// ~31 GFLOP in all.
//
// Design. The TPU grid's sequential chunk axis becomes a loop inside the
// block: one block of 256 threads owns one (batch, head, P-tile of <= 64
// columns) and walks the chunks itself, with the state in shared memory.
// The columns p of h and y are independent, so P-tiles need no exchange. A
// (Q, Q) fp32 tile would be 256 KB at Q = 256, over the 227 KB a block may
// use, so the chunk is cut into 64-row tiles: for each row tile i, the
// inter-chunk term, then for each column tile j <= i the weights
// (C_i.B_j^T) o L (exp taken only where j <= i: exp of a positive segment can
// overflow, and inf * 0 would be NaN) and their product with x_j*dt_j. Then
// the state update over all column tiles, in registers, written back once
// every read of the old state is behind a barrier. Each thread computes 4x4
// micro-tiles from float4 reads of shared memory; C and B tiles are stored
// transposed ([n][row]) for the products over n, B natural ([row][n]) for
// the state update.
//
// Shapes past the serving ones: a chunk longer than QMAX = 256 is walked as
// sub-chunks of 256 steps (the last one shorter), the state carried across
// them as across chunks: the same recurrence, only the rounding differs.
// N up to 256 takes P-tiles of 32 columns (at 64 its shared memory would be
// 232,448 bytes, the whole of what a block may use; at 32, 191,488). The
// last P-tile may be ragged, so any P is taken (x is read an element at a
// time). N over 256 is cut into slices of NSLICE = 256 state rows, a grid
// axis: a slice's state rows depend on no other slice's, and its products
// over n (C.B^T and C.h) take its own columns of B and C, so y is the sum
// of the slices' parts. Each slice writes its part (D.x in slice 0 only)
// to an fp32 scratch buffer, and ssd_sum_slices_kernel adds them in a
// fixed order. (Each slice computes the intra-chunk term on its own
// columns of C.B^T; together they are the whole term, at the work of one
// per slice.)
//
// Entry point: ssd_fwd(...) with a plain C interface (loaded with ctypes),
// launching on the given stream and returning cudaGetLastError().
#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int TILE = 64;      // rows of a chunk tile
constexpr int QMAX = 256;     // longest (sub-)chunk a block walks at once
constexpr int NSLICE = 256;   // state rows a block takes: one slice of N
constexpr int PTMAX = 64;     // widest P-tile (32 where N > 128)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[k][l] += a[k] * b[l]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[k][l] = fmaf(av[k], bv[l], acc[k][l]);
}

// rows [r0, r0 + TILE) of N columns of a chunk of B or C (rows `ld` floats
// apart), transposed into dst[n][r]; rows at or past Q are zero
__device__ __forceinline__ void load_transposed(float* dst, const float* src, int r0,
                                                int Q, int N, int ld, int tid) {
  for (int e = tid; e < TILE * (N / 4); e += NT) {
    const int r = e % TILE, n = 4 * (e / TILE);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < Q) v = ld4(src + static_cast<long long>(r0 + r) * ld + n);
    dst[(n + 0) * TILE + r] = v.x;
    dst[(n + 1) * TILE + r] = v.y;
    dst[(n + 2) * TILE + r] = v.z;
    dst[(n + 3) * TILE + r] = v.w;
  }
}

// xs[c][p] = x[j0 + c, p] * dt[j0 + c] for the block's head and P-tile (pv
// valid columns of PT)
template <typename T>
__device__ __forceinline__ void load_xdt(float* xs, const T* x, const float* dts,
                                         long long row0, int j0, int Q, int H, int h,
                                         int P, int p_base, int PT, int pv, int tid) {
  for (int e = tid; e < TILE * PT; e += NT) {
    const int c = e / PT, p = e % PT;
    xs[e] = j0 + c < Q && p < pv
                ? to_f32(x[((row0 + j0 + c) * H + h) * P + p_base + p]) * dts[j0 + c]
                : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ la, const float* __restrict__ Dv,
               T* __restrict__ y, float* __restrict__ h_last, float* __restrict__ yp,
               int nsl, int nc, int Q, int H, int P, int Nall, int PT) {
  // the state's slice of this block: rows [nbase, nbase + N) of the Nall
  // of B, C and h. Slices are independent but for y: with two or more (yp
  // set) each writes its part of y to yp[slice] (its own columns of C.B^T
  // and C.h; D.x in slice 0), and ssd_sum_slices_kernel adds them up
  const int slice = blockIdx.z % nsl, b = blockIdx.z / nsl;
  const int nbase = slice * NSLICE, N = min(NSLICE, Nall - nbase);
  extern __shared__ __align__(16) float smem[];
  float* lc = smem;                  // [QMAX] cumulative log-decay
  float* dts = lc + QMAX;            // [QMAX] dt
  float* dec = dts + QMAX;           // [QMAX] exp(lcum_last - lcum)
  float* ct = dec + QMAX;            // [N][TILE] C row tile, transposed
  float* bt = ct + N * TILE;         // [N][TILE] B column tile; [TILE][N] in the state update
  float* hs = bt + N * TILE;         // [N][PT] the state
  float* xs = hs + N * PT;           // [TILE][PT] x * dt of a column tile
  float* ws = xs + TILE * PT;        // [TILE][TILE] weights, [c][r]; also a y tile [r][p]

  const int tid = threadIdx.x;
  const int p_base = blockIdx.x * PT;
  const int pv = min(PT, P - p_base);    // valid columns of this P-tile
  const int h = blockIdx.y;
  const float d_h = slice == 0 ? Dv[h] : 0.f;
  // the 4x4 micro-tile of a (TILE x TILE) or (TILE x PT) tile this thread owns
  const int mr = 4 * (tid % 16);
  const int mc = 4 * (tid / 16);
  const bool owns_y = mc < PT;
  const int nq = N / 4;
  const int n_state = nq * (PT / 4);     // 4x4 micro-tiles of the state, <= 2 * NT
  // units: sub-chunk u % nsub (QMAX steps, the last one shorter) of chunk
  // u / nsub, in order
  const int nsub = (Q + QMAX - 1) / QMAX;
  const int Qc = Q;

  for (int e = tid; e < N * PT; e += NT) hs[e] = 0.f;

  for (int u = 0; u < nc * nsub; ++u) {
    const int s_first = u % nsub * QMAX;
    const long long row0 = (static_cast<long long>(b) * nc + u / nsub) * Qc + s_first;
    const int Q = min(QMAX, Qc - s_first);    // this unit's steps
    const int n_tiles = (Q + TILE - 1) / TILE;
    const float* Bc = Bm + row0 * Nall + nbase;
    const float* Cc = Cm + row0 * Nall + nbase;
    __syncthreads();   // the previous unit is done with lc and the state
    if (tid < 32) {    // warp 0: inclusive prefix sum of la over the unit
      const int per = (Q + 31) / 32;
      const int s0 = tid * per, s1 = min(s0 + per, Q);
      float run = 0.f;
      for (int s = s0; s < s1; ++s) {
        run += la[(row0 + s) * H + h];
        lc[s] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float before = incl - run;
      for (int s = s0; s < s1; ++s) lc[s] += before;
    }
    __syncthreads();
    const float lc_last = lc[Q - 1];
    for (int s = tid; s < QMAX; s += NT) {
      const bool v = s < Q;
      dts[s] = v ? dt[(row0 + s) * H + h] : 0.f;
      dec[s] = v ? expf(lc_last - lc[s]) : 0.f;
      if (!v) lc[s] = 0.f;
    }

    // ---- y, one row tile at a time -------------------------------------
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * TILE;
      __syncthreads();   // ct and ws are free; dts, dec, lc are visible
      load_transposed(ct, Cc, i0, Q, N, Nall, tid);
      __syncthreads();
      float acc[4][4] = {};
      if (owns_y) {      // inter-chunk term from the state before this chunk
#pragma unroll 4
        for (int n = 0; n < N; ++n) outer4(acc, ld4(ct + n * TILE + mr), ld4(hs + n * PT + mc));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float e = expf(lc[i0 + mr + k]);
#pragma unroll
          for (int l = 0; l < 4; ++l) acc[k][l] *= e;
        }
      }
      for (int jt = 0; jt <= it; ++jt) {   // intra-chunk term, column tiles j <= i
        const int j0 = jt * TILE;
        __syncthreads();   // bt, xs, ws are free
        load_transposed(bt, Bc, j0, Q, N, Nall, tid);
        load_xdt(xs, x, dts, row0, j0, Q, H, h, P, p_base, PT, pv, tid);
        __syncthreads();
        float s[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < N; ++n) outer4(s, ld4(ct + n * TILE + mr), ld4(bt + n * TILE + mc));
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int c = j0 + mc + l;
          float w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int r = i0 + mr + k;
            // exp only where j <= i: a masked exp may overflow, and inf * 0 is NaN
            w[k] = (c <= r && r < Q) ? s[k][l] * expf(lc[r] - lc[c]) : 0.f;
          }
          *reinterpret_cast<float4*>(ws + (mc + l) * TILE + mr) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();
        if (owns_y) {
#pragma unroll 4
          for (int c = 0; c < TILE; ++c)
            outer4(acc, ld4(ws + c * TILE + mr), ld4(xs + c * PT + mc));
        }
      }
      // y tile through shared memory, so that the store is coalesced
      __syncthreads();
      if (owns_y) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l) ws[(mr + k) * PT + mc + l] = acc[k][l];
      }
      __syncthreads();
      const long long rows = static_cast<long long>(gridDim.z / nsl) * nc * Qc;
      for (int e = tid; e < TILE * PT; e += NT) {
        const int r = e / PT, p = e % PT;
        if (i0 + r < Q && p < pv) {
          const long long off = ((row0 + i0 + r) * H + h) * P + p_base + p;
          const float v = ws[e] + d_h * to_f32(x[off]);
          if (yp != nullptr)
            yp[slice * rows * H * P + off] = v;
          else
            store(y + off, v);
        }
      }
    }

    // ---- state: h * exp(lcum_last) + B^T.(x*dt*exp(lcum_last - lcum)) --
    float hacc[2][4][4] = {};
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * TILE;
      __syncthreads();   // bt and xs are free
      for (int e = tid; e < TILE * nq; e += NT) {
        const int c = e / nq, n = 4 * (e % nq);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j0 + c < Q) {
          v = ld4(Bc + static_cast<long long>(j0 + c) * Nall + n);
          const float d = dec[j0 + c];
          v.x *= d; v.y *= d; v.z *= d; v.w *= d;
        }
        *reinterpret_cast<float4*>(bt + c * N + n) = v;
      }
      load_xdt(xs, x, dts, row0, j0, Q, H, h, P, p_base, PT, pv, tid);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int t = tid + m * NT;
        if (t < n_state) {
          const int n0 = 4 * (t % nq), p0 = 4 * (t / nq);
#pragma unroll 4
          for (int c = 0; c < TILE; ++c)
            outer4(hacc[m], ld4(bt + c * N + n0), ld4(xs + c * PT + p0));
        }
      }
    }
    // every read of the old state (the inter-chunk term) is behind the
    // barriers above; each thread rewrites only its own elements
    const float decay = expf(lc_last);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int t = tid + m * NT;
      if (t < n_state) {
        const int n0 = 4 * (t % nq), p0 = 4 * (t / nq);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            float* hp = hs + (n0 + k) * PT + p0 + l;
            *hp = *hp * decay + hacc[m][k][l];
          }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < N * PT; e += NT) {
    const int n = e / PT, p = e % PT;
    if (p < pv)
      h_last[((static_cast<long long>(b) * H + h) * Nall + nbase + n) * P + p_base + p] = hs[e];
  }
}

// N over 256: y = the sum of the slices' parts, slice 0 first, in one fixed
// order (no atomics: the result does not depend on which block ran first)
__global__ void __launch_bounds__(256)
ssd_sum_slices_kernel(const float* __restrict__ yp, float* __restrict__ y, long long n,
                      int nsl) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += gridDim.x * 256LL) {
    float v = yp[i];
    for (int s = 1; s < nsl; ++s) v += yp[s * n + i];
    y[i] = v;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* B, const void* C,
                   const void* la, const void* D, void* y, void* h_last, void* yp, int b,
                   int nc, int Q, int H, int P, int Nall, cudaStream_t stream) {
  // slices of at most NSLICE state rows, a block each; P-tiles of up to 64
  // columns (32 where a slice has over 128 rows), a multiple of 4 (the
  // micro-tiles), the last one ragged
  const int nsl = (Nall + NSLICE - 1) / NSLICE, N = Nall < NSLICE ? Nall : NSLICE;
  const int pt_max = N > NSLICE / 2 ? PTMAX / 2 : PTMAX;
  const int PT = P < pt_max ? (P + 3) / 4 * 4 : pt_max;
  const int smem = (3 * QMAX + 2 * N * TILE + N * PT + TILE * PT + TILE * TILE) *
                   static_cast<int>(sizeof(float));
  auto kern = ssd_fwd_kernel<T>;
  // the shared-memory limit (the largest this kernel asks for) is set once
  // per device, not on every launch
  static std::atomic<int> smem_set_on{-1};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && smem_set_on.load() != dev) {
    const int most = (3 * QMAX + 2 * NSLICE * TILE + NSLICE * (PTMAX / 2) + TILE * (PTMAX / 2) +
                      TILE * TILE) * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess) smem_set_on.store(dev);
  }
  if (err != cudaSuccess) return err;
  float* parts = nsl > 1 ? static_cast<float*>(yp) : nullptr;
  const dim3 grid((P + PT - 1) / PT, H, b * nsl);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(la),
      static_cast<const float*>(D), static_cast<T*>(y), static_cast<float*>(h_last), parts,
      nsl, nc, Q, H, P, Nall, PT);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == nullptr) return err;
  const long long n_y = static_cast<long long>(b) * nc * Q * H * P;
  const long long want = (n_y + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  ssd_sum_slices_kernel<<<blocks, 256, 0, stream>>>(parts, static_cast<float*>(y), n_y, nsl);
  return cudaGetLastError();
}

}  // namespace

// x (b,nc,Q,H,P) and y (b,nc*Q,H,P), dt, la (b,nc,Q,H), B, C (b,nc,Q,N), D
// (H,) and h_last (b,H,N,P), all fp32 and contiguous, B and C 16-byte
// aligned; yp an fp32 scratch buffer of nsl*b*nc*Q*H*P elements, nsl =
// ceil(N / 256), where N > 256 (else unused, may be null). Q >= 1; N a
// multiple of 4; P >= 1.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* B, const void* C,
                       const void* la, const void* D, void* y, void* h_last, void* yp,
                       int b, int nc, int Q, int H, int P, int N, void* stream) {
  const bool ok = b > 0 && nc > 0 && Q >= 1 && H > 0 && N >= 4 && N % 4 == 0 && P >= 1 &&
                  (N <= NSLICE || yp != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<float>(x, dt, B, C, la, D, y, h_last, yp, b, nc, Q, H, P, N,
                                        static_cast<cudaStream_t>(stream)));
}
