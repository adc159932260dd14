// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a), x in bf16 or fp16,
// every product on the tensor cores in TF32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_scan_fwd) for bf16 and fp16 x; fp32 x goes
// to the exact ssd_fwd.cu. It computes what that kernel computes. For each chunk
// of Q steps, in order, with the fp32 state h (N, P) carried from chunk to
// chunk:
//   lcum = cumsum(la)
//   y    = (W).x + (C.h) * exp(lcum) + D * x,   W = (C.B^T) o L o dt_j,
//          L[i,j] = exp(lcum_i - lcum_j) for j <= i, else 0
//   h    = h * exp(lcum_last) + (B o dt * exp(lcum_last - lcum))^T.x
// D.x is added in fp32 before the one cast to x's type; h_last is fp32.
// fp16 x is exact in TF32 as bf16 x is (10 and 7 mantissa bits against
// TF32's 10), so both types take the same products.
//
// What bounds it on the H100: bytes. At the mamba2-2.7b serving shape (b=4,
// nc=4, Q=256, H=80, P=64, N=128) it moves ~101 MB (x read and y written
// dominate), 0.030 ms at 3.35 TB/s, against 16.3 GFLOP, 0.033 ms at TF32's
// 495 TFLOP/s: the two are close, so the products must run on the tensor
// cores and be fed without stalls.
//
// Why TF32 and not bf16. Rounding W to bf16 (x is exact in bf16) put 17
// outputs over the bf16 tolerance (|err| <= 5e-2 + 5e-2 |ref|) at the
// serving shape, at worst 1.55x of it; rounding B and C to bf16 for C.B^T
// put 14-16 over at smaller shapes, at worst 1.8x. With every operand read
// as TF32 (10 mantissa bits, truncated) the worst output stays at 0.58 of
// the tolerance. fp32 operands are what wgmma's tf32 form reads: no
// conversion pass. The sums stay fp32. ref.ssd_scan_tf32_ref models exactly
// these roundings.
//
// What the design does about each limit of the CUDA-core version
// (ssd_fwd.cu):
//   - C.B^T once per (batch, chunk), not once per head: a first kernel,
//     ssd_cb_kernel, computes the causal 64 x 64 tile pairs of CB = C.B^T
//     (a TF32 wgmma over N) into an fp32 scratch buffer (units, QT, QT) that
//     stays in L2 (4.2 MB at the serving shape); the TPU kernel gets the
//     same by broadcasting B and C over its head axis;
//   - tensor cores: the scan kernel runs the inter term C_i.h, the intra
//     term W_ij.x_j and the state update as m64nNk8 TF32 wgmmas. TF32 reads
//     both operands K-major only, so h is kept transposed (h^T [p][n]) and
//     x is widened to fp32 and transposed (x^T [p][j]) in shared memory,
//     both in the 128-byte swizzle the descriptors name. W and the scaled
//     B^T are built in registers straight into wgmma's A fragment (rs).
//     Off the diagonal tile the decay 2^(lc_i - lc_j) factors through the
//     column tile's last step, so W costs two multiplies an element and no
//     exp. A fragment is built only after the last wgmma reading registers
//     is done: registers defined while wgmmas are in flight make ptxas
//     serialise every wgmma of the kernel (measured: 0.209 -> 0.185 ms);
//   - more work in flight: two consumer warpgroups a block share x^T and
//     h^T. Row tiles go to them in the order {0, 3} / {1, 2} (5 intra
//     tiles each at 4 tiles a chunk), state rows n by halves;
//   - loads: each warpgroup has its own 2-stage ring of 16 KB slots and a
//     producer warp keeping TMA loads of its C row tiles, CB tiles and B
//     tile halves in flight ("full" / "empty" mbarriers). A loader warp
//     stages the next chunk's x, dt and la by cp.async (16 bytes a copy
//     where rows allow, else 8) while the current chunk computes. B and C
//     come once a (head, chunk) from L2, x once from memory;
//   - y tiles are staged in shared memory and written by a TMA store
//     (thread stores where P % 8 != 0); the state stays in registers (the
//     state update's accumulator) across chunks, written once a chunk to
//     h^T;
//   - launch overhead: the shared-memory limits are set once per device.
// One block per (P-tile of 32 or 64 columns, head, batch), ~220 KB of
// shared memory at PT = 64, so one block an SM: 320 blocks at the serving
// shape, 2.4 waves on 132 SMs. The last P-tile may be ragged (P = 96: 64 +
// 32 columns).
// Shapes past the serving ones:
//   - a chunk longer than QMAX = 256 steps is walked as sub-chunks of 256
//     (the last one shorter), the state carried across them in registers
//     as across chunks. It is the same recurrence (only the rounding
//     differs); C.B^T is computed per sub-chunk. Every loop below runs
//     over these units (chunk, sub-chunk);
//   - N up to 256: a B or C tile is 8 atoms (4 ring slots), the state four
//     64-row tiles, two a warpgroup. Shared memory at PT = 64 would pass
//     the 227 KB a block may use, so N > 128 takes PT = 32 (~164 KB).
//     Columns of N past a multiple of 32 load as zeros;
//   - N over 256: the state is cut into slices of NSLICE = 256 rows, a grid
//     axis (the registers and shared memory of one block stop at 256). The
//     rows h[n, :] of one slice do not depend on the others', so each block
//     carries its slice's state through the chunks alone; C.h is a sum over
//     N, so each slice writes its part of y in fp32 to a scratch buffer
//     (slice 0 adding the intra-chunk term and D.x, once) and a last kernel
//     adds the parts in a fixed order and casts. C.B^T is a sum over N too:
//     ssd_cb_exact_kernel takes it in passes of 256 columns, in one
//     accumulator, in exact fp32 (TF32 operands put outputs past the
//     tolerance there).
// Two faster forms were dropped: the loader
// warp computing the step vectors (lc, scl, vdt) for the next chunk, and
// persistent blocks that walk several (P-tile, head, batch) units. Each
// wrote wrong rows of y (and h) at random on shapes with 2-3 row tiles a
// chunk and more blocks than SMs (e.g. Q = 128, H = 100), which this form
// never did in the same stress runs; the cause was not found.
//
// Entry point: ssd_fwd_sm90(...) with a plain C interface (loaded with
// ctypes); it launches ssd_cb_kernel then the scan kernel (N over 256:
// ssd_cb_exact_kernel, the sliced scan, ssd_sum_slices_kernel) on the given
// stream and returns cudaGetLastError().
#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 64;           // rows of a chunk tile
constexpr int QMAX = 256;          // longest (sub-)chunk a block walks at once
constexpr int NSLICE = 256;        // state rows a block takes: one slice of N
constexpr int ATOM_BYTES = TILE * 128;  // 64 rows of one 128-byte swizzle atom
constexpr int SLOT = 2 * ATOM_BYTES;     // a ring slot: two atoms, 64 x 64 fp32
constexpr int STAGES = 2;               // depth of each consumer warpgroup's TMA ring
constexpr int WG = 128;                 // threads of a warpgroup
constexpr int NCONS = 2 * WG;           // consumer threads: two warpgroups
constexpr int NTHREADS = NCONS + 96;    // + a TMA producer warp per warpgroup, a loader warp

// Byte offset of element (row, col) of an fp32 tile of `rows` rows stored
// as 128-byte-swizzled atoms of 32 columns ([col / 32][rows][32], the 16-byte
// chunks of each row permuted by row % 8), as TMA writes it and wgmma reads it.
__device__ __forceinline__ uint32_t swz(int row, int col, int rows) {
  return (col >> 5) * rows * 128 + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         ((col & 3) << 2);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ float lds(const uint8_t* base, uint32_t off) {
  return *reinterpret_cast<const float*>(base + off);
}

__device__ __forceinline__ void sts(uint8_t* base, uint32_t off, float v) {
  *reinterpret_cast<float*>(base + off) = v;
}

// all consumer threads
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// the threads of consumer warpgroup w
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + w) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// the barrier's phase completes (one arrival of this thread) once every
// cp.async this thread has issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// k8 step kk of a K-major swizzled operand whose atoms of `rows` rows lie
// one after another from `desc`
__device__ __forceinline__ uint64_t kstep(uint64_t desc, int kk, int rows) {
  return desc_advance(desc, (kk >> 2) * rows * 128 + (kk & 3) * 32);
}

// K-major descriptor of a 64-row tile in the 128-byte swizzle
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  return make_desc(tile, 16, 1024, Swizzle::B128);
}


// A B or C tile (64 rows x NA atoms of 32 columns) takes SLOTS<NA> ring
// slots, two atoms a slot.
template <int NA>
inline constexpr int SLOTS = (NA + 1) / 2;

// ---- CB = C.B^T, once per (batch, chunk, sub-chunk) -------------------------
// Block (tile pair, unit): rows it, columns jt <= it of CB, one TF32 wgmma
// chain over N (both operands K-major: n is contiguous in B and C). Unit u
// is sub-chunk u % nsub (rows from QMAX * (u % nsub)) of chunk u / nsub.
template <int NA>
inline constexpr int CB_SMEM = 1024 + 2 * NA * ATOM_BYTES + 8;

template <int NA>
__global__ void __launch_bounds__(WG)
ssd_cb_kernel(const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tb,
              float* __restrict__ cb, int QT, int nsub) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sc = align1024(smem_raw);
  uint8_t* sb = sc + NA * ATOM_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sb + NA * ATOM_BYTES);
  int it = 0, jt = blockIdx.x;
  while (jt > it) jt -= ++it;      // the blockIdx.x-th causal pair (it, jt)
  const int bc = blockIdx.y / nsub, s0 = blockIdx.y % nsub * QMAX;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 2 * NA * ATOM_BYTES);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tma_load_3d(sc + a * ATOM_BYTES, &tc, bar, 32 * a, s0 + it * TILE, bc);
      tma_load_3d(sb + a * ATOM_BYTES, &tb, bar, 32 * a, s0 + jt * TILE, bc);
    }
  }
  mbar_wait(bar, 0);

  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NA; ++kk)
    MmaTf32<64>::ss(d, kstep(tile_desc(sc), kk, TILE), kstep(tile_desc(sb), kk, TILE), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);

  const int row = it * TILE + 16 * warp + lane / 4;
  float* out =
      cb + (static_cast<long long>(blockIdx.y) * QT + row) * QT + jt * TILE + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      *reinterpret_cast<float2*>(out + 8 * q * QT + 8 * j) =
          make_float2(d[4 * j + 2 * q], d[4 * j + 2 * q + 1]);
}

// Past 256 states (a grid of ssd_cb_exact_kernel in place of the above):
// the same tiles of CB in passes of 256 columns of C and B (NSLICE), added up
// in one accumulator, in exact fp32 FMAs on the CUDA cores. Over 512 states
// the TF32 truncation of C and B moved outputs where y cancels past the
// plain version's tolerance (measured against the CPU model of the
// roundings); the products of one tile pair are few.
inline constexpr int CB_EXACT_SMEM = 1024 + 2 * 8 * ATOM_BYTES + 8;

__global__ void __launch_bounds__(WG)
ssd_cb_exact_kernel(const __grid_constant__ CUtensorMap tc,
                    const __grid_constant__ CUtensorMap tb, float* __restrict__ cb, int QT,
                    int nsub, int npass) {
  constexpr int NA = NSLICE / 32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sc = align1024(smem_raw);
  uint8_t* sb = sc + NA * ATOM_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sb + NA * ATOM_BYTES);
  int it = 0, jt = blockIdx.x;
  while (jt > it) jt -= ++it;      // the blockIdx.x-th causal pair (it, jt)
  const int bc = blockIdx.y / nsub, s0 = blockIdx.y % nsub * QMAX;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // the accumulator of a wgmma's layout, so that the store is the one above:
  // d[4j + e] is row r, column 8j + cc + e, and d[4j + 2 + e] row r + 8
  const int r = 16 * warp + lane / 4, cc = 2 * (lane % 4);
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  for (int ps = 0; ps < npass; ++ps) {
    if (tid == 0) {
      mbar_arrive_expect_tx(bar, 2 * NA * ATOM_BYTES);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        tma_load_3d(sc + a * ATOM_BYTES, &tc, bar, 32 * (NA * ps + a), s0 + it * TILE, bc);
        tma_load_3d(sb + a * ATOM_BYTES, &tb, bar, 32 * (NA * ps + a), s0 + jt * TILE, bc);
      }
    }
    mbar_wait(bar, ps & 1);
    for (int n = 0; n < 32 * NA; ++n) {
      const float c0 = lds(sc, swz(r, n, TILE)), c1 = lds(sc, swz(r + 8, n, TILE));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bv = lds(sb, swz(8 * j + cc + e, n, TILE));
          d[4 * j + e] = fmaf(c0, bv, d[4 * j + e]);
          d[4 * j + 2 + e] = fmaf(c1, bv, d[4 * j + 2 + e]);
        }
    }
    __syncthreads();  // every thread is done with this pass's tiles
  }

  float* out = cb + (static_cast<long long>(blockIdx.y) * QT + it * TILE + r) * QT + jt * TILE +
               cc;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      *reinterpret_cast<float2*>(out + 8 * q * QT + 8 * j) =
          make_float2(d[4 * j + 2 * q], d[4 * j + 2 * q + 1]);
}

// ---- the scan ---------------------------------------------------------------

template <int PT, int NA>
struct ScanLayout {
  static constexpr int XP = PT * 2 + 16;              // x staging pitch, bytes: rows
                                                      // shift banks by 4 words
  static constexpr int RING = 2 * STAGES * SLOT;      // one ring a warpgroup
  // h^T [p][n], swizzled: the state's 64-row tiles, at least one (NA <= 2)
  static constexpr int HT = (NA > 2 ? NA : 2) * PT * 128;
  static constexpr int XT = (QMAX / 32) * PT * 128;   // x^T [p][j] fp32, swizzled
  static constexpr int XS = QMAX * XP;                // x [j][p] 16-bit, as loaded
  static constexpr int YS = 2 * TILE * PT * 2;        // a y tile [i][p] 16-bit a warpgroup,
                                                      // swizzled as y's tensor map
  // lc, scl, vdt; dt and la of two chunks (this one and the next, loading)
  static constexpr int VEC = 7 * QMAX * 4;
  static constexpr int SMEM = 1024 + RING + HT + XT + XS + YS + VEC + (4 * STAGES + 2) * 8;
};

// The producer's next ring slot: waits until it is free and announces
// `bytes` on its full barrier.
__device__ __forceinline__ uint8_t* produce(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                            int& n, uint32_t bytes, uint64_t*& bar) {
  const int s = n % STAGES;
  mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
  bar = &full[s];
  mbar_arrive_expect_tx(bar, bytes);
  ++n;
  return ring + s * SLOT;
}

// `natoms` atoms of a 64-row tile, from atom `atom0` (32 columns each), rows
// from `row`, into the producer's next ring slot
__device__ __forceinline__ void produce_slot(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                             int& n, const CUtensorMap* map, int atom0,
                                             int natoms, int row, int bc) {
  uint64_t* bar;
  uint8_t* dst = produce(ring, full, empty, n, natoms * ATOM_BYTES, bar);
  for (int a = 0; a < natoms; ++a)
    tma_load_3d(dst + a * ATOM_BYTES, map, bar, 32 * (atom0 + a), row, bc);
}

// The consumers' ring slot n, once its tile has landed.
__device__ __forceinline__ const uint8_t* consume(uint8_t* ring, uint64_t* full, int n) {
  const int s = n % STAGES;
  mbar_wait(&full[s], (n / STAGES) & 1);
  return ring + s * SLOT;
}

__device__ __forceinline__ void release(uint64_t* empty, int n) {
  mbar_arrive(&empty[n % STAGES]);
}

// A unit's inputs of this head and P-tile into shared memory by cp.async,
// issued by the 32 lanes of the loader warp, each of which then arrives on
// `bar` once its copies have landed: rows [0, Q) from row0 of x into the
// staging buffer (16 bytes a copy where x's rows allow it, else 8), dt and
// la.
template <int PT, typename T>
__device__ __forceinline__ void load_chunk(uint8_t* xs, float* dtb, float* lab, const T* x,
                                           const float* dt, const float* la, long long row0,
                                           int Q, int H, int h, int P, int p0, int pv,
                                           bool x16, int lane, uint64_t* bar) {
  constexpr int XP = PT * 2 + 16;
  if (x16) {  // pv is a multiple of 8
    for (int j = lane / (PT / 8); j < Q; j += 32 / (PT / 8)) {
      const int q = lane % (PT / 8);
      if (8 * q < pv) cp_async16(xs + j * XP + 16 * q, x + ((row0 + j) * H + h) * P + p0 + 8 * q);
    }
  } else {
    for (int j = lane / (PT / 4); j < Q; j += 32 / (PT / 4)) {
      const int q = lane % (PT / 4);
      if (4 * q < pv) cp_async8(xs + j * XP + 8 * q, x + ((row0 + j) * H + h) * P + p0 + 4 * q);
    }
  }
  for (int j = lane; j < Q; j += 32) {
    cp_async4(dtb + j, dt + (row0 + j) * H + h);
    cp_async4(lab + j, la + (row0 + j) * H + h);
  }
  cp_async_arrive(bar);
}

// byte offset `off` of a [64][PT] bf16 tile in the swizzle TMA gives rows of
// PT * 2 bytes: 128-byte rows (PT = 64) XOR their 16-byte chunk index with
// row % 8, 64-byte rows (PT = 32) theirs with (row / 2) % 4
template <int PT>
__device__ __forceinline__ uint32_t yswz(uint32_t off) {
  return off ^ (((off >> 7) & (PT == 64 ? 7 : 3)) << 4);
}

// 2^x in one MUFU op; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// W_ij = CB_ij o 2^(lc_i - lc_j) o dt_j (lc in log2 units) in wgmma's tf32 A
// layout: a[kk][r + 2hh] = W[row r0 + 8r][col 8kk + 4hh + c]. The CB tile is
// [i][j] in two swizzled atoms; row r0 + 8r has r0's swizzle phase g. Rows
// past Q hold C = 0 and are never stored.
//   Off the diagonal (every j < i) the decay factors through the last step
//   R of the column tile, j <= R < i: 2^(lc_i - lc_j) = u_i * 2^(lc_R - lc_j),
//   both factors <= 1, so no exp per element: u holds 2^(lc_i - lc_R) of
//   rows r0 and r0 + 8, vdt[j] = dt_j * 2^(lc_R - lc_j).
//   On the diagonal, one exp per element, and j > i masked (its exp may
//   overflow: the select, not a product, makes it 0).
template <bool DIAG>
__device__ __forceinline__ void build_w(uint32_t (&a)[8][4], const uint8_t* cbt,
                                        const float* lc, const float* dts, const float* vdt,
                                        int j0, int I0, float l0, float l1, float u0, float u1,
                                        int r0, int c) {
  const uint8_t* row = cbt + r0 * 128 + c * 4;
  const int g = r0 & 7;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int col = 8 * kk + 4 * hh, J = j0 + col + c;
      const uint32_t off = (col >> 5) * ATOM_BYTES + ((((col & 31) >> 2) ^ g) << 4);
      if (DIAG) {
        const float lj = lc[J], dj = dts[J];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float w = lds(row + r * 1024, off) * ex2((r ? l1 : l0) - lj) * dj;
          a[kk][r + 2 * hh] = __float_as_uint(J <= I0 + 8 * r ? w : 0.f);
        }
      } else {
        const float vj = vdt[J];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[kk][r + 2 * hh] = __float_as_uint(lds(row + r * 1024, off) * (r ? u1 : u0) * vj);
      }
    }
}

// (B o scl)^T for the state rows n = nb + r0 + 8r in the tf32 A layout:
// a[kk][r + 2hh] = B[j = 8kk + 4hh + c][n] * scl[j0 + j]; columns n of the
// B tile slot `bt` are nb .. nb + 63 (two swizzled atoms); rows n >= N are 0.
__device__ __forceinline__ void build_bd(uint32_t (&a)[8][4], const uint8_t* bt,
                                         const float* scl, int j0, int nb, int N, int r0,
                                         int c) {
  uint32_t off[2][2];
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int nr = r0 + 8 * r;
    ok[r] = nb + nr < N;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) off[r][hh] = swz(4 * hh + c, nr, TILE);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float sj = scl[j0 + 8 * kk + 4 * hh + c];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // row 8kk + 4hh + c has the swizzle phase of row 4hh + c
        const float v = lds(bt + 8 * kk * 128, off[r][hh]) * sj;
        a[kk][r + 2 * hh] = __float_as_uint(ok[r] ? v : 0.f);
      }
    }
}

// one wgmma group: acc += A (registers, 64 x 64 over j) . x^T [p][j] for the
// j-tile jt
template <int PT>
__device__ __forceinline__ void mma_xt(float (&acc)[PT / 2], uint32_t (&a)[8][4],
                                       uint64_t xt_desc, int jt) {
  // every A register is final before the first wgmma: otherwise the compiler
  // sinks the build into the chain and fences (serialises) each wgmma
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[kk][q]) :: "memory");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) MmaTf32<PT>::rs(acc, a[kk], kstep(xt_desc, 8 * jt + kk, PT), 1);
  wgmma_commit();
}

// SLICED: the block takes slice blockIdx.z % nsl of the state (N over 256,
// NA = 8). The unsliced instantiations must not carry the slice code: with
// it compiled in, though never run there, the scan wrote wrong y at random
// at (3, 3, 192, 90, 64, 96) (ROADMAP.md, Queue 2, K2 item 7).
template <typename T, int PT, int NA, bool SLICED>
__global__ void __launch_bounds__(NTHREADS, 1)
ssd_scan_sm90_kernel(const __grid_constant__ CUtensorMap tc,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tcb,
                     const __grid_constant__ CUtensorMap ty, int y_tma,
                     const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ la, const float* __restrict__ Dv,
                     T* __restrict__ y, float* __restrict__ h_last,
                     float* __restrict__ yp, int nsl, int nc, int Q, int H, int P, int N) {
  using L = ScanLayout<PT, NA>;
  constexpr int ND = PT / 2;           // accumulator registers of a 64 x PT tile
  constexpr int SPT = SLOTS<NA>;       // ring slots of a B or C tile
  constexpr int NST = NA > 2 ? NA / 2 : 1;   // 64-row tiles of the state (n)
  constexpr int MW = NST > 1 ? NST / 2 : 1;  // of them a warpgroup holds
  extern __shared__ uint8_t smem_raw[];
  uint8_t* rings = align1024(smem_raw);
  uint8_t* ht = rings + L::RING;
  uint8_t* xt = ht + L::HT;
  uint8_t* yss = xt + L::XT;
  uint8_t* xs = yss + L::YS;
  float* lc = reinterpret_cast<float*>(xs + L::XS);  // cumulative log-decay, log2 units
  float* scl = lc + QMAX;                              // dt * 2^(lc_last - lc)
  float* vdt = scl + QMAX;                             // dt * 2^(lc_R - lc), R: the
                                                       // last step of its 64-row tile
  float* dtb = vdt + QMAX;                             // dt, two units
  float* lab = dtb + 2 * QMAX;                         // la, two units
  uint64_t* fulls = reinterpret_cast<uint64_t*>(lab + 2 * QMAX);
  uint64_t* emptys = fulls + 2 * STAGES;
  uint64_t* in_full = emptys + 2 * STAGES;  // a unit's x, dt, la have landed
  uint64_t* in_empty = in_full + 1;         // the consumers are done with the staged x

  const int p0 = blockIdx.x * PT, h = blockIdx.y;
  // the state's slice of this block: rows [n0, n0 + Ns) of N, B and C
  // columns from atom sa. Slice 0 alone adds the intra-chunk term and D.x.
  // With more than one slice (SLICED) each block writes its part of y in
  // fp32 to yp[slice], and ssd_sum_slices_kernel adds them up.
  const int slice = SLICED ? blockIdx.z % nsl : 0;
  const int b = SLICED ? blockIdx.z / nsl : blockIdx.z;
  const int n0 = slice * NSLICE, Ns = SLICED ? min(NSLICE, N - n0) : N, sa = n0 / 32;
  const bool intra_on = slice == 0;
  // the units: sub-chunk u % nsub (QMAX steps, the last one shorter) of
  // chunk u / nsub, in order; a unit's first step is s0 in its chunk
  const int nsub = (Q + QMAX - 1) / QMAX, nu = nc * nsub;
  auto unit_len = [=](int u) { return min(QMAX, Q - u % nsub * QMAX); };
  auto unit_row0 = [=](int u) {  // the unit's first row of x, dt, la, y
    return (static_cast<long long>(b) * nc + u / nsub) * Q + u % nsub * QMAX;
  };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Work of the two consumer warpgroups: row tiles it with (it ^ it / 2) % 2
  // == wg ({0, 3} and {1, 2} at 4 tiles: 5 intra tiles each), and the
  // state's 64-row tiles: rows n in [64 MW wg, 64 MW (wg + 1)) (all of them
  // in warpgroup 0 when N <= 64). Each warpgroup has its own ring and
  // producer warp, loading its tiles in the order it takes them.
  const int wg = min(warp / 4, 1);
  uint8_t* ring = rings + wg * STAGES * SLOT;
  uint64_t* full = fulls + wg * STAGES;
  uint64_t* empty = emptys + wg * STAGES;
  const bool has_state = NST > 1 || wg == 0;
  const int nb = NST > 1 ? TILE * MW * wg : 0;  // first state row n of this warpgroup
  auto owns = [wg](int it) { return ((it ^ (it >> 1)) & 1) == wg; };

  if (tid == 0) {
    for (int s = 0; s < 2 * STAGES; ++s) {
      mbar_init(&fulls[s], 1);
      mbar_init(&emptys[s], WG);
    }
    mbar_init(in_full, 32);
    mbar_init(in_empty, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int pv = min(PT, P - p0);    // valid columns of this P-tile
  if (warp == NCONS / 32 + 2) {
    // loader: unit u's x, dt and la, once the consumers are done with unit
    // u - 1's staged x (dt and la alternate between two buffers)
    const bool x16 = P % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    for (int u = 0; u < nu; ++u) {
      if (u > 0) mbar_wait(in_empty, (u - 1) & 1);
      load_chunk<PT>(xs, dtb + (u & 1) * QMAX, lab + (u & 1) * QMAX, x, dt, la, unit_row0(u),
                     unit_len(u), H, h, P, p0, pv, x16, lane, in_full);
    }
    return;
  }
  if (warp >= NCONS / 32) {
    // producer of ring warp - 8: the C tile and CB tiles j <= i of each row
    // tile its warpgroup owns, then its B tile slots, unit after unit
    const int w = warp - NCONS / 32;
    if (lane == 0) {
      ring = rings + w * STAGES * SLOT;
      full = fulls + w * STAGES;
      empty = emptys + w * STAGES;
      int n = 0;
      for (int u = 0; u < nu; ++u) {
        const int bc = b * nc + u / nsub, s0 = u % nsub * QMAX;
        const int cbu = b * nu + u, nt = (unit_len(u) + TILE - 1) / TILE;
        for (int it = 0; it < nt; ++it) {
          if (((it ^ (it >> 1)) & 1) != w) continue;
          for (int sp = 0; sp < SPT; ++sp)
            produce_slot(ring, full, empty, n, &tc, sa + 2 * sp, NA < 2 ? NA : 2,
                         s0 + it * TILE, bc);
          if (intra_on)
            for (int jt = 0; jt <= it; ++jt)
              produce_slot(ring, full, empty, n, &tcb, 2 * jt, 2, it * TILE, cbu);
        }
        if (NST > 1 || w == 0)
          for (int m = 0; m < MW; ++m)
            for (int jt = 0; jt < nt; ++jt)
              produce_slot(ring, full, empty, n, &tb, sa + (NST > 1 ? 2 * (MW * w + m) : 0),
                           NA < 2 ? NA : 2, s0 + jt * TILE, bc);
      }
    }
    return;
  }

  // consumers: this thread holds rows r0 and r0 + 8 of each 64-row tile
  // (of the unit for y, of n for the state), columns 8j + 2c + {0, 1}
  const int wtid = tid % WG;
  const int g = lane / 4, c = lane % 4, r0 = 16 * (warp % 4) + g;
  const float d_h = Dv[h];
  const uint64_t ht_desc = tile_desc(ht);
  const uint64_t xt_desc = tile_desc(xt);
  uint8_t* ys = yss + wg * TILE * PT * 2;
  float hacc[MW][ND];                // this warpgroup's state rows, columns p
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int i = 0; i < ND; ++i) hacc[m][i] = 0.f;
  int n = 0;                         // position in this warpgroup's ring

  // steps past the shortest unit stay 0 (a longer unit overwrites some)
  for (int s = unit_len(nsub - 1) + tid; s < QMAX; s += NCONS)
    dtb[s] = dtb[QMAX + s] = lab[s] = lab[QMAX + s] = 0.f;
  for (int u = 0; u < nu; ++u) {
    const int Qu = unit_len(u), nt = (Qu + TILE - 1) / TILE, QT = nt * TILE;
    const int bc = b * nc + u / nsub, s0 = u % nsub * QMAX;
    const long long row0 = unit_row0(u);
    const float* dts = dtb + (u & 1) * QMAX;
    const float* las = lab + (u & 1) * QMAX;
    mbar_wait(in_full, u & 1);
    consumer_sync();  // the last unit is done with every buffer
    if (warp == 0) {  // inclusive prefix sum of la over the unit
      const int per = (Qu + 31) / 32;
      const int s0l = lane * per, s1 = min(s0l + per, Qu);
      float run = 0.f;
      for (int s = s0l; s < s1; ++s) {
        run += las[s];
        lc[s] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float before = incl - run;
      for (int s = s0l; s < s1; ++s) lc[s] = (lc[s] + before) * 1.4426950408889634f;
      for (int s = Qu + lane; s < QT; s += 32) lc[s] = 0.f;
    }
    // x^T [p][j] in fp32: a warp takes 32 rows j and 8 columns p, reading
    // 16 bytes a row (the staging pitch spreads them over the banks) and
    // writing 32 consecutive j of one row p of an atom
    {
      constexpr int PB = PT / 8, NW = NCONS / 32, U = 4;  // U items in flight a warp
      const int items = (QT / 32) * PB;
      for (int e0 = warp; e0 < items; e0 += U * NW) {
        uint4 raw[U];
#pragma unroll
        for (int uu = 0; uu < U; ++uu) {
          const int e = e0 + uu * NW, j = (e / PB) * 32 + lane;
          raw[uu] = e < items && j < Qu
                        ? *reinterpret_cast<const uint4*>(xs + j * L::XP + 16 * (e % PB))
                        : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int uu = 0; uu < U; ++uu) {
          const int e = e0 + uu * NW, j = (e / PB) * 32 + lane, pc = (e % PB) * 8;
          if (e >= items) break;
          const T* xv = reinterpret_cast<const T*>(&raw[uu]);
#pragma unroll
          for (int r = 0; r < 8; ++r)
            sts(xt, swz(pc + r, j, PT), pc + r < pv ? to_f32(xv[r]) : 0.f);
        }
      }
    }
    // h^T [p][n] from this warpgroup's state rows
    if (has_state)
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int j = 0; j < ND / 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            sts(ht, swz(8 * j + 2 * c + (q & 1), nb + TILE * m + r0 + 8 * (q >> 1), PT),
                hacc[m][4 * j + q]);
    fence_async_smem();
    consumer_sync();
    if (tid == 0) mbar_arrive(in_empty);  // the loader may stage the next unit
    const float lc_last = lc[Qu - 1];
    for (int s = tid; s < QT; s += NCONS)
      scl[s] = s < Qu ? dts[s] * ex2(lc_last - lc[s]) : 0.f;
    for (int s = tid; s < QT; s += NCONS)
      vdt[s] = s < Qu ? dts[s] * ex2(lc[min(s | (TILE - 1), Qu - 1)] - lc[s]) : 0.f;
    consumer_sync();

    // ---- y, this warpgroup's 64-row tiles -------------------------------
    for (int it = 0; it < nt; ++it) {
      if (!owns(it)) continue;
      const int i0 = it * TILE;
      float acc[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] = 0.f;
      {  // inter-chunk term: C_i [i][n] . h^T [p][n], one group a slot; a
         // slot is released once its group is done (a C tile may take more
         // slots than the ring has)
#pragma unroll
        for (int sp = 0; sp < SPT; ++sp) {
          const uint8_t* ct = consume(ring, full, n + sp);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < (NA < 2 ? 4 : 8); ++kk)
            MmaTf32<PT>::ss(acc, kstep(tile_desc(ct), kk, TILE),
                            kstep(ht_desc, 8 * sp + kk, PT), sp + kk > 0);
          wgmma_commit();
          if (sp > 0) {
            wgmma_wait<1>();
            release(empty, n + sp - 1);
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release(empty, n + SPT - 1);
        n += SPT;
      }
      const int I0 = i0 + r0, I1 = I0 + 8;
      const float lc0 = lc[I0], lc1 = lc[I1];
      {
        const float e0 = ex2(lc0), e1 = ex2(lc1);
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[i] *= (i / 2) % 2 ? e1 : e0;
      }
      // intra-chunk term: W_ij [i][j] from registers . x^T [p][j], j <= i.
      // A tile is built only once the last one's wgmmas are done: building
      // registers that a wgmma reads while wgmmas are in flight makes ptxas
      // serialise every wgmma of the kernel (the other warpgroup fills the gap)
      uint32_t wa[8][4];
      auto intra = [&](uint32_t (&w)[8][4], int jt) {
        const uint8_t* cbt = consume(ring, full, n);
        if (jt == it) {
          build_w<true>(w, cbt, lc, dts, vdt, jt * TILE, I0, lc0, lc1, 0.f, 0.f, r0, c);
        } else {
          const float lr = lc[jt * TILE + TILE - 1];  // a full tile: R < Qu
          build_w<false>(w, cbt, lc, dts, vdt, jt * TILE, I0, lc0, lc1, ex2(lc0 - lr),
                         ex2(lc1 - lr), r0, c);
        }
        release(empty, n);
        ++n;
        mma_xt<PT>(acc, w, xt_desc, jt);
      };
      if (intra_on)
        for (int jt = 0; jt <= it; ++jt) {
          intra(wa, jt);
          wgmma_wait<0>();
        }
      fence_regs(acc);
      if constexpr (SLICED) {
        // this slice's part of y in fp32, straight from the registers (D.x
        // in slice 0 only); rows past the unit and columns past P left out
        const long long rows = static_cast<long long>(gridDim.z / nsl) * nc * Q;
#pragma unroll
        for (int j = 0; j < ND / 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int I = q ? I1 : I0, p = 8 * j + 2 * c;
            if (I < Qu && p < pv) {
              float v0 = acc[4 * j + 2 * q], v1 = acc[4 * j + 2 * q + 1];
              if (intra_on) {
                v0 += d_h * lds(xt, swz(p, I, PT));
                v1 += d_h * lds(xt, swz(p + 1, I, PT));
              }
              *reinterpret_cast<float2*>(
                  yp + ((slice * rows + row0 + I) * H + h) * P + p0 + p) = make_float2(v0, v1);
            }
          }
        continue;
      }
      // epilogue: + D.x in fp32, one cast, staged in shared memory in the
      // swizzle of y's tensor map. One thread stores the tile by TMA (rows
      // past Q and columns past P lie outside the map and are not written);
      // where a row of y is not 16-byte aligned (P % 8 != 0) the warpgroup
      // stores it instead, 8 bytes a thread
      if (y_tma && wtid == 0) tma_store_wait_read<0>();  // the last tile is out
      warpgroup_sync(wg);
#pragma unroll
      for (int j = 0; j < ND / 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int I = q ? I1 : I0, p = 8 * j + 2 * c;
          const float v0 = acc[4 * j + 2 * q] + d_h * lds(xt, swz(p, I, PT));
          const float v1 = acc[4 * j + 2 * q + 1] + d_h * lds(xt, swz(p + 1, I, PT));
          *reinterpret_cast<uint32_t*>(ys + yswz<PT>((r0 + 8 * q) * PT * 2 + 2 * p)) =
              pack2<T>(v0, v1);
        }
      if (y_tma) {
        fence_async_smem();
        warpgroup_sync(wg);
        if (wtid == 0) {
          tma_store_4d(&ty, ys, p0, h, s0 + i0, bc);
          tma_store_commit();
        }
      } else {
        warpgroup_sync(wg);
        const int q4 = pv / 4, rows = min(TILE, Qu - i0);
        for (int e = wtid; e < rows * q4; e += WG) {
          const int r = e / q4, q = e % q4;
          *reinterpret_cast<uint2*>(y + ((row0 + i0 + r) * H + h) * P + p0 + 4 * q) =
              *reinterpret_cast<const uint2*>(ys + yswz<PT>(r * PT * 2 + 8 * q));
        }
      }
    }

    // ---- state: h * 2^lc_last + (B o scl)^T [n][j] . x^T [p][j] ---------
    if (has_state) {
      const float decay = ex2(lc_last);
      uint32_t wa[8][4];
#pragma unroll
      for (int m = 0; m < MW; ++m) {
#pragma unroll
        for (int i = 0; i < ND; ++i) hacc[m][i] *= decay;
        for (int jt = 0; jt < nt; ++jt) {
          build_bd(wa, consume(ring, full, n), scl, jt * TILE, nb + TILE * m, Ns, r0, c);
          release(empty, n);
          ++n;
          mma_xt<PT>(hacc[m], wa, xt_desc, jt);
          wgmma_wait<0>();
        }
        fence_regs(hacc[m]);
      }
    }
  }

  if (y_tma && wtid == 0) tma_store_wait<0>();
  // h_last (b, H, N, P) from this warpgroup's state rows
  if (has_state)
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int j = 0; j < ND / 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int nr = nb + TILE * m + r0 + 8 * q, p = 8 * j + 2 * c;
          if (nr < Ns && p < pv)
            *reinterpret_cast<float2*>(
                h_last + ((static_cast<long long>(b) * H + h) * N + n0 + nr) * P + p0 + p) =
                make_float2(hacc[m][4 * j + 2 * q], hacc[m][4 * j + 2 * q + 1]);
        }
}

// ---- y from its slices ------------------------------------------------------
// N over 256: y = the sum of the slices' fp32 parts, slice 0 first, in one
// fixed order (no atomics: the result does not depend on which block ran
// first), cast once to x's type.
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __half from_f32(float v, __half*) { return __float2half_rn(v); }

template <typename T>
__global__ void __launch_bounds__(256)
ssd_sum_slices_kernel(const float* __restrict__ yp, T* __restrict__ y, long long n, int nsl) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += gridDim.x * 256LL) {
    float v = yp[i];
    for (int s = 1; s < nsl; ++s) v += yp[s * n + i];
    y[i] = from_f32(v, static_cast<T*>(nullptr));
  }
}

// sets a kernel's dynamic shared-memory limit once per device, not on every
// launch (one flag per kernel)
template <typename Kernel>
cudaError_t smem_limit_once(Kernel kern, int bytes, std::atomic<int>& set_on) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && set_on.load() != dev) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) set_on.store(dev);
  }
  return err;
}

template <typename T, int PT, int NA>
int launch(const void* x, const void* dt, const void* B, const void* C, const void* la,
           const void* D, void* y, void* h_last, void* cb, void* yp, int b, int nc, int Q,
           int H, int P, int N, cudaStream_t stream) {
  // slices of N, a block each (their parts of y in yp where there are two
  // or more); units of at most QMAX steps a chunk; C.B^T of each in (QT, QT)
  // tiles
  const int nsl = (N + NSLICE - 1) / NSLICE;
  const int nsub = (Q + QMAX - 1) / QMAX;
  const int QT = min((Q + TILE - 1) / TILE * TILE, QMAX);
  const uint64_t bnc = static_cast<uint64_t>(b) * nc, q = Q, n = N, qt = QT;
  CUtensorMap tc, tb, tcb;
  // B, C (b*nc, Q, N) and CB (b*nc*nsub, QT, QT), fp32: boxes of 64 rows x
  // 32 columns (128 bytes, 128-byte swizzle); rows past Q and columns past N
  // arrive as zeros
  int err = make_tensor_map<3>(&tc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, C, {n, q, bnc},
                               {n * 4, q * n * 4}, {32, TILE, 1});
  if (!err)
    err = make_tensor_map<3>(&tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, B, {n, q, bnc},
                             {n * 4, q * n * 4}, {32, TILE, 1});
  if (!err)
    err = make_tensor_map<3>(&tcb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cb,
                             {qt, qt, bnc * nsub}, {qt * 4, qt * qt * 4}, {32, TILE, 1});
  // y (b*nc, Q, H, P) in x's type for the TMA store of y tiles, where its
  // rows are 16-byte aligned
  CUtensorMap ty{};
  const int y_tma = nsl == 1 && P % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const uint64_t h_ = H, p_ = P;
  if (!err && y_tma)
    err = make_tensor_map<4>(&ty, is_f16<T>, y, {p_, h_, q, bnc},
                             {p_ * 2, h_ * p_ * 2, q * h_ * p_ * 2}, {PT, 1, TILE, 1});
  if (err) return err;
  constexpr int SMEM = ScanLayout<PT, NA>::SMEM;
  static_assert(SMEM <= 227 * 1024, "shared memory of a block");
  const int ntq = QT / TILE;
  const dim3 cb_grid(ntq * (ntq + 1) / 2, b * nc * nsub);
  const dim3 grid((P + PT - 1) / PT, H, b * nsl);
  cudaError_t ce;
  if (nsl == 1) {
    static std::atomic<int> cb_set_on{-1}, scan_set_on{-1};
    auto cbk = ssd_cb_kernel<NA>;
    auto scan = ssd_scan_sm90_kernel<T, PT, NA, false>;
    ce = smem_limit_once(cbk, CB_SMEM<NA>, cb_set_on);
    if (ce == cudaSuccess) ce = smem_limit_once(scan, SMEM, scan_set_on);
    if (ce != cudaSuccess) return ce;
    cbk<<<cb_grid, WG, CB_SMEM<NA>, stream>>>(tc, tb, static_cast<float*>(cb), QT, nsub);
    ce = cudaGetLastError();
    if (ce != cudaSuccess) return ce;
    scan<<<grid, NTHREADS, SMEM, stream>>>(
        tc, tb, tcb, ty, y_tma, static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(la), static_cast<const float*>(D), static_cast<T*>(y),
        static_cast<float*>(h_last), nullptr, 1, nc, Q, H, P, N);
    return cudaGetLastError();
  }
  if constexpr (NA == NSLICE / 32) {
    static std::atomic<int> cb_set_on{-1}, scan_set_on{-1};
    auto scan = ssd_scan_sm90_kernel<T, PT, NA, true>;
    ce = smem_limit_once(ssd_cb_exact_kernel, CB_EXACT_SMEM, cb_set_on);
    if (ce == cudaSuccess) ce = smem_limit_once(scan, SMEM, scan_set_on);
    if (ce != cudaSuccess) return ce;
    ssd_cb_exact_kernel<<<cb_grid, WG, CB_EXACT_SMEM, stream>>>(
        tc, tb, static_cast<float*>(cb), QT, nsub, nsl);
    ce = cudaGetLastError();
    if (ce != cudaSuccess) return ce;
    float* parts = static_cast<float*>(yp);
    scan<<<grid, NTHREADS, SMEM, stream>>>(
        tc, tb, tcb, ty, y_tma, static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(la), static_cast<const float*>(D), static_cast<T*>(y),
        static_cast<float*>(h_last), parts, nsl, nc, Q, H, P, N);
    ce = cudaGetLastError();
    if (ce != cudaSuccess) return ce;
    const long long n_y = static_cast<long long>(b) * nc * Q * H * P;
    const long long want = (n_y + 255) / 256;
    const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
    ssd_sum_slices_kernel<T><<<blocks, 256, 0, stream>>>(parts, static_cast<T*>(y), n_y, nsl);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;  // slices take 8 atoms (dispatch sends N > 128 there)
}

template <typename T, int PT>
int by_state(const void* x, const void* dt, const void* B, const void* C, const void* la,
             const void* D, void* y, void* h_last, void* cb, void* yp, int b, int nc, int Q,
             int H, int P, int N, cudaStream_t st) {
  // 32-column atoms of a B or C tile: 1, 2 or 4 (N in (64, 96] loads an
  // atom of zeros)
  if (N <= 32) return launch<T, PT, 1>(x, dt, B, C, la, D, y, h_last, cb, yp, b, nc, Q, H,
                                       P, N, st);
  if (N <= 64) return launch<T, PT, 2>(x, dt, B, C, la, D, y, h_last, cb, yp, b, nc, Q, H,
                                       P, N, st);
  return launch<T, PT, 4>(x, dt, B, C, la, D, y, h_last, cb, yp, b, nc, Q, H, P, N, st);
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* B, const void* C, const void* la,
             const void* D, void* y, void* h_last, void* cb, void* yp, int b, int nc, int Q,
             int H, int P, int N, cudaStream_t st) {
  // N > 128: 8 atoms (a slice of 256 a block past 256), and P-tiles of 32
  // so that shared memory fits
  if (N > 128) return launch<T, 32, 8>(x, dt, B, C, la, D, y, h_last, cb, yp, b, nc, Q, H,
                                       P, N, st);
  if (P <= 32) return by_state<T, 32>(x, dt, B, C, la, D, y, h_last, cb, yp, b, nc, Q, H,
                                      P, N, st);
  return by_state<T, 64>(x, dt, B, C, la, D, y, h_last, cb, yp, b, nc, Q, H, P, N, st);
}

}  // namespace

// x (b,nc,Q,H,P) and y (b,nc*Q,H,P) in bf16 (is_f16 = 0) or fp16 (is_f16 =
// 1); dt, la (b,nc,Q,H), B, C (b,nc,Q,N), D (H,) and h_last (b,H,N,P) fp32;
// cb an fp32 scratch buffer of b*nc*nsub*QT*QT elements, nsub = ceil(Q /
// 256) and QT = min(Q rounded up to 64, 256); yp an fp32 scratch buffer of
// nsl*b*nc*Q*H*P elements, nsl = ceil(N / 256), where N > 256 (else
// unused, may be null). All contiguous; B, C and cb 16-byte aligned (TMA),
// x 8-byte aligned (cp.async). Q >= 1; N a multiple of 4; P a multiple of 4.
extern "C" int ssd_fwd_sm90(const void* x, const void* dt, const void* B, const void* C,
                            const void* la, const void* D, void* y, void* h_last, void* cb,
                            void* yp, int b, int nc, int Q, int H, int P, int N, int is_f16,
                            void* stream) {
  const bool ok = b > 0 && nc > 0 && Q >= 1 && H > 0 && N >= 4 && N % 4 == 0 && P >= 4 &&
                  P % 4 == 0 && (N <= NSLICE || yp != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f16) return dispatch<__half>(x, dt, B, C, la, D, y, h_last, cb, yp, b, nc, Q, H, P, N, st);
  return dispatch<__nv_bfloat16>(x, dt, B, C, la, D, y, h_last, cb, yp, b, nc, Q, H, P, N, st);
}
