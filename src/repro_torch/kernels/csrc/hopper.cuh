// Building blocks shared by the port's Hopper (sm_90a) kernels, as inline PTX:
//   - mbarriers: init, arrive, arrive with an expected byte count, wait on a
//     phase parity;
//   - TMA tile loads (2-D, 3-D, 4-D) that complete on an mbarrier, 4-D tile
//     stores, and the host side that encodes their tensor maps;
//   - the wgmma shared-memory matrix descriptor (32B, 64B, 128B swizzle);
//   - wgmma fence / commit_group / wait_group;
//   - wgmma.mma_async m64nNk16 (N = 32, 64, 80, 96, 128, 256), bf16 or f16 inputs, fp32
//     accumulator, A from shared memory (ss) or from registers (rs);
//   - wgmma.mma_async m64nNk8 (N = 32, 64, 128), tf32 inputs (raw fp32 in
//     shared memory or registers), fp32 accumulator, ss or rs;
//   - the proxy fence between threads' shared-memory stores and wgmma.
//
// The tensor map encoder, cuTensorMapEncodeTiled, lives in libcuda. It is
// looked up at run time through the CUDA runtime's entry-point query, so a
// library that includes this header links against the runtime only (no
// -lcuda).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda.h>  // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace hopper {

template <typename T>
inline constexpr bool is_f16 = std::is_same_v<T, __half>;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------
// A barrier completes a phase when its arrival count is reached and every
// byte announced with arrive_expect_tx has landed; wait(parity) returns once
// the phase of that parity has completed. A fresh barrier is in phase 0, so
// wait(1) on it returns at once.

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes initialised barriers visible to the other threads and to TMA; call
// once after the inits, before a __syncthreads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ---- TMA --------------------------------------------------------------------
// One thread copies a box of the tensor that `map` describes, at the given
// coordinates (innermost first), into shared memory; the bytes count against
// `bar`. Rows outside the tensor are filled with zeros.

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The reverse: one thread copies a box from shared memory to the tensor;
// elements outside the tensor are not written. commit / wait as a bulk group:
// tma_store_wait_read<0>() returns once the box has been read out of shared
// memory (it may be overwritten), tma_store_wait<0>() once it is written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- wgmma shared-memory descriptor -----------------------------------------
// Bits 0-13 the start address >> 4, 16-29 the leading byte offset >> 4,
// 32-45 the stride byte offset >> 4, 62-63 the swizzle mode. A tile written
// by TMA with swizzle S (rows of S bytes, 8-row groups of 8*S bytes, the
// 16-byte chunks of each row permuted by the row's place in its group) is
// read with the same mode; its base must be aligned to 8*S bytes.
//   K-major operand (K contiguous in each row of S bytes): SBO = 8*S, the
//     step between 8-row groups; LBO is not used. The k-th step of 16
//     elements starts 32*k bytes further on, inside the swizzled row.
//   MN-major operand (M or N contiguous): SBO = 8*S, the step between groups
//     of 8 K-rows; LBO = the step between blocks of S bytes along M or N.
enum class Swizzle : uint32_t { B128 = 1, B64 = 2, B32 = 3 };

__host__ __device__ constexpr Swizzle swizzle_for_row_bytes(int row_bytes) {
  return row_bytes == 128 ? Swizzle::B128 : row_bytes == 64 ? Swizzle::B64 : Swizzle::B32;
}

__device__ __forceinline__ uint64_t make_desc(const void* tile, uint32_t lbo,
                                              uint32_t sbo, Swizzle swz) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swz) << 62);
}

// the same descriptor, `bytes` (a multiple of 16) further into shared memory
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// ---- wgmma ordering ---------------------------------------------------------

// after this thread's st.shared to a tile that a wgmma (or TMA) reads next:
// orders the generic-proxy stores before the async proxy's reads. Every
// writing thread calls it, then the threads meet at a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// before the first wgmma that reads registers or shared memory written since
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of these registers across
// the start or the wait of a wgmma (the asm that defines them is
// asynchronous)
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// ---- wgmma.mma_async m64nNk16, fp32 accumulator -----------------------------
// Accumulator layout (thread t of the warpgroup, warp w = t / 32, lane
// l = t % 32): d[4j + e] is row 16w + l/4, column 8j + 2(l%4) + e, and
// d[4j + 2 + e] the same column of row 16w + l/4 + 8 (e = 0, 1). A from
// registers takes the same layout for its 64 x 16 tile, two 16-bit values a
// register: a[0] = (row, k 2(l%4)+{0,1}), a[1] = (row + 8, same k),
// a[2] = (row, k 8+2(l%4)+{0,1}), a[3] = (row + 8, same k).
// `accumulate` = 0 overwrites d. TRANS_A / TRANS_B = 1 reads that operand
// MN-major (only 16-bit types allow it).

#define HOPPER_D16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_OUT16(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HOPPER_D32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_OUT32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_D40 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39"
#define HOPPER_OUT40(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define HOPPER_D48 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47"
#define HOPPER_OUT48(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
#define HOPPER_D64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_D128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"
#define HOPPER_OUT128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
  "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

#define HOPPER_WGMMA_SS(N, TY, D, OUT, ACC, REST)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" ACC ", 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" D \
               "}, " REST ";\n}\n"                                                 \
               : OUT(d)                                                            \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B))

#define HOPPER_WGMMA_RS(N, TY, D, OUT, ACC, REST)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" ACC ", 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" D \
               "}, " REST ";\n}\n"                                                 \
               : OUT(d)                                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),          \
                 "r"(accumulate), "n"(TRANS_B))

template <int N>
struct Mma;

// Operands after the N/2 outputs: ss: desc_a, desc_b, accumulate, TRANS_A,
// TRANS_B; rs: a[0..3], desc_b, accumulate, TRANS_B.
#define HOPPER_MMA(N, ND, SS_ACC, SS_REST, RS_ACC, RS_REST)                          \
  template <>                                                                        \
  struct Mma<N> {                                                                    \
    template <typename T, int TRANS_A, int TRANS_B>                                  \
    static __device__ __forceinline__ void ss(float (&d)[ND], uint64_t desc_a,      \
                                              uint64_t desc_b, int accumulate) {    \
      if constexpr (is_f16<T>)                                                       \
        HOPPER_WGMMA_SS(N, "f16", HOPPER_D##ND, HOPPER_OUT##ND, SS_ACC, SS_REST);    \
      else                                                                           \
        HOPPER_WGMMA_SS(N, "bf16", HOPPER_D##ND, HOPPER_OUT##ND, SS_ACC, SS_REST);   \
    }                                                                                \
    template <typename T, int TRANS_B>                                               \
    static __device__ __forceinline__ void rs(float (&d)[ND], const uint32_t (&a)[4], \
                                              uint64_t desc_b, int accumulate) {    \
      if constexpr (is_f16<T>)                                                       \
        HOPPER_WGMMA_RS(N, "f16", HOPPER_D##ND, HOPPER_OUT##ND, RS_ACC, RS_REST);    \
      else                                                                           \
        HOPPER_WGMMA_RS(N, "bf16", HOPPER_D##ND, HOPPER_OUT##ND, RS_ACC, RS_REST);   \
    }                                                                                \
  };

HOPPER_MMA(32, 16, "18", "%16, %17, p, 1, 1, %19, %20",
           "21", "{%16, %17, %18, %19}, %20, p, 1, 1, %22")
HOPPER_MMA(64, 32, "34", "%32, %33, p, 1, 1, %35, %36",
           "37", "{%32, %33, %34, %35}, %36, p, 1, 1, %38")
HOPPER_MMA(80, 40, "42", "%40, %41, p, 1, 1, %43, %44",
           "45", "{%40, %41, %42, %43}, %44, p, 1, 1, %46")
HOPPER_MMA(96, 48, "50", "%48, %49, p, 1, 1, %51, %52",
           "53", "{%48, %49, %50, %51}, %52, p, 1, 1, %54")
HOPPER_MMA(128, 64, "66", "%64, %65, p, 1, 1, %67, %68",
           "69", "{%64, %65, %66, %67}, %68, p, 1, 1, %70")
HOPPER_MMA(256, 128, "130", "%128, %129, p, 1, 1, %131, %132",
           "133", "{%128, %129, %130, %131}, %132, p, 1, 1, %134")

#undef HOPPER_MMA
#undef HOPPER_WGMMA_SS
#undef HOPPER_WGMMA_RS

// ---- wgmma.mma_async m64nNk8, tf32 inputs, fp32 accumulator -----------------
// The tensor cores read each fp32 operand as tf32: its 10 high mantissa bits,
// the low 13 ignored (truncated). Both operands are K-major only (the
// transpose bits exist for 16-bit types alone): the summed index must be
// contiguous in every shared-memory tile; one k8 step is 32 bytes of a row.
// The accumulator layout is that of m64nNk16 above. A from registers is NOT
// that layout: for the 64 x 8 tile, thread t (warp w, lane l, g = l / 4,
// c = l % 4) holds a[0] = (row 16w + g, k c), a[1] = (row 16w + g + 8, k c),
// a[2] = (row 16w + g, k c + 4), a[3] = (row 16w + g + 8, k c + 4), each the
// raw fp32 bits (CuTe's GMMA::ALayout_64x8).

template <int N>
struct MmaTf32;

#define HOPPER_MMA_TF32(N, ND, SS_ACC, SS_REST, RS_ACC, RS_REST)                      \
  template <>                                                                        \
  struct MmaTf32<N> {                                                                \
    static __device__ __forceinline__ void ss(float (&d)[ND], uint64_t desc_a,      \
                                              uint64_t desc_b, int accumulate) {    \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" SS_ACC ", 0;\n"            \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {"       \
                   HOPPER_D##ND "}, " SS_REST ";\n}\n"                              \
                   : HOPPER_OUT##ND(d)                                               \
                   : "l"(desc_a), "l"(desc_b), "r"(accumulate));                     \
    }                                                                                \
    static __device__ __forceinline__ void rs(float (&d)[ND], const uint32_t (&a)[4], \
                                              uint64_t desc_b, int accumulate) {    \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" RS_ACC ", 0;\n"            \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {"       \
                   HOPPER_D##ND "}, " RS_REST ";\n}\n"                              \
                   : HOPPER_OUT##ND(d)                                               \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),        \
                     "r"(accumulate));                                               \
    }                                                                                \
  };

// Operands after the N/2 outputs: ss: desc_a, desc_b, accumulate; rs:
// a[0..3], desc_b, accumulate.
HOPPER_MMA_TF32(32, 16, "18", "%16, %17, p, 1, 1",
                "21", "{%16, %17, %18, %19}, %20, p, 1, 1")
HOPPER_MMA_TF32(64, 32, "34", "%32, %33, p, 1, 1",
                "37", "{%32, %33, %34, %35}, %36, p, 1, 1")
HOPPER_MMA_TF32(128, 64, "66", "%64, %65, p, 1, 1",
                "69", "{%64, %65, %66, %67}, %68, p, 1, 1")

#undef HOPPER_MMA_TF32

// two fp32 values as one register of two 16-bit values, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a dense RANK-d tensor of 16-bit (bf16, fp16) or 32-bit
// (fp32) elements: `dims` and `box` innermost first, `strides` the byte
// strides of dims 1..RANK-1 (each a multiple of 16). Rows of the box are
// `box[0]` elements (2 or 4 bytes each) and get the matching swizzle (128,
// 64 or 32 bytes). Out-of-range elements load as zeros. Returns 0 or
// cudaErrorInvalidValue.
template <int RANK>
inline int make_tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                           const uint64_t (&dims)[RANK], const uint64_t (&strides)[RANK - 1],
                           const uint32_t (&box)[RANK]) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  cuuint64_t d[RANK], s[RANK > 1 ? RANK - 1 : 1];
  cuuint32_t b[RANK], e[RANK];
  for (int i = 0; i < RANK; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i < RANK - 1) s[i] = strides[i];
  }
  const int elem_bytes = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const int row_bytes = static_cast<int>(box[0]) * elem_bytes;
  const CUtensorMapSwizzle swz = row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(map, type, RANK, const_cast<void*>(base), d, s, b, e,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// the same over 16-bit elements: fp16 if `f16`, else bf16
template <int RANK>
inline int make_tensor_map(CUtensorMap* map, bool f16, const void* base,
                           const uint64_t (&dims)[RANK], const uint64_t (&strides)[RANK - 1],
                           const uint32_t (&box)[RANK]) {
  return make_tensor_map<RANK>(
      map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base,
      dims, strides, box);
}

}  // namespace hopper
