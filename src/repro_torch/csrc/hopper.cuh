// Hopper (sm_90a) building blocks shared by K2's forward
// (flash_attention.cu) and its backward (flash_attention_bwd.cu): mbarriers,
// TMA loads of 64-row panels and the tensor maps that describe them, and
// the warpgroup products (wgmma) that read those panels.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// mbarriers (PTX ISA): a phase completes when its arrivals and, for a
// TMA load, its expected bytes are all in; waits name the phase's parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Where the row, head and batch coordinates go among a tensor map's
// dimensions 1..3 (the host orders them by stride).
struct Slots {
  int row, head, batch;
};

// One TMA box (a panel of 64 rows), at column c0, into shared memory;
// completion is counted on `bar`.  Rows past the tensor's end arrive as
// zeros and are never read.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int row,
                                         int head, int batch, Slots sl) {
  const int x1 = sl.row == 1 ? row : sl.head == 1 ? head : batch;
  const int x2 = sl.row == 2 ? row : sl.head == 2 ? head : batch;
  const int x3 = sl.row == 3 ? row : sl.head == 3 ? head : batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(x1), "r"(x2), "r"(x3)
      : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x, ex2.approx
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------- wgmma --

// Tiles live in shared memory as TMA writes them with its swizzle of RB
// = min(2 Dh, 128) bytes: panels of RB / 2 columns, each rows x RB bytes,
// whose 16-byte chunks are XOR-permuted within each group of 8 rows (so
// wgmma's reads of 8 rows hit 8 distinct bank groups).  wgmma reads the
// same pattern through its descriptor: layout type 1, 2 or 3 for a swizzle
// of 128, 64 or 32 bytes, rows RB apart, 8-row groups 8 RB apart (sbo), and
// for a MN-major operand the next panel lbo bytes on.
template <int DH>
struct Swz {
  static constexpr int RB = DH * 2 < 128 ? DH * 2 : 128;  // row bytes
  static constexpr int PANELS = DH * 2 / RB;
  static constexpr uint64_t TYPE = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle TMA =
      RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
};

// One 64-row tile (all its panels) at row `row` into shared memory.
template <int DH>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row, int head,
                                         int batch, Slots sl) {
  constexpr int RB = Swz<DH>::RB, PANEL = 64 * RB / 2;
  for (int pn = 0; pn < Swz<DH>::PANELS; ++pn)
    tma_load(dst + pn * PANEL, map, bar, pn * RB / 2, row, head, batch, sl);
}

// The first 1024-byte boundary in dynamic shared memory, found by pointer
// arithmetic on `smem` (not through an integer), so that loads and stores
// through it stay shared-memory instructions.
__device__ __forceinline__ __nv_bfloat16* align1024(float4* smem) {
  char* base = reinterpret_cast<char*>(smem);
  const uint32_t pad = (1024 - (smem_addr(base) & 1023)) & 1023;
  return reinterpret_cast<__nv_bfloat16*>(base + pad);
}

// Warp specialisation: a warpgroup gives up registers (the producer) or
// takes them (a consumer) after launch; every warp of it executes this.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int DH>
__device__ __forceinline__ uint64_t wg_desc(const void* ptr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(ptr) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (Swz<DH>::TYPE << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of the warpgroup's committed groups are pending.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers that an asynchronous wgmma writes are read only after its
// wait: this empty asm ties each read to the point after the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// a (64 x 16) * b (16 x 64), both K-major in shared memory: NAME(d, da,
// db) sets d to it with OUT "=f" and SCALE_D 0, adds it to d with "+f"
// and 1.  The first step has its own wrapper: with "+f" it would read the
// last tile's scores, keeping them live across the loop (24 B spilled).
#define WGMMA_SS_N64(NAME, OUT, SCALE_D)                                    \
  __device__ __forceinline__ void NAME(float (&d)[32], uint64_t da,        \
                                       uint64_t db) {                      \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"           \
        "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
        "%24, %25, %26, %27, %28, %29, %30, %31"                           \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                 \
        : OUT(d[0]), OUT(d[1]), OUT(d[2]), OUT(d[3]),                      \
          OUT(d[4]), OUT(d[5]), OUT(d[6]), OUT(d[7]),                      \
          OUT(d[8]), OUT(d[9]), OUT(d[10]), OUT(d[11]),                    \
          OUT(d[12]), OUT(d[13]), OUT(d[14]), OUT(d[15]),                  \
          OUT(d[16]), OUT(d[17]), OUT(d[18]), OUT(d[19]),                  \
          OUT(d[20]), OUT(d[21]), OUT(d[22]), OUT(d[23]),                  \
          OUT(d[24]), OUT(d[25]), OUT(d[26]), OUT(d[27]),                  \
          OUT(d[28]), OUT(d[29]), OUT(d[30]), OUT(d[31])                   \
        : "l"(da), "l"(db), "r"(SCALE_D));                                 \
  }
#define WGMMA_SET(x) "=f"(x)
#define WGMMA_ADD(x) "+f"(x)
WGMMA_SS_N64(wgmma_ss_n64_first, WGMMA_SET, 0)
WGMMA_SS_N64(wgmma_ss_n64, WGMMA_ADD, 1)
#undef WGMMA_SET
#undef WGMMA_ADD
#undef WGMMA_SS_N64

// a (64 x 16, registers) * b (16 x 64, K-major in shared memory): NAME(d,
// a, db) sets d to it (OUT "=f", SCALE_D 0) or adds it to d ("+f", 1).
#define WGMMA_RS_N64_KMAJOR(NAME, OUT, SCALE_D)                             \
  __device__ __forceinline__ void NAME(float (&d)[32],                     \
                                       const uint32_t (&a)[4],             \
                                       uint64_t db) {                      \
    asm volatile(                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"           \
        "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
        "%24, %25, %26, %27, %28, %29, %30, %31"                           \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"                    \
        : OUT(d[0]), OUT(d[1]), OUT(d[2]), OUT(d[3]),                      \
          OUT(d[4]), OUT(d[5]), OUT(d[6]), OUT(d[7]),                      \
          OUT(d[8]), OUT(d[9]), OUT(d[10]), OUT(d[11]),                    \
          OUT(d[12]), OUT(d[13]), OUT(d[14]), OUT(d[15]),                  \
          OUT(d[16]), OUT(d[17]), OUT(d[18]), OUT(d[19]),                  \
          OUT(d[20]), OUT(d[21]), OUT(d[22]), OUT(d[23]),                  \
          OUT(d[24]), OUT(d[25]), OUT(d[26]), OUT(d[27]),                  \
          OUT(d[28]), OUT(d[29]), OUT(d[30]), OUT(d[31])                   \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),             \
          "r"(SCALE_D));                                                   \
  }
#define WGMMA_SET(x) "=f"(x)
#define WGMMA_ADD(x) "+f"(x)
WGMMA_RS_N64_KMAJOR(wgmma_rs_n64_first, WGMMA_SET, 0)
WGMMA_RS_N64_KMAJOR(wgmma_rs_n64, WGMMA_ADD, 1)
#undef WGMMA_SET
#undef WGMMA_ADD
#undef WGMMA_RS_N64_KMAJOR

// Four 8 x 8 bf16 matrices from shared memory, one a register: lane l
// gives the address of row l % 8 of matrix l / 8 (mma.m16n8k16's A
// fragment when the matrices are rows 0-7 and 8-15 of k 0-7, then of k
// 8-15).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (64 x 16, registers) * b (16 x N, MN-major in shared memory).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -------------------------------------------------------- tensor maps --

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that the
// library needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A TMA map of a bf16 (batch, rows, heads, DH) view with element strides,
// read in swizzled panels of 64 rows.  Dimensions 1..3 go in order of
// stride; `slots` says where each landed.
template <int DH>
cudaError_t make_map(CUtensorMap* map, Slots* slots, const void* base,
                     int rows, int heads, int batch, int64_t s_row,
                     int64_t s_head, int64_t s_batch) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  struct Dim {
    int64_t size, stride;
    int* slot;
  } d[3] = {{rows, s_row, &slots->row},
            {heads, s_head, &slots->head},
            {batch, s_batch, &slots->batch}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j + 1 < 3 - i; ++j)
      if (d[j].stride > d[j + 1].stride) {
        const Dim x = d[j];
        d[j] = d[j + 1];
        d[j + 1] = x;
      }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH)};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {Swz<DH>::RB / 2}, unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = d[i].size;
    strides[i] = d[i].stride * sizeof(__nv_bfloat16);
    box[i + 1] = d[i].slot == &slots->row ? 64 : 1;
    *d[i].slot = i + 1;
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, Swz<DH>::TMA,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace repro
