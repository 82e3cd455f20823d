// Shared helpers of the attention kernels: dtype conversion and tile loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;  // the TPU kernels' mask value

__device__ __forceinline__ float from_float(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_float(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ T to_out(float x) {
  return from_float(x, static_cast<T*>(nullptr));
}

// One 16-byte load of 4 fp32 or 8 bf16 values, widened to fp32 in `dst`.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Copies rows [row0, row0 + rows) of a (*, DH) matrix whose rows lie
// `row_stride` elements apart into shared memory as fp32, `dst_stride`
// floats per row.  Rows at or past `n_valid` are never read: they are
// written as zeros, so a cache slot past the fill level, whatever bits it
// holds, cannot reach the result.  The caller guarantees 16-byte alignment
// of `base` and of `row_stride * sizeof(T)`.
template <typename T, int DH, int NT>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const T* base, int64_t row_stride,
                                          int row0, int n_valid, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DH / VEC;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += NT) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    float* d = dst + r * dst_stride + c;
    if (row0 + r < n_valid) {
      load16(base + static_cast<int64_t>(row0 + r) * row_stride + c, d);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = 0.f;
    }
  }
}

}  // namespace repro

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
