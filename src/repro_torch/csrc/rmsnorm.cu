// K1: RMSNorm, and RMSNorm fused with the residual add before it, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py:24::
// rmsnorm_2d (body _rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) *
// scale by row, the mean in fp32, y rounded once to x's dtype.  The fused
// entry adds the residual first: s = x + r in fp32, rounded once to x's
// dtype (the bits torch.add gives), and y is the RMSNorm of that rounded
// s, as the unfused model normalises it.  Both s and y are written.
//
// What bounds it on the H100: bytes.  A row of d values takes about 4d
// flops against 4d bytes read and written (bf16; 8d for the fused entry),
// far below the 295 flops a byte at which the card turns compute-bound:
// at 4096 x 4096 bf16, 64 MB (0.0200 ms at 3.35 TB/s) for the norm and
// 128 MB (0.0400 ms) fused.  What the design does about it:
//  - every byte moves once: one block holds one row in registers, loaded
//    with 16-byte vectors (at d 4096, 256 threads x 2 vectors of 8 bf16, or
//    x 4 vectors of 4 fp32), so the second pass over the row, which
//    scales it, reads registers and not device memory, and the fused entry
//    never reads s back;
//  - the fused entry saves the residual stream's round trip: unfused, the
//    add reads x and r and writes s, and the norm reads s again;
//  - the sum of squares is fp32, each thread's in its own order, then
//    warp shuffles and one partial a warp in shared memory, always in the
//    same order: the result does not change between launches, which a
//    replayed CUDA graph and its eager step rely on to agree bit for bit;
//  - the scale (fp32 or bf16) is the same for every row and stays in L1;
//  - a decode step's few rows (fewer than the SMs: 8 or 32 at the served
//    cells) are latency-bound, not bytes-bound: there a row is cut one
//    16-byte vector a thread (512 threads at d 4096 bf16) and the scale is
//    loaded with the row, before the reduction.
// A row longer than the registers hold (d > 4 x 1024 vectors), or a row
// that is not 16-byte aligned or not a whole number of vectors, is staged
// in shared memory instead, one element a load: no main-path shape takes
// that path.
//
// The host (Python) side launches one entry for both functions: r == null
// is the plain norm.  Launches go on the caller's stream and are
// captured by a CUDA graph like any other.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int MAX_THREADS = 1024;
constexpr int TARGET_THREADS = 256;  // threads a row at the widths served
constexpr int MAX_VECTORS = 4;       // 16-byte vectors a thread holds
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* x;
  const void* r;  // null: the plain norm
  const void* scale;
  void* s;
  void* y;
  int d;
  float eps;
};

template <int B>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = uint32_t; };
template <>
struct Raw<2> { using type = uint16_t; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// V consecutive values of type W at p (aligned to their size, or to 16
// bytes), widened to fp32.
template <typename W, int V>
__device__ __forceinline__ void load_vec(const W* p, float (&out)[V]) {
  constexpr int BYTES = V * static_cast<int>(sizeof(W));
  constexpr int CH = BYTES < 16 ? BYTES : 16;
  using C = typename Raw<CH>::type;
  C raw[BYTES / CH];
#pragma unroll
  for (int i = 0; i < BYTES / CH; ++i) raw[i] = reinterpret_cast<const C*>(p)[i];
  const W* w = reinterpret_cast<const W*>(raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32(w[i]);
}

// V fp32 values rounded to T (to nearest, ties to even) and stored at p.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[V]) {
  constexpr int BYTES = V * static_cast<int>(sizeof(T));
  constexpr int CH = BYTES < 16 ? BYTES : 16;
  using C = typename Raw<CH>::type;
  C raw[BYTES / CH];
  T* t = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int i = 0; i < V; ++i) t[i] = repro::to_out<T>(in[i]);
#pragma unroll
  for (int i = 0; i < BYTES / CH; ++i) reinterpret_cast<C*>(p)[i] = raw[i];
}

// x + r in fp32, rounded once to T, returned as the fp32 value of that T.
template <typename T>
__device__ __forceinline__ float add_rounded(float a, float b) {
  return to_f32(repro::to_out<T>(__fadd_rn(a, b)));
}

// The block's sum of v: shuffles within each warp, then the warps' sums
// in warp order.  Every thread gets the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[MAX_THREADS / 32 + 1];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if (lane == 0) part[MAX_THREADS / 32] = v;
  }
  __syncthreads();
  return part[MAX_THREADS / 32];
}

// One row a block, R vectors of V values a thread in registers: vector c
// of the row is thread c % blockDim's number c / blockDim.  With one
// vector a thread (R == 1) the scale's loads go out with the row's, before
// the reduction; with more, registers are kept for the row.
template <typename T, typename W, int R, bool ADD>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_rows(Params p) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = p.d / V;
  const int64_t off = static_cast<int64_t>(blockIdx.x) * p.d;
  const T* x = static_cast<const T*>(p.x) + off;
  const W* scale = static_cast<const W*>(p.scale);
  float v[R][V], w[R == 1 ? V : 1];
  if constexpr (R == 1)
    if (threadIdx.x < nvec) load_vec<W, V>(scale + threadIdx.x * V, w);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      load_vec<T, V>(x + c * V, v[i]);
      if constexpr (ADD) {
        float rv[V];
        load_vec<T, V>(static_cast<const T*>(p.r) + off + c * V, rv);
#pragma unroll
        for (int e = 0; e < V; ++e) v[i][e] = add_rounded<T>(v[i][e], rv[e]);
        store_vec<T, V>(static_cast<T*>(p.s) + off + c * V, v[i]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(v[i][e], v[i][e], ss);
    }
  }
  const float inv = rsqrtf(block_sum(ss) / p.d + p.eps);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      float o[V];
      if constexpr (R == 1) {
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = w[e];
      } else {
        load_vec<W, V>(scale + c * V, o);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = v[i][e] * inv * o[e];
      store_vec<T, V>(static_cast<T*>(p.y) + off + c * V, o);
    }
  }
}

// Any d: one row a block, one value a load, staged in shared memory as
// fp32 (each thread reads back only what it wrote).
template <typename T, typename W, bool ADD>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_rows_smem(Params p) {
  extern __shared__ float row[];
  const int64_t off = static_cast<int64_t>(blockIdx.x) * p.d;
  const T* x = static_cast<const T*>(p.x) + off;
  float ss = 0.f;
  for (int c = threadIdx.x; c < p.d; c += blockDim.x) {
    float v = to_f32(x[c]);
    if constexpr (ADD) {
      v = add_rounded<T>(v, to_f32(static_cast<const T*>(p.r)[off + c]));
      static_cast<T*>(p.s)[off + c] = repro::to_out<T>(v);
    }
    row[c] = v;
    ss = fmaf(v, v, ss);
  }
  const float inv = rsqrtf(block_sum(ss) / p.d + p.eps);
  for (int c = threadIdx.x; c < p.d; c += blockDim.x)
    static_cast<T*>(p.y)[off + c] = repro::to_out<T>(
        row[c] * inv * to_f32(static_cast<const W*>(p.scale)[c]));
}

int round_up32(int n) { return (n + 31) / 32 * 32; }

// The card's SMs, read once.
int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 1;
  }
  return sms;
}

template <typename T, typename W, bool ADD>
cudaError_t launch(const Params& p, int n, bool aligned, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = p.d / V;
  if (aligned && p.d % V == 0 && nvec <= MAX_VECTORS * MAX_THREADS) {
    // fewer rows than SMs (a decode step): one vector a thread, so each
    // row's latency chain is as short as it gets; else about
    // TARGET_THREADS threads a row, which keeps 8 blocks on an SM
    const int r = nvec <= TARGET_THREADS || (n < sm_count() && nvec <= MAX_THREADS)
                      ? 1
                      : nvec <= 2 * TARGET_THREADS ? 2 : 4;
    const int threads = round_up32((nvec + r - 1) / r);
    switch (r) {
      case 1: rmsnorm_rows<T, W, 1, ADD><<<n, threads, 0, st>>>(p); break;
      case 2: rmsnorm_rows<T, W, 2, ADD><<<n, threads, 0, st>>>(p); break;
      default: rmsnorm_rows<T, W, 4, ADD><<<n, threads, 0, st>>>(p); break;
    }
    return cudaGetLastError();
  }
  const size_t smem = static_cast<size_t>(p.d) * sizeof(float);
  static int configured = 48 * 1024;  // bytes allowed so far
  if (smem > static_cast<size_t>(configured)) {
    cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_rows_smem<T, W, ADD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = static_cast<int>(smem);
  }
  const int threads = round_up32(p.d < MAX_THREADS ? p.d : MAX_THREADS);
  rmsnorm_rows_smem<T, W, ADD><<<n, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t dispatch(const Params& p, int n, bool aligned, cudaStream_t st) {
  return p.r ? launch<T, W, true>(p, n, aligned, st)
             : launch<T, W, false>(p, n, aligned, st);
}

}  // namespace

// dtype, scale_dtype: 0 = float32, 1 = bfloat16.  x, r, s, y: contiguous
// (n, d) of dtype; scale: (d,) of scale_dtype.  r == null: y = RMSNorm(x)
// and s is not written.  Otherwise s = x + r rounded to dtype and y =
// RMSNorm(s).  Returns a cudaError_t.
extern "C" int rmsnorm_fwd(const void* x, const void* r, const void* scale,
                           void* s, void* y, int dtype, int scale_dtype,
                           int n, int d, float eps, void* stream) {
  if (n < 1 || d < 1 || (r && !s)) return cudaErrorInvalidValue;
  const Params p{x, r, scale, s, y, d, eps};
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(s) |
                         reinterpret_cast<uintptr_t>(y);
  const bool aligned = bits % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && scale_dtype == 0) return dispatch<float, float>(p, n, aligned, st);
  if (dtype == 0 && scale_dtype == 1) return dispatch<float, bf16>(p, n, aligned, st);
  if (dtype == 1 && scale_dtype == 0) return dispatch<bf16, float>(p, n, aligned, st);
  if (dtype == 1 && scale_dtype == 1) return dispatch<bf16, bf16>(p, n, aligned, st);
  return cudaErrorInvalidValue;
}
