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
// The backward (rmsnorm_bwd, its own entry) replaces no TPU kernel: the
// reference trains through the jnp twin of rmsnorm_2d, which JAX
// differentiates, while the port's forward runs this kernel, so its
// gradient is a kernel too.  Given x (or the fused entry's stored sum s),
// dy and, for the fused entry, ds (the gradient reaching s through the
// residual stream), with rstd = rsqrt(mean(x^2) + eps), x_hat = x * rstd
// and g = dy * scale, it writes dx = rstd * (g - x_hat * mean(g * x_hat))
// (+ ds), rounded once to x's dtype, and dscale = sum over rows of dy *
// x_hat in fp32.  It is bound by bytes as the forward is (x, dy, dx and
// ds each move once: 6d bytes a bf16 row, 8d fused).  Rows go to groups
// of a power of two of threads (TPR, the row's 16-byte vectors rounded
// up, at most 256, each thread holding up to 4 vectors of x and dy in
// registers); a block of 256 threads holds 256 / TPR rows at once and
// walks the rows a grid-stride apart, so a block's share of dscale stays
// in registers across its rows.  Each group writes its dscale partial to
// a scratch row, and a second launch sums the partials column by column
// in a fixed order: no float atomics, so two runs give the same bits.
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

// ---------------------------------------------------------- backward --

constexpr int BWD_THREADS = 256;
constexpr int BWD_BLOCKS_PER_SM = 4;

struct BwdParams {
  const void* x;
  const void* scale;
  const void* dy;
  const void* ds;  // null: the plain norm
  void* dx;
  float* work;     // (gridDim.x * rows a block, d) dscale partials
  int64_t n;
  int d;
  int scale_bf16;
  float eps;
};

// The sums of a and b over the TPR threads of this thread's group (TPR a
// power of two; groups are aligned runs of TPR threads), in a fixed
// order; every thread of the group gets them.  Every thread of the block
// calls it.
template <int TPR>
__device__ __forceinline__ float2 group_sum2(float a, float b) {
  constexpr int W = TPR < 32 ? TPR : 32;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    a += __shfl_xor_sync(FULL, a, off);
    b += __shfl_xor_sync(FULL, b, off);
  }
  if constexpr (TPR > 32) {
    __shared__ float2 part[BWD_THREADS / 32];
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // the last call's partials are read
    if ((threadIdx.x & 31) == 0) part[warp] = make_float2(a, b);
    __syncthreads();
    const int first = warp / (TPR / 32) * (TPR / 32);
    a = b = 0.f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) {
      a += part[first + w].x;
      b += part[first + w].y;
    }
  }
  return make_float2(a, b);
}

// Rows in groups of TPR threads, R vectors of V values a thread: vector c
// of a row is the group's thread c % TPR's number c / TPR.
template <typename T, int TPR, int R>
__global__ void __launch_bounds__(BWD_THREADS) rmsnorm_bwd_rows(BwdParams p) {
  constexpr int V = 16 / sizeof(T);
  constexpr int RPB = BWD_THREADS / TPR;  // rows a block holds at once
  const int nvec = p.d / V;
  const int grp = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  float w[R][V], acc[R][V];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = lane + i * TPR;
#pragma unroll
    for (int e = 0; e < V; ++e) w[i][e] = acc[i][e] = 0.f;
    if (c < nvec) {
      if (p.scale_bf16)
        load_vec<bf16, V>(static_cast<const bf16*>(p.scale) + c * V, w[i]);
      else
        load_vec<float, V>(static_cast<const float*>(p.scale) + c * V, w[i]);
    }
  }
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * RPB; base < p.n;
       base += static_cast<int64_t>(gridDim.x) * RPB) {
    const int64_t row = base + grp;
    const int64_t off = row * p.d;
    float xv[R][V], dyv[R][V];
    float ss = 0.f, dot = 0.f;  // sum of x^2, sum of g * x
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = lane + i * TPR;
#pragma unroll
      for (int e = 0; e < V; ++e) xv[i][e] = dyv[i][e] = 0.f;
      if (row < p.n && c < nvec) {
        load_vec<T, V>(static_cast<const T*>(p.x) + off + c * V, xv[i]);
        load_vec<T, V>(static_cast<const T*>(p.dy) + off + c * V, dyv[i]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ss = fmaf(xv[i][e], xv[i][e], ss);
        dot = fmaf(dyv[i][e] * w[i][e], xv[i][e], dot);
      }
    }
    const float2 sums = group_sum2<TPR>(ss, dot);
    const float rstd = rsqrtf(sums.x / p.d + p.eps);
    const float c_mean = sums.y * rstd / p.d;  // mean(g * x_hat)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = lane + i * TPR;
      if (row < p.n && c < nvec) {
        float o[V], dsv[V];
        if (p.ds)
          load_vec<T, V>(static_cast<const T*>(p.ds) + off + c * V, dsv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xhat = xv[i][e] * rstd;
          o[e] = rstd * (dyv[i][e] * w[i][e] - xhat * c_mean);
          if (p.ds) o[e] += dsv[e];
          acc[i][e] = fmaf(dyv[i][e], xhat, acc[i][e]);
        }
        store_vec<T, V>(static_cast<T*>(p.dx) + off + c * V, o);
      }
    }
  }
  // this group's dscale partial, one scratch row
  float* part = p.work + (static_cast<int64_t>(blockIdx.x) * RPB + grp) * p.d;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = lane + i * TPR;
    if (c < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) part[c * V + e] = acc[i][e];
    }
  }
}

// dscale[col] = the sum over the `parts` scratch rows of column col: 32
// columns a block, 8 warps each summing every 8th row in order, then the
// 8 sums in order.
__global__ void __launch_bounds__(256)
    rmsnorm_bwd_reduce(const float* work, int parts, int d, float* dscale) {
  __shared__ float sums[8][33];
  const int col = blockIdx.x * 32 + (threadIdx.x & 31), slice = threadIdx.x >> 5;
  float a = 0.f;
  if (col < d)
    for (int r = slice; r < parts; r += 8)
      a += work[static_cast<int64_t>(r) * d + col];
  sums[slice][threadIdx.x & 31] = a;
  __syncthreads();
  if (slice == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int s = 0; s < 8; ++s) t += sums[s][threadIdx.x & 31];
    dscale[col] = t;
  }
}

// The row layout of the backward for d values of dtype: threads a row
// (TPR) and vectors a thread (R); false when the kernel does not take d.
bool bwd_layout(int d, int dtype, int* tpr, int* r) {
  const int v = dtype == 0 ? 4 : 8;
  if (d < 1 || d % v) return false;
  const int nvec = d / v;
  if (nvec > 4 * BWD_THREADS) return false;
  int t = 1;
  while (t < nvec && t < BWD_THREADS) t *= 2;
  *tpr = t;
  *r = (nvec + t - 1) / t;
  if (*r == 3) *r = 4;
  return true;
}

// Grid blocks of the backward over n rows of d values of dtype.
int bwd_blocks(int64_t n, int d, int dtype) {
  int tpr, r;
  if (!bwd_layout(d, dtype, &tpr, &r)) return 0;
  const int64_t rpb = BWD_THREADS / tpr;
  const int64_t want = (n + rpb - 1) / rpb;
  const int64_t most = static_cast<int64_t>(BWD_BLOCKS_PER_SM) * sm_count();
  return static_cast<int>(want < most ? want : most);
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, int blocks, cudaStream_t st) {
  int tpr, r;
  if (!bwd_layout(p.d, sizeof(T) == 4 ? 0 : 1, &tpr, &r))
    return cudaErrorInvalidValue;
#define REPRO_BWD(TPR, R)                                              \
  if (tpr == TPR && r == R) {                                          \
    rmsnorm_bwd_rows<T, TPR, R><<<blocks, BWD_THREADS, 0, st>>>(p);    \
    return cudaGetLastError();                                         \
  }
  REPRO_BWD(1, 1) REPRO_BWD(2, 1) REPRO_BWD(4, 1) REPRO_BWD(8, 1)
  REPRO_BWD(16, 1) REPRO_BWD(32, 1) REPRO_BWD(64, 1) REPRO_BWD(128, 1)
  REPRO_BWD(256, 1) REPRO_BWD(256, 2) REPRO_BWD(256, 4)
#undef REPRO_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// The scratch rows rmsnorm_bwd needs for n rows of d values of dtype (0 =
// float32, 1 = bfloat16): a (rows, d) float32 buffer; 0 when the kernel
// does not take rows of d values.
extern "C" int rmsnorm_bwd_partials(int n, int d, int dtype) {
  int tpr, r;
  if (n < 1 || !bwd_layout(d, dtype, &tpr, &r)) return 0;
  return bwd_blocks(n, d, dtype) * (BWD_THREADS / tpr);
}

// The backward of rmsnorm_fwd.  x (the norm's input, or the fused entry's
// sum s), dy, ds (null: the plain norm) and dx: contiguous (n, d) of
// dtype; scale: (d,) of scale_dtype; dscale: (d,) float32, written;
// work: (parts, d) float32 scratch, parts = rmsnorm_bwd_partials(n, d,
// dtype).  dx = rstd (dy scale - x_hat mean(dy scale x_hat)) (+ ds),
// dscale = sum over rows of dy x_hat.  Two launches on `stream`; returns
// a cudaError_t.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                           const void* ds, void* dx, float* dscale,
                           float* work, int dtype, int scale_dtype, int n,
                           int d, int parts, float eps, void* stream) {
  if (n < 1 || scale_dtype < 0 || scale_dtype > 1 ||
      parts != rmsnorm_bwd_partials(n, d, dtype))
    return cudaErrorInvalidValue;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(ds) |
                         reinterpret_cast<uintptr_t>(dx);
  if (bits % 16) return cudaErrorInvalidValue;
  const BwdParams p{x, scale, dy, ds, dx, work, n, d, scale_dtype, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = bwd_blocks(n, d, dtype);
  cudaError_t err = dtype == 0   ? launch_bwd<float>(p, blocks, st)
                    : dtype == 1 ? launch_bwd<bf16>(p, blocks, st)
                                 : cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_reduce<<<(d + 31) / 32, 256, 0, st>>>(work, parts, d, dscale);
  return cudaGetLastError();
}

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
