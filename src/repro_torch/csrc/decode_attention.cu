// Decode (one query token) attention for Hopper (sm_90a), grouped-query.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// decode_attention_grouped (body _decode_kernel).  Same function: the G
// query heads of one KV head attend to the cache positions t <= pos with
// an online softmax in fp32 (m, l, acc), mask value -1e30, l clamped at
// 1e-30.  Same decomposition: one block per (batch, KV head) holds its G
// query rows and walks the cache in tiles of 64 positions up to pos.
//
// What bounds it on the H100: every cache entry up to pos is read once and
// used for 4 * G flops, far below the 295 flops per byte at which the card
// turns compute-bound, so it is bound by bytes.  What the design does about
// that: it reads only positions t <= pos (never past them, so stale or
// uninitialised slots cannot reach the result), reads each K/V row once
// for all G heads of its group, and reads the cache in place in the
// model's (B, T, KV, Dh) layout through strides, where the TPU wrapper
// transposes the whole cache first.  Splitting T across blocks, so that a
// small B * KV fills the 132 SMs, is later work.
#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int BT = 64;   // cache positions per tile
constexpr int NT = 256;  // threads per block
constexpr int NWARPS = NT / 32;

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int G, n_valid;  // n_valid = pos + 1
  int64_t q_sb, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_sh;
  float scale;
};

template <int DH>
size_t smem_bytes(int G) {
  return (2 * G * DH + 2 * BT * (DH + 4) + G * BT + 3 * G) * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) decode_fwd(DecodeParams p) {
  constexpr int KP = DH + 4;  // padded row of the K / V tiles
  static_assert(BT == 64, "the softmax gives each lane two positions");
  const int G = p.G;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // G x DH
  float* Ks = qs + G * DH;                      // BT x KP
  float* Vs = Ks + BT * KP;                     // BT x KP
  float* Ps = Vs + BT * KP;                     // G x BT
  float* acc = Ps + G * BT;                     // G x DH
  float* m_s = acc + G * DH;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (kvh * G) * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + (kvh * G) * p.o_sh;

  repro::load_rows<T, DH, NT>(qs, DH, q, p.q_sh, 0, G, G);
  for (int e = tid; e < G * DH; e += NT) acc[e] = 0.f;
  for (int g = tid; g < G; g += NT) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  const int n_tiles = (p.n_valid + BT - 1) / BT;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * BT;
    __syncthreads();  // q is loaded; the last tile's P.V is done
    repro::load_rows<T, DH, NT>(Ks, KP, k, p.k_st, t0, p.n_valid, BT);
    repro::load_rows<T, DH, NT>(Vs, KP, v, p.v_st, t0, p.n_valid, BT);
    __syncthreads();

    for (int i = tid; i < G * BT; i += NT) {
      const int g = i / BT, t = i % BT;
      const float* qrow = qs + g * DH;
      const float* krow = Ks + t * KP;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qrow + d);
        const float4 kk = *reinterpret_cast<const float4*>(krow + d);
        s = fmaf(qq.x, kk.x, s);
        s = fmaf(qq.y, kk.y, s);
        s = fmaf(qq.z, kk.z, s);
        s = fmaf(qq.w, kk.w, s);
      }
      Ps[i] = (t0 + t < p.n_valid) ? s * p.scale : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARPS) {  // one warp per query row
      float* prow = Ps + g * BT;
      const float x0 = prow[lane], x1 = prow[lane + 32];
      const float m_prev = m_s[g];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);
      const float e0 = expf(x0 - m_new), e1 = expf(x1 - m_new);
      prow[lane] = e0;
      prow[lane + 32] = e1;
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // Positions past the fill level have p = 0 and zeroed V rows; stop at
    // the first multiple of 4 past them.
    const int t_end = (min(BT, p.n_valid - t0) + 3) & ~3;
    for (int e = tid; e < G * DH; e += NT) {  // each thread owns its e
      const int g = e / DH, c = e % DH;
      const float* prow = Ps + g * BT;
      float a = acc[e] * a_s[g];
      for (int t = 0; t < t_end; t += 4) {
        const float4 pp = *reinterpret_cast<const float4*>(prow + t);
        a = fmaf(pp.x, Vs[(t + 0) * KP + c], a);
        a = fmaf(pp.y, Vs[(t + 1) * KP + c], a);
        a = fmaf(pp.z, Vs[(t + 2) * KP + c], a);
        a = fmaf(pp.w, Vs[(t + 3) * KP + c], a);
      }
      acc[e] = a;
    }
  }

  for (int e = tid; e < G * DH; e += NT) {
    const int g = e / DH, c = e % DH;
    o[g * p.o_sh + c] = repro::to_out<T>(acc[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int DH>
cudaError_t launch(const DecodeParams& p, int B, int KV, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>(p.G);
  static size_t configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  dim3 grid(KV, B);
  decode_fwd<T, DH><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const DecodeParams& p, int B, int KV, int DH,
                        cudaStream_t stream) {
  switch (DH) {
    case 16: return launch<T, 16>(p, B, KV, stream);
    case 32: return launch<T, 32>(p, B, KV, stream);
    case 64: return launch<T, 64>(p, B, KV, stream);
    case 128: return launch<T, 128>(p, B, KV, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, H, Dh), k/v: (B, T, KV, Dh),
// o: (B, H, Dh), with H = KV * G and strides in elements; the last
// dimension of every tensor is contiguous.  Attends to t <= pos.
// Returns a cudaError_t.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int KV, int G, int DH, int pos, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
    int64_t o_sb, int64_t o_sh, float scale, void* stream) {
  DecodeParams p{q,    k,    v,    o,    G,    pos + 1, q_sb, q_sh,
                 k_sb, k_st, k_sh, v_sb, v_st, v_sh,    o_sb, o_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dh<float>(p, B, KV, DH, st);
  if (dtype == 1) return dispatch_dh<__nv_bfloat16>(p, B, KV, DH, st);
  return cudaErrorInvalidValue;
}
