// Prefill flash attention for Hopper (sm_90a): causal or not, grouped-query.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_bhsd (body _flash_kernel).  Same function: for query head
// h, attend to KV head h / (H / KV) with an online softmax in fp32
// (m, l, acc), mask value -1e30, l clamped at 1e-30; tiles above the
// diagonal are skipped and the diagonal tile is masked elementwise.
//
// What bounds it on the H100: the work is 4 * B * H * Dh * S(S+1)/2 flops
// against reading q, k, v and writing o once.  At S = 512 (B 8, H 32,
// KV 8, Dh 128, bf16) bytes bind: 0.025 ms of bytes at 3.35 TB/s against
// 0.017 ms of operations on the bf16 tensor cores; operations bind only at
// longer S.  This first version does the products with fp32 FMAs on the
// CUDA cores (67 TFLOP/s, not the 989 of the bf16 tensor cores), which is
// why it runs some 45x its bound; tensor cores (wgmma) and TMA loads are
// later work.  What the design does meanwhile: one block owns a 64-row
// query tile, so each K/V tile read from device memory serves 64 queries;
// products read shared memory as float4, and each thread keeps a register
// tile of scores (16) and of output rows (Dh / 4 for Dh = 128), so
// shared-memory traffic stays a fraction of the FMA count.
//
// Unlike the TPU kernel it reads q, k, v in the model's (B, S, H | KV, Dh)
// layout through strides (no transposed copies) and masks a ragged S
// itself (no padding to the tile size).
#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, H, KV;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

template <int DH>
constexpr size_t smem_bytes() {
  return (BQ * DH + BK * (DH + 4) + BQ * (BK + 4) + 3 * BQ) * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_fwd(FlashParams p) {
  constexpr int KP = DH + 4;        // padded row of the K / V tile
  constexpr int PP = BK + 4;        // padded row of the score tile
  constexpr int SSTEP = NT / BK;    // QK^T: a thread's rows step by this
  constexpr int SPT = BQ / SSTEP;   //       and it owns this many scores
  constexpr int RSTEP = NT / DH;    // P.V:  a thread's rows step by this
  constexpr int RPT = BQ / RSTEP;   //       and it owns this many outputs
  static_assert(NT % DH == 0 && BQ % RSTEP == 0, "unsupported head size");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x DH
  float* KVs = Qs + BQ * DH;                    // BK x KP: K, then V
  float* Ps = KVs + BK * KP;                    // BQ x PP: scores, then p
  float* m_s = Ps + BQ * PP;                    // running max per row
  float* l_s = m_s + BQ;                        // running sum per row
  float* a_s = l_s + BQ;                        // this tile's rescale

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  repro::load_rows<T, DH, NT>(Qs, DH, q, p.q_ss, q0, p.S, BQ);
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  int n_tiles = (p.S + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  const int qk_c = tid % BK, qk_r = tid / BK;
  const int pv_c = tid % DH, pv_r = tid / DH;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q is loaded; the last tile's P.V is done with KVs, Ps
    repro::load_rows<T, DH, NT>(KVs, KP, k, p.k_ss, k0, p.S, BK);
    __syncthreads();

    float sc[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&KVs[qk_c * KP + d]);
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&Qs[(qk_r + j * SSTEP) * DH + d]);
        sc[j] = fmaf(qq.x, kk.x, sc[j]);
        sc[j] = fmaf(qq.y, kk.y, sc[j]);
        sc[j] = fmaf(qq.z, kk.z, sc[j]);
        sc[j] = fmaf(qq.w, kk.w, sc[j]);
      }
    }
    const int col = k0 + qk_c;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int r = qk_r + j * SSTEP;
      const bool keep = col < p.S && (!p.causal || col <= q0 + r);
      Ps[r * PP + qk_c] = keep ? sc[j] * p.scale : NEG_INF;
    }
    __syncthreads();  // scores are written and K is no longer read

    repro::load_rows<T, DH, NT>(KVs, KP, v, p.v_ss, k0, p.S, BK);
    {  // online softmax: four threads per row, columns interleaved by 4
      const int r = tid >> 2, part = tid & 3;
      float* prow = Ps + r * PP;
      const float m_prev = m_s[r];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) mx = fmaxf(mx, prow[part + 4 * j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const float e = expf(prow[part + 4 * j] - m_new);
        prow[part + 4 * j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();  // p, the rescale and the V tile are ready

#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] *= a_s[pv_r + i * RSTEP];
#pragma unroll 2
    for (int t = 0; t < BK; t += 4) {
      const float v0 = KVs[(t + 0) * KP + pv_c];
      const float v1 = KVs[(t + 1) * KP + pv_c];
      const float v2 = KVs[(t + 2) * KP + pv_c];
      const float v3 = KVs[(t + 3) * KP + pv_c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 pp =
            *reinterpret_cast<const float4*>(&Ps[(pv_r + i * RSTEP) * PP + t]);
        acc[i] = fmaf(pp.x, v0, acc[i]);
        acc[i] = fmaf(pp.y, v1, acc[i]);
        acc[i] = fmaf(pp.z, v2, acc[i]);
        acc[i] = fmaf(pp.w, v3, acc[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = pv_r + i * RSTEP;
    if (q0 + r < p.S) {
      o[static_cast<int64_t>(q0 + r) * p.o_ss + pv_c] =
          repro::to_out<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const FlashParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  flash_fwd<T, DH><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const FlashParams& p, int B, int DH,
                        cudaStream_t stream) {
  switch (DH) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor is contiguous.  Returns a cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int H, int KV, int DH, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
    int causal, void* stream) {
  FlashParams p{q,    k,    v,    o,    S,    H,    KV,   q_sb, q_ss,
                q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
                o_sh, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dh<float>(p, B, DH, st);
  if (dtype == 1) return dispatch_dh<__nv_bfloat16>(p, B, DH, st);
  return cudaErrorInvalidValue;
}
