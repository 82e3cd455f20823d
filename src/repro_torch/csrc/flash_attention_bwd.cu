// The backward of prefill flash attention (flash_attention.cu) for Hopper
// (sm_90a): dQ, dK and dV, causal or not, grouped-query, bf16 or fp32.
//
// It replaces no TPU kernel: the reference trains through the jnp twin of
// flash_attention_bhsd (models/attention.py::_sdpa), which JAX
// differentiates, while the port's forward runs the flash kernel, so its
// gradient is a kernel too.  The function is that of _sdpa's gradient:
// with the forward's scaled, masked scores S = scale * Q K^T (mask value
// -1e30, the top-left causal mask row >= col whatever Sk is), P =
// softmax(S) = exp(S - lse) from the forward's per-row log-sum-exp,
//   dV = P^T dO,  dP = dO V^T,  D = rowsum(dO * O),  dS = P * (dP - D),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the G = H / KV query heads that share a KV head.
//
// What bounds it on the H100: operations.  At qwen3-0.6b's training shape
// (B 4, S 4,096, H 16, KV 8, Dh 128, causal) one call does five products
// of the kept (row, key) pairs, 2 x Dh flops a pair each: 5 x 2 x 128 x
// 64 x 8.4 M pairs = 0.69 TFLOP, 0.70 ms on the bf16 tensor cores, against
// 0.5 GB of q, k, v, o, dO, dq, dk and dv (0.15 ms at 3.35 TB/s).  It is
// simple before it is fast.  Its design:
//  - three launches: D = rowsum(dO * O) over every query row (a group of
//    Dh / 16-byte-vector threads a row); then the dK/dV kernel, one block
//    a (key tile of 64, KV head, batch), which holds its K and V tiles
//    and its dK and dV accumulators (fp32, in registers) and loops over
//    the G query heads of its group and, under the causal mask, only over
//    the 64-row query tiles at or below its keys; then the dQ kernel, one
//    block a (query tile of 64, head, batch, heaviest first), which loops
//    over the key tiles its rows see.  Each output is written once by one
//    block, with no atomics, so GQA's sum over the group runs in a fixed
//    order and two runs give the same bits.  Both recompute S and dP = dO
//    V^T (seven products in all where five would do with a dQ summed
//    across blocks);
//  - bf16 runs every product on the tensor cores (mma.sync m16n8k16, fp32
//    accumulation) in FA2's layout: four warps a block, each owning 16 of
//    the block's 64 keys (dK/dV) or query rows (dQ), so the fragments of
//    S^T, dP^T (or S, dP) become P and dS in registers and, rounded to
//    bf16, the A operand of dV += P^T dO, dK += dS^T Q (dQ += dS K)
//    without touching shared memory; tiles are bf16 in shared memory,
//    rows Dh + 8 elements apart so that the 8 rows of an ldmatrix fall in
//    8 bank groups; the streamed tiles (Q and dO in dK/dV, K and V in dQ)
//    sit in two stages, the next one copied (cp.async) under this one's
//    products (103 KB a block at Dh 128: two blocks an SM);
//  - fp32 keeps its products on the CUDA cores (fp32 tiles, each thread a
//    4 x 4 register tile of S and dP, P and dS through shared memory; 171
//    KB and 153 KB at Dh 128): the checks hold fp32 to 2e-5, which TF32
//    or bf16 products would not meet;
//  - q, k, v, o, dO are read in the model's (B, S | Sk, H | KV, Dh)
//    layout through strides; rows past Sq or Sk are loaded as zeros and
//    masked, so a ragged length needs no padding.
// wgmma with TMA rings, fewer registers in dK/dV (255 and a spill at Dh
// 128), and a dQ summed in the dK/dV pass are later work.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq), from the forward
  float* delta;      // (B, H, Sq), D = rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, KV;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  float scale;
  int causal;
};

constexpr int BQ = 64;   // query rows a tile
constexpr int BK = 64;   // keys a tile
constexpr int NT = 256;  // threads a block

template <typename T>
__device__ __forceinline__ void store(T* p, float x) {
  *p = repro::to_out<T>(x);
}

// D[b, h, i] = sum over d of dO[b, i, h, d] * O[b, i, h, d]: CH threads a
// row, one 16-byte vector each, rows in (b, h, i) order.
template <typename T, int DH>
__global__ void __launch_bounds__(NT) fa_bwd_delta(BwdParams p) {
  constexpr int VEC = 16 / sizeof(T), CH = DH / VEC;
  static_assert(CH <= 32 && (32 % CH) == 0, "unsupported head size");
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const int64_t row = gid / CH;
  const int c = static_cast<int>(gid % CH);
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.Sq;
  float acc = 0.f;
  if (row < rows) {
    const int i = static_cast<int>(row % p.Sq);
    const int h = static_cast<int>((row / p.Sq) % p.H);
    const int b = static_cast<int>(row / (static_cast<int64_t>(p.Sq) * p.H));
    float a[VEC], o[VEC];
    repro::load16(static_cast<const T*>(p.dout) + b * p.do_sb + i * p.do_ss +
                      h * p.do_sh + c * VEC, a);
    repro::load16(static_cast<const T*>(p.o) + b * p.o_sb + i * p.o_ss +
                      h * p.o_sh + c * VEC, o);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc = fmaf(a[e], o[e], acc);
  }
#pragma unroll
  for (int off = CH / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) p.delta[row] = acc;
}

// S = Q K^T and dP = dO V^T of one BQ x BK tile from shared memory (rows
// DH + 4 floats apart): thread (tr, tc) = (tid / 16, tid % 16) gets rows
// tr + 16a and keys tc + 16b, a, b < 4.
template <int DH>
__device__ __forceinline__ void tile_products(const float* Qs,
                                              const float* dOs,
                                              const float* Ks,
                                              const float* Vs, float (&s)[4][4],
                                              float (&dp)[4][4]) {
  constexpr int P = DH + 4;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 kb[4], vb[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = *reinterpret_cast<const float4*>(Ks + (tc + 16 * b) * P + d);
      vb[b] = *reinterpret_cast<const float4*>(Vs + (tc + 16 * b) * P + d);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 qa =
          *reinterpret_cast<const float4*>(Qs + (tr + 16 * a) * P + d);
      const float4 oa =
          *reinterpret_cast<const float4*>(dOs + (tr + 16 * a) * P + d);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa.x, kb[b].x, s[a][b]);
        s[a][b] = fmaf(qa.y, kb[b].y, s[a][b]);
        s[a][b] = fmaf(qa.z, kb[b].z, s[a][b]);
        s[a][b] = fmaf(qa.w, kb[b].w, s[a][b]);
        dp[a][b] = fmaf(oa.x, vb[b].x, dp[a][b]);
        dp[a][b] = fmaf(oa.y, vb[b].y, dp[a][b]);
        dp[a][b] = fmaf(oa.z, vb[b].z, dp[a][b]);
        dp[a][b] = fmaf(oa.w, vb[b].w, dp[a][b]);
      }
    }
  }
}

// P and dS of the tile at query rows i0.., keys j0.., overwriting s and
// dp in place; masked pairs (past Sq or Sk, or above the causal
// diagonal) get 0.
__device__ __forceinline__ void tile_probs(const BwdParams& p, int i0, int j0,
                                           const float* lse_s,
                                           const float* d_s, float (&s)[4][4],
                                           float (&dp)[4][4]) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = tr + 16 * a, i = i0 + r;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tc + 16 * b;
      const bool keep = i < p.Sq && j < p.Sk && (!p.causal || j <= i);
      const float pr = keep ? expf(fmaf(s[a][b], p.scale, -lse_s[r])) : 0.f;
      s[a][b] = pr;
      dp[a][b] = pr * (dp[a][b] - d_s[r]);
    }
  }
}

// Loads query tile i0 of head h (Q, dO, lse and D) into shared memory.
template <typename T, int DH>
__device__ __forceinline__ void load_query_tile(const BwdParams& p, int b,
                                                int h, int i0, float* Qs,
                                                float* dOs, float* lse_s,
                                                float* d_s) {
  constexpr int P = DH + 4;
  repro::load_rows<T, DH, NT>(
      Qs, P, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
      i0, p.Sq, BQ);
  repro::load_rows<T, DH, NT>(
      dOs, P, static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh,
      p.do_ss, i0, p.Sq, BQ);
  if (threadIdx.x < BQ) {
    const int i = i0 + threadIdx.x;
    const int64_t at = (static_cast<int64_t>(b) * p.H + h) * p.Sq + i;
    lse_s[threadIdx.x] = i < p.Sq ? p.lse[at] : 0.f;
    d_s[threadIdx.x] = i < p.Sq ? p.delta[at] : 0.f;
  }
}

template <int DH>
constexpr size_t dkdv_smem_bytes() {
  return ((2 * BK + 2 * BQ) * (DH + 4) + 2 * BQ * (BK + 4) + 2 * BQ) *
         sizeof(float);
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  return ((2 * BK + 2 * BQ) * (DH + 4) + BK * (BQ + 4) + 2 * BQ) *
         sizeof(float);
}

// dK and dV of key tile blockIdx.z of KV head blockIdx.x, batch
// blockIdx.y: thread (tj, td) = (tid / 16, tid % 16) accumulates keys 4 tj
// + a (a < 4) at columns td + 16c (c < DH / 16).
template <typename T, int DH>
__global__ void __launch_bounds__(NT) fa_bwd_dkdv(BwdParams p) {
  constexpr int P = DH + 4, PP = BK + 4, C = DH / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * P;
  float* Qs = Vs + BK * P;
  float* dOs = Qs + BQ * P;
  float* Ps = dOs + BQ * P;
  float* dSs = Ps + BQ * PP;
  float* lse_s = dSs + BQ * PP;
  float* d_s = lse_s + BQ;

  const int kvh = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * BK;
  const int G = p.H / p.KV;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int tj = tr, td = tc;
  repro::load_rows<T, DH, NT>(
      Ks, P, static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss,
      j0, p.Sk, BK);
  repro::load_rows<T, DH, NT>(
      Vs, P, static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss,
      j0, p.Sk, BK);
  float dk[4][C], dv[4][C];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[a][c] = dv[a][c] = 0.f;

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int first = p.causal ? j0 / BQ : 0;  // rows below the keys see none
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = first; qt < n_qt; ++qt) {
      const int i0 = qt * BQ;
      __syncthreads();  // the last tile's products are done with the tiles
      load_query_tile<T, DH>(p, b, h, i0, Qs, dOs, lse_s, d_s);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_products<DH>(Qs, dOs, Ks, Vs, s, dp);
      tile_probs(p, i0, j0, lse_s, d_s, s, dp);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          Ps[(tr + 16 * a) * PP + tc + 16 * bb] = s[a][bb];
          dSs[(tr + 16 * a) * PP + tc + 16 * bb] = dp[a][bb];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's rows
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(Ps + i * PP + 4 * tj);
        const float4 sv =
            *reinterpret_cast<const float4*>(dSs + i * PP + 4 * tj);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float o = dOs[i * P + td + 16 * c];
          const float q = Qs[i * P + td + 16 * c];
          dv[0][c] = fmaf(pv.x, o, dv[0][c]);
          dv[1][c] = fmaf(pv.y, o, dv[1][c]);
          dv[2][c] = fmaf(pv.z, o, dv[2][c]);
          dv[3][c] = fmaf(pv.w, o, dv[3][c]);
          dk[0][c] = fmaf(sv.x, q, dk[0][c]);
          dk[1][c] = fmaf(sv.y, q, dk[1][c]);
          dk[2][c] = fmaf(sv.z, q, dk[2][c]);
          dk[3][c] = fmaf(sv.w, q, dk[3][c]);
        }
      }
    }
  }
  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + 4 * tj + a;
    if (j < p.Sk) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        store(dkp + static_cast<int64_t>(j) * p.dk_ss + td + 16 * c,
              dk[a][c] * p.scale);
        store(dvp + static_cast<int64_t>(j) * p.dv_ss + td + 16 * c, dv[a][c]);
      }
    }
  }
}

// dQ of query tile gridDim.z - 1 - blockIdx.z (heaviest first) of head
// blockIdx.x, batch blockIdx.y: thread (ti, td) = (tid / 16, tid % 16)
// accumulates rows 4 ti + a (a < 4) at columns td + 16c (c < DH / 16).
template <typename T, int DH>
__global__ void __launch_bounds__(NT) fa_bwd_dq(BwdParams p) {
  constexpr int P = DH + 4, PQ = BQ + 4, C = DH / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * P;
  float* Ks = dOs + BQ * P;
  float* Vs = Ks + BK * P;
  float* dSt = Vs + BK * P;  // dS transposed: BK x PQ
  float* lse_s = dSt + BK * PQ;
  float* d_s = lse_s + BQ;

  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (p.H / p.KV);
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int ti = tr, td = tc;
  load_query_tile<T, DH>(p, b, h, i0, Qs, dOs, lse_s, d_s);
  float dq[4][C];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) dq[a][c] = 0.f;

  int n_kt = (p.Sk + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (i0 + BQ - 1) / BK + 1);
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();  // the last tile's products are done with Ks, dSt
    repro::load_rows<T, DH, NT>(Ks, P, kp, p.k_ss, j0, p.Sk, BK);
    repro::load_rows<T, DH, NT>(Vs, P, vp, p.v_ss, j0, p.Sk, BK);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_products<DH>(Qs, dOs, Ks, Vs, s, dp);
    tile_probs(p, i0, j0, lse_s, d_s, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        dSt[(tc + 16 * bb) * PQ + tr + 16 * a] = dp[a][bb];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 sv = *reinterpret_cast<const float4*>(dSt + j * PQ + 4 * ti);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float kk = Ks[j * P + td + 16 * c];
        dq[0][c] = fmaf(sv.x, kk, dq[0][c]);
        dq[1][c] = fmaf(sv.y, kk, dq[1][c]);
        dq[2][c] = fmaf(sv.z, kk, dq[2][c]);
        dq[3][c] = fmaf(sv.w, kk, dq[3][c]);
      }
    }
  }
  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ti + a;
    if (i < p.Sq) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        store(dqp + static_cast<int64_t>(i) * p.dq_ss + td + 16 * c,
              dq[a][c] * p.scale);
    }
  }
}

// ------------------------------------------------------- bf16, mma.sync --
// The bf16 path runs every product on the tensor cores (mma.sync
// m16n8k16, fp32 accumulation), FA2's layout: a block is MW warps, each
// owning 16 rows of its output (keys in the dK/dV kernel, query rows in
// the dQ kernel), so P and dS never leave registers: the accumulator
// fragments of S (or S^T) and dP become, rounded to bf16, the A operand
// of the next product.  Tiles are bf16 in shared memory, rows DH + 8
// elements apart (eight rows read by one ldmatrix fall in eight bank
// groups), loaded with 16-byte vectors.
constexpr int MW = 4;          // warps a block
constexpr int MNT = 32 * MW;   // threads a block
constexpr int MROWS = 16 * MW; // the block's own rows: 64
constexpr float LOG2E = 1.4426950408889634f;
static_assert(MROWS == BQ && MROWS == BK, "tiles of 64 on both sides");

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}
// d += a b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// A 16-byte copy from global to shared memory that reads nothing and
// writes zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of rows [row0, row0 + 64) of a bf16 (*, DH) matrix,
// rows `row_stride` apart, into shared memory DH + 8 elements a row
// (cp.async, in the caller's commit group); rows at or past n_valid are
// zeros.
template <int DH>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* base,
                                               int64_t row_stride, int row0,
                                               int n_valid) {
  constexpr int LD = DH + 8, CH = DH / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += MNT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool valid = row0 + r < n_valid;
    cp_async16(dst + r * LD + c,
               valid ? base + static_cast<int64_t>(row0 + r) * row_stride + c
                     : base,
               valid);
  }
}

// lse (in log2 units) and D of rows [i0, i0 + 64) of head h into shared
// memory (0 past Sq): plain loads, visible after the next barrier.
__device__ __forceinline__ void load_row_stats(const BwdParams& p, int b,
                                               int h, int i0, float* lse_s,
                                               float* d_s) {
  if (threadIdx.x < 64) {
    const int i = i0 + threadIdx.x;
    const int64_t at = (static_cast<int64_t>(b) * p.H + h) * p.Sq + i;
    lse_s[threadIdx.x] = i < p.Sq ? p.lse[at] * LOG2E : 0.f;
    d_s[threadIdx.x] = i < p.Sq ? p.delta[at] : 0.f;
  }
}

// acc (16 x 64, 8 n-tiles) += A B^T over k = 0..DH: A 16 rows of a tile at
// row a0, B the 64 rows of a tile, both [row][k] in shared memory.
template <int DH>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* A,
                                        int a0, const bf16* B) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + (a0 + (lane & 15)) * LD + kk * 16 + 8 * (lane >> 4));
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      uint32_t b[4];
      ldsm_x4(b, B + (n2 * 16 + (lane & 7) + 8 * (lane >> 4)) * LD + kk * 16 +
                     8 * ((lane >> 3) & 1));
      mma16816(acc[2 * n2], a, b[0], b[1]);
      mma16816(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// out (16 x DH, DH / 8 n-tiles) += P B over k = 0..64: P the 16 x 64
// fragments of an earlier product (rounded to bf16 here), B the 64 rows
// of a tile, [k][n] in shared memory.
template <int DH>
__device__ __forceinline__ void mma_pb(float (&out)[DH / 8][4],
                                       const float (&p)[8][4], const bf16* B) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < DH / 16; ++dn) {
      uint32_t b[4];
      ldsm_x4_t(b, B + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                       dn * 16 + 8 * (lane >> 4));
      mma16816(out[2 * dn], a, b[0], b[1]);
      mma16816(out[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

// Six 64-row tiles (the block's two fixed ones, two streamed ones in two
// stages) and two stages of 64 lse and D values.
template <int DH>
constexpr size_t mma_smem_bytes() {
  return 6 * 64 * (DH + 8) * sizeof(bf16) + 4 * 64 * sizeof(float);
}

// dK and dV on the tensor cores: block (KV head, batch, key tile); warp w
// owns keys 16w..16w+15 of the tile.  Per query tile: S^T = K Q^T and
// dP^T = V dO^T (16 x 64 a warp), then P^T and dS^T in registers, dV +=
// P^T dO and dK += dS^T Q.  The (head, query tile) pairs stream through
// two stages: the next pair's Q and dO load (cp.async) under this one's
// products.
template <int DH>
__global__ void __launch_bounds__(MNT) fa_bwd_dkdv_mma(BwdParams p) {
  constexpr int LD = DH + 8, TILE = 64 * LD;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;       // 2 stages
  bf16* dOs = Qs + 2 * TILE;  // 2 stages
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TILE);  // 2 x 64, log2
  float* d_s = lse_s + 2 * 64;                               // 2 x 64

  const int kvh = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * BK;
  const int G = p.H / p.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, kw = 16 * warp;
  const float scale2 = p.scale * LOG2E;
  // query tiles at or below the keys under the causal mask; then each of
  // the group's G heads
  const int first = p.causal ? j0 / BQ : 0;
  const int nq = max((p.Sq + BQ - 1) / BQ - first, 0), total = G * nq;
  auto fetch = [&](int m, int st) {
    const int h = kvh * G + m / nq, i0 = (first + m % nq) * BQ;
    load_tile_bf16<DH>(Qs + st * TILE, static_cast<const bf16*>(p.q) +
                                           b * p.q_sb + h * p.q_sh,
                       p.q_ss, i0, p.Sq);
    load_tile_bf16<DH>(dOs + st * TILE, static_cast<const bf16*>(p.dout) +
                                            b * p.do_sb + h * p.do_sh,
                       p.do_ss, i0, p.Sq);
    load_row_stats(p, b, h, i0, lse_s + 64 * st, d_s + 64 * st);
  };
  load_tile_bf16<DH>(Ks, static_cast<const bf16*>(p.k) + b * p.k_sb +
                             kvh * p.k_sh, p.k_ss, j0, p.Sk);
  load_tile_bf16<DH>(Vs, static_cast<const bf16*>(p.v) + b * p.v_sb +
                             kvh * p.v_sh, p.v_ss, j0, p.Sk);
  if (total > 0) fetch(0, 0);
  cp_async_commit();
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int m = 0; m < total; ++m) {
    const int st = m & 1, i0 = (first + m % nq) * BQ;
    if (m + 1 < total) fetch(m + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile m is in
    __syncthreads();
    const bf16* Q = Qs + st * TILE;
    const bf16* dO = dOs + st * TILE;
    const float* lse = lse_s + 64 * st;
    const float* dd = d_s + 64 * st;
    float st_[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st_[n][e] = dpt[n][e] = 0.f;
    mma_abt<DH>(st_, Ks, kw, Q);
    mma_abt<DH>(dpt, Vs, kw, dO);
    // P^T and dS^T: element (key kw + g (+8), query n * 8 + 2t (+1))
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const int i = i0 + c, j = j0 + kw + g + 8 * (e >> 1);
        const bool keep = i < p.Sq && j < p.Sk && (!p.causal || j <= i);
        const float pr =
            keep ? fast_exp2(fmaf(st_[n][e], scale2, -lse[c])) : 0.f;
        st_[n][e] = pr;
        dpt[n][e] = pr * (dpt[n][e] - dd[c]);
      }
    mma_pb<DH>(dv, st_, dO);
    mma_pb<DH>(dk, dpt, Q);
    __syncthreads();  // stage st is read; the fetch at m + 1 refills it
  }
  cp_async_wait<0>();
  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + kw + g + 8 * r;
    if (j < p.Sk) {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const int col = n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dkp + static_cast<int64_t>(j) * p.dk_ss +
                                     col) =
            pack_bf16(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvp + static_cast<int64_t>(j) * p.dv_ss +
                                     col) =
            pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// dQ on the tensor cores: block (head, batch, query tile, heaviest
// first); warp w owns query rows 16w..16w+15.  Per key tile: S = Q K^T
// and dP = dO V^T, P and dS in registers, dQ += dS K.  The key tiles
// stream through two stages: the next one's K and V load (cp.async)
// under this one's products.
template <int DH>
__global__ void __launch_bounds__(MNT) fa_bwd_dq_mma(BwdParams p) {
  constexpr int LD = DH + 8, TILE = 64 * LD;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + TILE;
  bf16* Ks = dOs + TILE;      // 2 stages
  bf16* Vs = Ks + 2 * TILE;   // 2 stages
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * TILE);  // log2 units
  float* d_s = lse_s + 64;

  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, qw = 16 * warp;
  const float scale2 = p.scale * LOG2E;
  int n_kt = (p.Sk + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (i0 + BQ - 1) / BK + 1);
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  auto fetch = [&](int kt, int st) {
    load_tile_bf16<DH>(Ks + st * TILE, kp, p.k_ss, kt * BK, p.Sk);
    load_tile_bf16<DH>(Vs + st * TILE, vp, p.v_ss, kt * BK, p.Sk);
  };
  load_tile_bf16<DH>(Qs, static_cast<const bf16*>(p.q) + b * p.q_sb +
                             h * p.q_sh, p.q_ss, i0, p.Sq);
  load_tile_bf16<DH>(dOs, static_cast<const bf16*>(p.dout) + b * p.do_sb +
                              h * p.do_sh, p.do_ss, i0, p.Sq);
  load_row_stats(p, b, h, i0, lse_s, d_s);
  fetch(0, 0);
  cp_async_commit();
  float dq[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, j0 = kt * BK;
    if (kt + 1 < n_kt) fetch(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile kt is in
    __syncthreads();
    const bf16* K = Ks + st * TILE;
    const bf16* V = Vs + st * TILE;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<DH>(s, Qs, qw, K);
    mma_abt<DH>(dp, dOs, qw, V);
    // P and dS: element (row qw + g (+8), key n * 8 + 2t (+1))
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qw + g + 8 * (e >> 1);
        const int i = i0 + r, j = j0 + n * 8 + 2 * t + (e & 1);
        const bool keep = i < p.Sq && j < p.Sk && (!p.causal || j <= i);
        const float pr =
            keep ? fast_exp2(fmaf(s[n][e], scale2, -lse_s[r])) : 0.f;
        dp[n][e] = pr * (dp[n][e] - d_s[r]);
      }
    mma_pb<DH>(dq, dp, K);
    __syncthreads();  // stage st is read; the fetch at kt + 1 refills it
  }
  cp_async_wait<0>();
  bf16* dqp = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + qw + g + 8 * r;
    if (i < p.Sq) {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<uint32_t*>(dqp + static_cast<int64_t>(i) * p.dq_ss +
                                     n * 8 + 2 * t) =
            pack_bf16(dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  done = err == cudaSuccess;
  return err;
}

// The three launches: D, then dK/dV and dQ by `dkdv` and `dq` (threads a
// block, dynamic shared memory of each); `ready` says whether each
// kernel's shared memory limit has been raised.
template <typename T, int DH, typename Kernel>
cudaError_t launch_three(const BwdParams& p, cudaStream_t st, Kernel dkdv,
                         size_t dkdv_smem, Kernel dq, size_t dq_smem,
                         int threads_a_block, bool (&ready)[2]) {
  constexpr int CH = DH / (16 / sizeof(T));
  cudaError_t err;
  if ((err = allow_smem(dkdv, dkdv_smem, ready[0])) != cudaSuccess ||
      (err = allow_smem(dq, dq_smem, ready[1])) != cudaSuccess)
    return err;
  const int64_t threads = static_cast<int64_t>(p.B) * p.H * p.Sq * CH;
  fa_bwd_delta<T, DH><<<static_cast<unsigned>((threads + NT - 1) / NT), NT,
                        0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_kt = (p.Sk + BK - 1) / BK, n_qt = (p.Sq + BQ - 1) / BQ;
  dkdv<<<dim3(p.KV, p.B, n_kt), threads_a_block, dkdv_smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<dim3(p.H, p.B, n_qt), threads_a_block, dq_smem, st>>>(p);
  return cudaGetLastError();
}

// bf16 runs the tensor-core kernels, fp32 the CUDA-core ones.
template <typename T, int DH>
cudaError_t launch(const BwdParams& p, cudaStream_t st) {
  static bool ready[2] = {false, false};
  if constexpr (sizeof(T) == 2)
    return launch_three<T, DH>(p, st, fa_bwd_dkdv_mma<DH>,
                               mma_smem_bytes<DH>(), fa_bwd_dq_mma<DH>,
                               mma_smem_bytes<DH>(), MNT, ready);
  else
    return launch_three<T, DH>(p, st, fa_bwd_dkdv<T, DH>,
                               dkdv_smem_bytes<DH>(), fa_bwd_dq<T, DH>,
                               dq_smem_bytes<DH>(), NT, ready);
}

template <typename T>
cudaError_t launch_dh(const BwdParams& p, int DH, cudaStream_t st) {
  switch (DH) {
    case 16: return launch<T, 16>(p, st);
    case 32: return launch<T, 32>(p, st);
    case 64: return launch<T, 64>(p, st);
    case 128: return launch<T, 128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The backward of flash_attention_fwd.  dtype: 0 = float32, 1 = bfloat16,
// for q, k, v, o, dout (the output's gradient), dq, dk, dv.  q, o, dout
// and dq hold Sq rows, k, v, dk, dv Sk; every last dimension is
// contiguous, strides are in elements.  lse: the forward's contiguous (B,
// H, Sq) float32 log-sum-exp; delta: a (B, H, Sq) float32 scratch buffer.
// Three launches on `stream`; returns a cudaError_t.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int H, int KV, int DH,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,
    int64_t dq_sb, int64_t dq_ss, int64_t dq_sh, int64_t dk_sb, int64_t dk_ss,
    int64_t dk_sh, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh, float scale,
    int causal, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV || B > 65535 ||
      (Sq + BQ - 1) / BQ > 65535 || (Sk + BK - 1) / BK > 65535)
    return cudaErrorInvalidValue;
  const BwdParams p{q,     k,     v,     o,     dout,  lse,   delta, dq,
                    dk,    dv,    B,     Sq,    Sk,    H,     KV,    q_sb,
                    q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb,  v_ss,  v_sh,
                    o_sb,  o_ss,  o_sh,  do_sb, do_ss, do_sh, dq_sb, dq_ss,
                    dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale,
                    causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(p, DH, st);
  if (dtype == 1) return launch_dh<bf16>(p, DH, st);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory of one block of the fp32 dK/dV and dQ kernels
// (which = 0, 1) and of either bf16 kernel (which = 2) at head size DH; 0
// when there is no such instantiation.
extern "C" int flash_attention_bwd_smem_bytes(int which, int DH) {
  auto pick = [&](size_t dkdv, size_t dq, size_t mma) {
    return static_cast<int>(which == 0 ? dkdv : which == 1 ? dq
                            : which == 2 ? mma : 0);
  };
  switch (DH) {
    case 16: return pick(dkdv_smem_bytes<16>(), dq_smem_bytes<16>(), mma_smem_bytes<16>());
    case 32: return pick(dkdv_smem_bytes<32>(), dq_smem_bytes<32>(), mma_smem_bytes<32>());
    case 64: return pick(dkdv_smem_bytes<64>(), dq_smem_bytes<64>(), mma_smem_bytes<64>());
    case 128: return pick(dkdv_smem_bytes<128>(), dq_smem_bytes<128>(), mma_smem_bytes<128>());
    default: return 0;
  }
}
