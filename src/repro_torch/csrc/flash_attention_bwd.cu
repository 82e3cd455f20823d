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
// (B 4, S 4,096, H 16, KV 8, Dh 128, causal) the five products above (QK^T
// again, dO V^T, P^T dO, dS K, dS^T Q) of the kept (row, key) pairs take 2
// x Dh flops a pair each: 5 x 2 x 128 x 64 x 8.4 M pairs = 0.69 TFLOP,
// 0.695 ms on the bf16 tensor cores, against 0.5 GB of q, k, v, o, dO, dq,
// dk and dv (0.15 ms at 3.35 TB/s).  This design computes seven: S and dP
// once in each of its two kernels, 0.973 ms at the same rate.  It keeps
// them so that every output is written once, by one block, with no float
// atomics: GQA's sum over the group runs in a fixed order and two runs
// give the same bits.
//
// Three launches: D = rowsum(dO * O) over every query row (a group of Dh /
// 16-byte-vector threads a row); the dK/dV kernel; the dQ kernel.  The
// bf16 kernels, the ones training runs, take the forward's shape on this
// card:
//  - every product is a warpgroup wgmma with fp32 accumulation, in the
//    forward's two forms: an m64n64k16 product of two K-major tiles in
//    shared memory (S^T = K Q^T and dP^T = V dO^T in the dK/dV kernel, S =
//    Q K^T and dP = dO V^T in the dQ kernel), and an m64n{Dh}k16 product
//    whose A operand is in registers and whose B is an MN-major tile (dV
//    += P^T dO, dK += dS^T Q; dQ += dS K);
//  - P and dS are made in registers on the accumulator fragments (P =
//    exp2(S scale log2e - lse log2e), dS = P (dP - D)) and, rounded to
//    bf16, are the A operand of the next products: no score touches shared
//    memory;
//  - a block is warp-specialised: one producer warp keeps TMA loads
//    (cp.async.bulk.tensor) of the streamed 64-row tiles in a ring of two
//    stages with full and empty mbarriers, and two consumer warpgroups
//    run the products.  A consumer warp releases a stage by arriving at
//    its empty barrier, never at a block barrier.  setmaxnreg gives the
//    producer's warpgroup 24 registers a thread and the consumers 240, so
//    the dK and dV accumulators (64 keys x Dh 128, 128 registers) stay in
//    registers with nothing spilled;
//  - the dK/dV kernel: one block owns 128 keys of one KV head of one
//    sequence, 64 a consumer warpgroup, K and V loaded once by TMA and
//    kept in shared memory.  The ring streams Q and dO tiles with the 64
//    rows' lse and D, over the group's G query heads in a fixed order and,
//    under the causal mask, only over query tiles at or below the keys.
//    The producer reads the next rows' lse and D while the stage drains
//    and requests the tiles before it stores them;
//  - the dQ kernel: one block owns 128 query rows of one head, 64 a
//    consumer warpgroup, Q and dO resident; the ring streams K and V tiles
//    of 64 keys, only those at or left of the diagonal; query tiles are
//    handed out heaviest first; P is made while dP's product runs;
//  - tiles use the 128-, 64- or 32-byte swizzle that TMA writes and wgmma
//    reads, through maps over the model's strided (B, S | Sk, H | KV, Dh)
//    views (no transposed copies).  TMA fills rows past Sq or Sk with
//    zeros; the kernels mask the ragged edge and the top-left causal mask
//    elementwise on the tiles that need it, in a body of their own (a test
//    per element, inside the unrolled loop, compiles to a branch around
//    each exponential, which serialises them), and tiles wholly above the
//    diagonal are never loaded;
//  - dK and dQ get the scale once, in fp32, before the single rounding to
//    bf16; outputs are staged in the block's own tiles and stored 16 bytes
//    a lane.
// The fp32 kernels keep their products on the CUDA cores (fp32 tiles, each
// thread a 4 x 4 register tile of S and dP, P and dS through shared memory;
// 171 KB and 153 KB at Dh 128): the checks hold fp32 to 2e-5, which TF32 or
// bf16 products would not meet.
// Left for later: summing dQ in the dK/dV pass (five products, not seven)
// needs a cross-block sum that keeps the bits.  A consumer warpgroup's
// tile is its first products, then its elementwise work, then its last
// products; the two warpgroups run in step, so the tensor cores wait
// while both work on their registers.  Turns between them at each product
// (FA3's ping-pong), a one-off offset between them, a third ring stage
// and Q and dO as register operands in the dQ kernel were each tried on
// the H100 and none was faster (PERF.md).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;
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

// --------------------------------------------- bf16, wgmma fed by TMA --
// Both kernels are three warpgroups: warpgroup 0 the producer (its warp 0
// starts the TMA loads), warpgroups 1 and 2 the consumers, each owning 64
// of the block's 128 rows of output (keys in the dK/dV kernel, query rows
// in the dQ kernel).  The accumulator of m64nN (PTX ISA): warp w of a
// warpgroup holds rows 16 w + g and 16 w + g + 8; d[4 i + e] is column 8 i
// + 2 t + (e & 1) of row g + 8 (e >> 1); an A operand from registers takes
// mma.m16n8k16's A layout in each warp.
constexpr int CWG = 2;                // consumer warpgroups a block
constexpr int WNT = 128 * (CWG + 1);  // threads a block
constexpr int WROWS = 64 * CWG;       // the block's rows of output
constexpr int RING = 2;               // stages of the streamed tiles
constexpr int PRODUCER_REGS = 24;     // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 240;

// The block's own 2 x CWG tiles (K and V, or Q and dO), RING stages of the
// two streamed tiles, RING x 64 lse and D values (the dK/dV kernel's), then
// the mbarriers: own tiles, RING full, RING empty.  Tiles of 64 rows x Dh
// bf16, 1024-byte aligned, in the swizzled layout.
template <int DH>
constexpr size_t wg_bwd_smem_bytes() {
  return 1024 + (2 * CWG + 2 * RING) * 64 * DH * sizeof(bf16) +
         2 * RING * 64 * sizeof(float) + (1 + 2 * RING) * sizeof(uint64_t);
}

// d = a b^T (64 x 64) over Dh: a and b 64-row tiles, both K-major, Dh / 16
// steps of m64n64k16; the caller fences, commits and waits.  A 16-deep
// step moves 32 B along the row, and to the next panel after RB / 32
// steps (in the descriptor's 16-byte units).
template <int DH>
__device__ __forceinline__ void product_abt(float (&d)[32], const bf16* a,
                                            const bf16* b) {
  constexpr int RB = Swz<DH>::RB;
  const uint64_t da = wg_desc<DH>(a, 16, 8 * RB);
  const uint64_t db = wg_desc<DH>(b, 16, 8 * RB);
  wgmma_ss_n64_first(d, da, db);
#pragma unroll
  for (int kc = 1; kc < DH / 16; ++kc) {
    const int step = (kc % (RB / 32)) * 2 + (kc / (RB / 32)) * (64 * RB / 16);
    wgmma_ss_n64(d, da + step, db + step);
  }
}

// d (64 x Dh) += a (64 x 64, four 16-deep A fragments in registers) * b (a
// 64-row tile read MN-major): four steps of m64n{Dh}k16, 16 rows of b each.
template <int DH>
__device__ __forceinline__ void product_ab(float (&d)[DH / 2],
                                           const uint32_t (&a)[4][4],
                                           const bf16* b) {
  constexpr int RB = Swz<DH>::RB;
  const uint64_t db = wg_desc<DH>(b, 64 * RB, 8 * RB);
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs<DH>(d, a[j], db + j * RB);
}

// The 64 x 64 accumulator x rounded to bf16 as four A fragments.
__device__ __forceinline__ void to_a_operand(uint32_t (&a)[4][4],
                                             const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[j][e] = pack_bf16(x[8 * j + 2 * e], x[8 * j + 2 * e + 1]);
}

// P^T in place of the S^T accumulator x: element 4 i + e is key key0 + 8
// (e >> 1) against query i0 + 8 i + 2 t + (e & 1), whose lse (log2 units)
// is lse[8 i + 2 t + (e & 1)]; with MASK (a tile on the ragged edge or the
// diagonal), pairs past Sq or above the causal diagonal get 0.  MASK is a
// template argument, so that the masked and the unmasked bodies are each
// straight-line code: a test inside the unrolled loop becomes a branch
// around every element, which serialises the exponentials.
template <bool MASK>
__device__ __forceinline__ void probs_t(float (&x)[32], const float* lse,
                                        float scale2, int i0, int key0,
                                        int Sq, int causal) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 l2 =
        *reinterpret_cast<const float2*>(lse + 8 * i + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr =
          fast_exp2(fmaf(x[4 * i + e], scale2, -(e & 1 ? l2.y : l2.x)));
      if constexpr (MASK) {
        const int qi = i0 + 8 * i + 2 * t + (e & 1);
        const bool keep =
            (qi < Sq) & ((causal == 0) | (key0 + 8 * (e >> 1) <= qi));
        x[4 * i + e] = keep ? pr : 0.f;
      } else {
        x[4 * i + e] = pr;
      }
    }
  }
}

// P in place of the S accumulator x of the dQ kernel: element 4 i + e is
// row row0 + 8 (e >> 1), whose lse (log2 units) is lse2[e >> 1], against
// key k0 + 8 i + 2 t + (e & 1); MASK as in probs_t, for keys past Sk or
// right of the diagonal.
template <bool MASK>
__device__ __forceinline__ void probs(float (&x)[32], const float (&lse2)[2],
                                      float scale2, int k0, int row0, int Sk,
                                      int causal) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float pr = fast_exp2(fmaf(x[4 * i + e], scale2, -lse2[r]));
      if constexpr (MASK) {
        const int kj = k0 + 8 * i + 2 * t + (e & 1);
        const bool keep =
            (kj < Sk) & ((causal == 0) | (kj <= row0 + 8 * r));
        x[4 * i + e] = keep ? pr : 0.f;
      } else {
        x[4 * i + e] = pr;
      }
    }
}

// dS^T = P^T (dP^T - D) in place of the dP^T accumulator, D by query as
// probs_t reads lse.
__device__ __forceinline__ void dsoft_t(float (&dp)[32],
                                        const float (&pt)[32],
                                        const float* dd) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 d2 =
        *reinterpret_cast<const float2*>(dd + 8 * i + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * i + e] =
          pt[4 * i + e] * (dp[4 * i + e] - (e & 1 ? d2.y : d2.x));
  }
}

// Writes a consumer warp's 16 rows of a 64 x Dh accumulator, times `mul`
// and rounded to bf16, to rows row0.. of `out` (rows `stride` apart; rows
// at or past n_valid are not written).  The rows are staged in `stage`, 16
// x Dh bf16 the warp owns, with 16-byte chunks XOR-swizzled by row against
// bank conflicts, and stored 16 bytes a lane.
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 2],
                                           float mul, bf16* stage, bf16* out,
                                           int64_t stride, int row0,
                                           int n_valid) {
  constexpr int CH = DH / 8, SW = CH < 8 ? CH : 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = g + 8 * r;
#pragma unroll
    for (int dn = 0; dn < CH; ++dn)
      *reinterpret_cast<uint32_t*>(stage + rr * DH + (dn ^ (rr % SW)) * 8 +
                                   2 * t) =
          pack_bf16(acc[4 * dn + 2 * r] * mul, acc[4 * dn + 2 * r + 1] * mul);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int rr = i / CH, c = i % CH;
    if (row0 + rr < n_valid)
      *reinterpret_cast<uint4*>(out + static_cast<int64_t>(row0 + rr) *
                                          stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + rr * DH +
                                          (c ^ (rr % SW)) * 8);
  }
}

// dK and dV: block (KV head, batch, key tile of 128, heaviest first).
// Consumer warpgroup c owns keys j0 + 64 c..; per streamed (head, query
// tile): S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T in registers,
// then dV += P^T dO and dK += dS^T Q.
template <int DH>
__global__ void __launch_bounds__(WNT, 1)
    fa_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, BwdParams p,
                     Slots sq, Slots sk, Slots sv, Slots sdo) {
  constexpr int TILE = 64 * DH;
  constexpr uint32_t TILE_BYTES = TILE * sizeof(bf16);
  static_assert(DH % 16 == 0 && DH <= 128, "unsupported head size");
  extern __shared__ float4 smem4[];
  bf16* Ks = align1024(smem4);
  bf16* Vs = Ks + CWG * TILE;
  bf16* Qs = Vs + CWG * TILE;    // RING stages
  bf16* dOs = Qs + RING * TILE;  // RING stages
  float* lse_s = reinterpret_cast<float*>(dOs + RING * TILE);  // log2 units
  float* d_s = lse_s + RING * 64;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(d_s + RING * 64);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + RING;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * WROWS;
  const int G = p.H / p.KV;
  // query tiles at or below the keys under the causal mask, for each of
  // the group's G heads in order
  const int first = p.causal ? j0 / 64 : 0;
  const int nq = max((p.Sq + 63) / 64 - first, 0), total = G * nq;
  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int st = 0; st < RING; ++st) {
      mbar_init(&full[st], 33);        // 32 lanes, and lane 0's bytes
      mbar_init(&empty[st], 4 * CWG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    regs_dec<PRODUCER_REGS>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * CWG * TILE_BYTES);
        for (int c = 0; c < CWG; ++c) {
          tma_tile<DH>(Ks + c * TILE, &tk, kvbar, j0 + 64 * c, kvh, b, sk);
          tma_tile<DH>(Vs + c * TILE, &tv, kvbar, j0 + 64 * c, kvh, b, sv);
        }
      }
      for (int m = 0; m < total; ++m) {
        const int st = m % RING;
        const int h = kvh * G + m / nq, i0 = (first + m % nq) * 64;
        // the lane's rows' lse and D are read while the stage drains;
        // the tiles are requested first, then the values stored, and
        // every lane's arrival releases its stores
        const int64_t at = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
        float l2[2], d2[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // 0 past Sq
          const int i = i0 + lane + 32 * r;
          l2[r] = i < p.Sq ? p.lse[at + i] * LOG2E : 0.f;
          d2[r] = i < p.Sq ? p.delta[at + i] : 0.f;
        }
        if (m >= RING) mbar_wait(&empty[st], (m / RING - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * TILE_BYTES);
          tma_tile<DH>(Qs + st * TILE, &tq, &full[st], i0, h, b, sq);
          tma_tile<DH>(dOs + st * TILE, &tdo, &full[st], i0, h, b, sdo);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lse_s[st * 64 + lane + 32 * r] = l2[r];
          d_s[st * 64 + lane + 32 * r] = d2[r];
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {  // a consumer
    regs_inc<CONSUMER_REGS>();
    const int c = wg - 1, wk0 = j0 + 64 * c;  // this warpgroup's keys
    const int key0 = wk0 + 16 * warp + (lane >> 2);  // keys key0, key0 + 8
    const float scale2 = p.scale * LOG2E;
    bf16* K = Ks + c * TILE;
    bf16* V = Vs + c * TILE;
    float dk[DH / 2], dv[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kvbar, 0);

    for (int m = 0; m < total; ++m) {
      const int st = m % RING, i0 = (first + m % nq) * 64;
      mbar_wait(&full[st], (m / RING) & 1);
      __syncwarp();
      if (p.causal && i0 + 63 < wk0) {  // every row above our keys
        if (lane == 0) mbar_arrive(&empty[st]);
        continue;
      }
      const bf16* Q = Qs + st * TILE;
      const bf16* dO = dOs + st * TILE;
      const bool edge = i0 + 64 > p.Sq || (p.causal && i0 < wk0 + 63);
      float s[32], dp[32];
      uint32_t pa[4][4], sa[4][4];
      wgmma_fence();
      product_abt<DH>(s, K, Q);
      product_abt<DH>(dp, V, dO);
      wgmma_commit();
      wgmma_wait();
      reg_fence(s);
      reg_fence(dp);
      if (edge)
        probs_t<true>(s, lse_s + st * 64, scale2, i0, key0, p.Sq, p.causal);
      else
        probs_t<false>(s, lse_s + st * 64, scale2, i0, key0, p.Sq, p.causal);
      dsoft_t(dp, s, d_s + st * 64);
      to_a_operand(pa, s);
      to_a_operand(sa, dp);
      wgmma_fence();
      product_ab<DH>(dv, pa, dO);
      product_ab<DH>(dk, sa, Q);
      wgmma_commit();
      wgmma_wait();
      reg_fence(dv);
      reg_fence(dk);
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with st
    }

    // keys past Sk are not written; keys no query row sees get zeros.
    // Each warp stages its 16 rows in its own rows of its K and V tiles,
    // which only this warpgroup's finished products read.
    const int row0 = wk0 + 16 * warp;
    store_rows<DH>(dk, p.scale, K + 16 * warp * DH,
                   static_cast<bf16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh,
                   p.dk_ss, row0, p.Sk);
    store_rows<DH>(dv, 1.f, V + 16 * warp * DH,
                   static_cast<bf16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh,
                   p.dv_ss, row0, p.Sk);
  }
}

// dQ: block (head, batch, query tile of 128, heaviest first).  Consumer
// warpgroup c owns rows q0 + 64 c..; per streamed key tile: S = Q K^T and
// dP = dO V^T, P and dS in registers, dQ += dS K.
template <int DH>
__global__ void __launch_bounds__(WNT, 1)
    fa_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, BwdParams p,
                   Slots sq, Slots sk, Slots sv, Slots sdo) {
  constexpr int TILE = 64 * DH;
  constexpr uint32_t TILE_BYTES = TILE * sizeof(bf16);
  static_assert(DH % 16 == 0 && DH <= 128, "unsupported head size");
  extern __shared__ float4 smem4[];
  bf16* Qs = align1024(smem4);
  bf16* dOs = Qs + CWG * TILE;
  bf16* Ks = dOs + CWG * TILE;  // RING stages
  bf16* Vs = Ks + RING * TILE;  // RING stages
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + RING * TILE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + RING;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WROWS;  // heaviest first
  const int kvh = h / (p.H / p.KV);
  int n_kt = (p.Sk + 63) / 64;
  if (p.causal) n_kt = min(n_kt, (q0 + WROWS - 1) / 64 + 1);
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < RING; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * CWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    regs_dec<PRODUCER_REGS>();
    if (tid == 0) {
      mbar_expect_tx(qbar, 2 * CWG * TILE_BYTES);
      for (int c = 0; c < CWG; ++c) {
        tma_tile<DH>(Qs + c * TILE, &tq, qbar, q0 + 64 * c, h, b, sq);
        tma_tile<DH>(dOs + c * TILE, &tdo, qbar, q0 + 64 * c, h, b, sdo);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % RING;
        if (kt >= RING) mbar_wait(&empty[st], (kt / RING - 1) & 1);
        mbar_expect_tx(&full[st], 2 * TILE_BYTES);
        tma_tile<DH>(Ks + st * TILE, &tk, &full[st], kt * 64, kvh, b, sk);
        tma_tile<DH>(Vs + st * TILE, &tv, &full[st], kt * 64, kvh, b, sv);
      }
    }
  } else {  // a consumer
    regs_inc<CONSUMER_REGS>();
    const int c = wg - 1, wq0 = q0 + 64 * c;  // this warpgroup's rows
    const int row0 = wq0 + 16 * warp + (lane >> 2);  // rows row0, row0 + 8
    const float scale2 = p.scale * LOG2E;
    float lse2[2], dd[2];  // in log2 units; 0 past Sq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      const int64_t at = (static_cast<int64_t>(b) * p.H + h) * p.Sq + i;
      lse2[r] = i < p.Sq ? p.lse[at] * LOG2E : 0.f;
      dd[r] = i < p.Sq ? p.delta[at] : 0.f;
    }
    bf16* Q = Qs + c * TILE;
    bf16* dO = dOs + c * TILE;
    float dq[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
    mbar_wait(qbar, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % RING, k0 = kt * 64;
      mbar_wait(&full[st], (kt / RING) & 1);
      __syncwarp();
      if (p.causal && k0 > wq0 + 63) {  // wholly above our rows
        if (lane == 0) mbar_arrive(&empty[st]);
        continue;
      }
      const bf16* K = Ks + st * TILE;
      const bf16* V = Vs + st * TILE;
      const bool edge = k0 + 64 > p.Sk || (p.causal && k0 + 63 > wq0);
      float s[32], dp[32];
      uint32_t sa[4][4];
      wgmma_fence();
      product_abt<DH>(s, Q, K);
      wgmma_commit();
      product_abt<DH>(dp, dO, V);
      wgmma_commit();
      wgmma_wait<1>();  // P while dP runs
      reg_fence(s);
      if (edge)
        probs<true>(s, lse2, scale2, k0, row0, p.Sk, p.causal);
      else
        probs<false>(s, lse2, scale2, k0, row0, p.Sk, p.causal);
      wgmma_wait();
      reg_fence(dp);
#pragma unroll
      for (int x = 0; x < 32; ++x) dp[x] = s[x] * (dp[x] - dd[(x >> 1) & 1]);
      to_a_operand(sa, dp);
      wgmma_fence();
      product_ab<DH>(dq, sa, K);
      wgmma_commit();
      wgmma_wait();
      reg_fence(dq);
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with st
    }

    // each warp stages its 16 rows in its own rows of its Q tile
    store_rows<DH>(dq, p.scale, Q + 16 * warp * DH,
                   static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh,
                   p.dq_ss, wq0 + 16 * warp, p.Sq);
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

// D = rowsum(dO * O), the first launch of either path.
template <typename T, int DH>
cudaError_t launch_delta(const BwdParams& p, cudaStream_t st) {
  constexpr int CH = DH / (16 / sizeof(T));
  const int64_t threads = static_cast<int64_t>(p.B) * p.H * p.Sq * CH;
  fa_bwd_delta<T, DH><<<static_cast<unsigned>((threads + NT - 1) / NT), NT,
                        0, st>>>(p);
  return cudaGetLastError();
}

// fp32: D, then the CUDA-core dK/dV and dQ kernels.
template <int DH>
cudaError_t launch_fp32(const BwdParams& p, cudaStream_t st) {
  static bool ready[2] = {false, false};
  cudaError_t err;
  if ((err = allow_smem(fa_bwd_dkdv<float, DH>, dkdv_smem_bytes<DH>(),
                        ready[0])) != cudaSuccess ||
      (err = allow_smem(fa_bwd_dq<float, DH>, dq_smem_bytes<DH>(),
                        ready[1])) != cudaSuccess ||
      (err = launch_delta<float, DH>(p, st)) != cudaSuccess)
    return err;
  const int n_kt = (p.Sk + BK - 1) / BK, n_qt = (p.Sq + BQ - 1) / BQ;
  fa_bwd_dkdv<float, DH><<<dim3(p.KV, p.B, n_kt), NT, dkdv_smem_bytes<DH>(),
                           st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq<float, DH><<<dim3(p.H, p.B, n_qt), NT, dq_smem_bytes<DH>(), st>>>(
      p);
  return cudaGetLastError();
}

// bf16: D, then the wgmma dK/dV and dQ kernels over TMA maps of q, k, v
// and dO.
template <int DH>
cudaError_t launch_bf16(const BwdParams& p, cudaStream_t st) {
  constexpr size_t smem = wg_bwd_smem_bytes<DH>();
  static bool ready[2] = {false, false};
  cudaError_t err;
  if ((err = allow_smem(fa_bwd_dkdv_bf16<DH>, smem,
                        ready[0])) != cudaSuccess ||
      (err = allow_smem(fa_bwd_dq_bf16<DH>, smem,
                        ready[1])) != cudaSuccess)
    return err;
  CUtensorMap tq, tk, tv, tdo;
  Slots sq, sk, sv, sdo;
  if ((err = make_map<DH>(&tq, &sq, p.q, p.Sq, p.H, p.B, p.q_ss, p.q_sh,
                          p.q_sb)) != cudaSuccess ||
      (err = make_map<DH>(&tk, &sk, p.k, p.Sk, p.KV, p.B, p.k_ss, p.k_sh,
                          p.k_sb)) != cudaSuccess ||
      (err = make_map<DH>(&tv, &sv, p.v, p.Sk, p.KV, p.B, p.v_ss, p.v_sh,
                          p.v_sb)) != cudaSuccess ||
      (err = make_map<DH>(&tdo, &sdo, p.dout, p.Sq, p.H, p.B, p.do_ss,
                          p.do_sh, p.do_sb)) != cudaSuccess ||
      (err = launch_delta<bf16, DH>(p, st)) != cudaSuccess)
    return err;
  const int n_kt = (p.Sk + WROWS - 1) / WROWS;
  const int n_qt = (p.Sq + WROWS - 1) / WROWS;
  fa_bwd_dkdv_bf16<DH><<<dim3(p.KV, p.B, n_kt), WNT, smem,
                                        st>>>(tq, tk, tv, tdo, p, sq, sk, sv,
                                              sdo);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq_bf16<DH><<<dim3(p.H, p.B, n_qt), WNT, smem, st>>>(
      tq, tk, tv, tdo, p, sq, sk, sv, sdo);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const BwdParams& p, int dtype, cudaStream_t st) {
  if (dtype == 0) return launch_fp32<DH>(p, st);
  if (dtype == 1) return launch_bf16<DH>(p, st);
  return cudaErrorInvalidValue;
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
  switch (DH) {
    case 16: return launch<16>(p, dtype, st);
    case 32: return launch<32>(p, dtype, st);
    case 64: return launch<64>(p, dtype, st);
    case 128: return launch<128>(p, dtype, st);
    default: return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of one block of the fp32 dK/dV and dQ kernels
// (which = 0, 1) and of either bf16 kernel (which = 2) at head size DH; 0
// when there is no such instantiation.
extern "C" int flash_attention_bwd_smem_bytes(int which, int DH) {
  auto pick = [&](size_t dkdv, size_t dq, size_t wg) {
    return static_cast<int>(which == 0 ? dkdv : which == 1 ? dq
                            : which == 2 ? wg : 0);
  };
  switch (DH) {
    case 16: return pick(dkdv_smem_bytes<16>(), dq_smem_bytes<16>(), wg_bwd_smem_bytes<16>());
    case 32: return pick(dkdv_smem_bytes<32>(), dq_smem_bytes<32>(), wg_bwd_smem_bytes<32>());
    case 64: return pick(dkdv_smem_bytes<64>(), dq_smem_bytes<64>(), wg_bwd_smem_bytes<64>());
    case 128: return pick(dkdv_smem_bytes<128>(), dq_smem_bytes<128>(), wg_bwd_smem_bytes<128>());
    default: return 0;
  }
}
