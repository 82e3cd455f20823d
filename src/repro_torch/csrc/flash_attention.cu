// Prefill flash attention for Hopper (sm_90a): causal or not, grouped-query.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_bhsd (body _flash_kernel).  Same function: for query head
// h, attend to KV head h / (H / KV) with an online softmax in fp32
// (m, l, acc), mask value -1e30, l clamped at 1e-30; tiles above the
// diagonal are skipped and the diagonal tile is masked elementwise.  As
// there, the keys have a length Sk of their own (cross attention reads an
// encoder's Sk frames from Sq decoder positions), and the causal mask is
// the top-left row >= col whatever Sk is.
//
// What bounds it on the H100: the work is 4 * B * H * Dh * S(S+1)/2 flops
// against reading q, k, v and writing o once.  At both serving cells of
// llama3.1-8b (B 8, S 512 and B 32, S 128; H 32, KV 8, Dh 128, bf16) the
// bytes are 4,096 tokens x (2H + 2KV) x Dh x 2 B = 83.9 MB: 0.025 ms at
// 3.35 TB/s, against 0.017 ms (S 512) and 0.004 ms (S 128) of operations
// on the bf16 tensor cores.  Bytes bind; operations bind only at longer S.
//
// The bf16 kernel (flash_fwd_bf16), the one the serving path runs, is
// built to stream those bytes once and keep the tensor cores off the
// critical path:
//  - both products run as warpgroup wgmma on the bf16 tensor cores with
//    fp32 accumulation: s = Q K^T as m64n64k16 with both operands in
//    shared memory, acc += P V as m64n{Dh}k16 with P from registers;
//  - operands stay bf16 in shared memory, in the 128-byte (64- or 32-byte
//    at small Dh) swizzle that TMA writes and wgmma reads, so 8 rows never
//    share a bank group;
//  - one thread starts TMA loads (cp.async.bulk.tensor) of 64-key K and V
//    tiles into a ring of two stages with mbarriers (K full, V full,
//    empty; QK^T starts before V has landed).  It refills a stage once
//    every warp has released it, so the copy of tile j + 1 runs under the
//    products on tile j, and warpgroups drift apart instead of meeting at
//    a block barrier each tile.  TMA reads nothing outside the (B, Sq |
//    Sk, H | KV, Dh) views and fills rows past their ends with zeros (0 x
//    NaN is NaN, so stale bits must never land);
//  - the online softmax runs in registers on the accumulator fragments
//    (row max and sum over the quad of lanes sharing a row, log2 domain);
//    P is rounded to bf16 in registers as the A operand of P V, so scores
//    never touch shared memory;
//  - a block is two warpgroups of 64 query rows, 128 positions of one
//    head, so each K/V tile loaded serves 128 rows; at 128 registers and
//    97 KB of shared memory two blocks fit on an SM, and one's loads
//    overlap the other's products.  Grouped-query reuse (the two
//    warpgroups as two query heads of one KV head) was measured no faster
//    on the H100, so a block takes one head;
//  - causal: tiles above the diagonal are skipped, only the diagonal tile
//    is masked; query tiles are handed out heaviest first (the tile index
//    is the grid's slowest axis, reversed).
// A producer warpgroup with setmaxnreg, intra-warpgroup overlap of the
// next QK^T with this tile's softmax, and a persistent grid are later work.
//
// The fp32 kernel (flash_fwd_fp32) keeps the first port's FMA body on the
// CUDA cores: the checks hold fp32 to 2e-5, which TF32 products would not
// meet, and the serving path never sends fp32 here.
//
// Training asks either kernel for each query row's log-sum-exp of its
// scores as well (an fp32 (B, H, Sq) output, written only when its
// pointer is not null): the backward rebuilds the probabilities from it.
// Serving passes null, and its launches are as they were.
//
// Unlike the TPU kernel both read q, k, v in the model's (B, Sq | Sk,
// H | KV, Dh) layout through strides (no transposed copies) and mask a
// ragged Sq or Sk themselves (no padding to the tile size).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;
using bf16 = __nv_bfloat16;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, H, KV;  // query rows, key rows, heads
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale;
  int causal;
  float* lse;  // (B, H, Sq) log-sum-exp of each row's scores; null: none
};

// ---------------------------------------------------------------- fp32 --

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block

template <int DH>
constexpr size_t fp32_smem_bytes() {
  return (BQ * DH + BK * (DH + 4) + BQ * (BK + 4) + 3 * BQ) * sizeof(float);
}

// One block owns a 64-row query tile; products read shared memory as
// float4, and each thread keeps a register tile of scores (16) and of
// output rows (Dh / 4 for Dh = 128).
template <int DH>
__global__ void __launch_bounds__(NT) flash_fwd_fp32(FlashParams p) {
  using T = float;
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

  repro::load_rows<T, DH, NT>(Qs, DH, q, p.q_ss, q0, p.Sq, BQ);
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  int n_tiles = (p.Sk + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  const int qk_c = tid % BK, qk_r = tid / BK;
  const int pv_c = tid % DH, pv_r = tid / DH;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q is loaded; the last tile's P.V is done with KVs, Ps
    repro::load_rows<T, DH, NT>(KVs, KP, k, p.k_ss, k0, p.Sk, BK);
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
      const bool keep = col < p.Sk && (!p.causal || col <= q0 + r);
      Ps[r * PP + qk_c] = keep ? sc[j] * p.scale : NEG_INF;
    }
    __syncthreads();  // scores are written and K is no longer read

    repro::load_rows<T, DH, NT>(KVs, KP, v, p.v_ss, k0, p.Sk, BK);
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
    if (q0 + r < p.Sq) {
      o[static_cast<int64_t>(q0 + r) * p.o_ss + pv_c] =
          acc[i] / fmaxf(l_s[r], 1e-30f);
    }
  }
  if (p.lse && tid < BQ && q0 + tid < p.Sq)
    p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + q0 + tid] =
        m_s[tid] + logf(l_s[tid]);
}

// ---------------------------------------------------------------- bf16 --

constexpr int NWG = 2;          // warpgroups per block, 64 query rows each
constexpr int GNT = 128 * NWG;  // threads per block
constexpr int GK = 64;          // keys per K/V tile
constexpr int STAGES = 2;       // K/V ring depth

// Q (64 rows per warpgroup), then STAGES x (K tile, V tile), in the
// swizzled layout (1024-byte aligned); then the mbarriers: K full, V full
// and empty per stage, then Q.
template <int DH>
constexpr size_t wg_smem_bytes() {
  return 1024 + (64 * NWG + 2 * STAGES * GK) * DH * sizeof(bf16) +
         (3 * STAGES + 1) * sizeof(uint64_t);
}

// The accumulator of m64nN (PTX ISA): warp w of the warpgroup holds rows
// 16 w + g and 16 w + g + 8; d[4 i + e] is column 8 i + 2 t + (e & 1) of
// row g + 8 (e >> 1), the layout of mma.m16n8k16's fragments side by side;
// A from registers takes mma.m16n8k16's A layout in each warp.
//
// A block holds NWG warpgroups of 64 query rows each, NWG x 64 positions
// of one query head; each K/V tile it loads serves all of them.
// Thread 0 also starts the TMA loads: it keeps up to STAGES tiles in
// flight, refilling a stage once every warp has released it, and blocks
// only when the tile it needs itself is not requested yet; so the warpgroups
// run apart by up to STAGES - 1 tiles, and one's softmax overlaps
// another's products.
template <int DH>
__global__ void __launch_bounds__(GNT, 2)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, FlashParams p,
                   Slots sq, Slots sk, Slots sv) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  constexpr int RB = Swz<DH>::RB, PANEL = 64 * RB / 2;  // elements a panel
  constexpr uint32_t TILE = GK * DH * sizeof(bf16);
  static_assert(DH % 16 == 0 && DH <= 128, "unsupported head size");

  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t{1023});
  bf16* Ks = Qs + NWG * 64 * DH;     // STAGES x GK x DH
  bf16* Vs = Ks + STAGES * GK * DH;  // STAGES x GK x DH
  uint64_t* fullk = reinterpret_cast<uint64_t*>(Vs + STAGES * GK * DH);
  uint64_t* fullv = fullk + STAGES;
  uint64_t* empty = fullv + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64 * NWG;  // heaviest first
  const int wq0 = q0 + 64 * wg;  // this warpgroup's positions
  const int kvh = h / (p.H / p.KV);
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  int n_tiles = (p.Sk + GK - 1) / GK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + 64 * NWG - 1) / GK + 1);

  // tile j into stage j % STAGES; K and V land on barriers of their own,
  // so that QK^T need not wait for V
  auto request = [&](int j) {
    const int st = j % STAGES;
    mbar_expect_tx(&fullk[st], TILE);
    for (int pn = 0; pn < Swz<DH>::PANELS; ++pn)
      tma_load(Ks + st * GK * DH + pn * PANEL, &tk, &fullk[st], pn * RB / 2,
               j * GK, kvh, b, sk);
    mbar_expect_tx(&fullv[st], TILE);
    for (int pn = 0; pn < Swz<DH>::PANELS; ++pn)
      tma_load(Vs + st * GK * DH + pn * PANEL, &tv, &fullv[st], pn * RB / 2,
               j * GK, kvh, b, sv);
  };
  int next = 0;  // thread 0: the first tile not requested yet
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&fullk[st], 1);
      mbar_init(&fullv[st], 1);
      mbar_init(&empty[st], 4 * NWG);  // one arrival per warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, NWG * 64 * DH * sizeof(bf16));
    for (int w = 0; w < NWG; ++w)
      for (int pn = 0; pn < Swz<DH>::PANELS; ++pn)
        tma_load(Qs + w * 64 * DH + pn * PANEL, &tq, qbar, pn * RB / 2,
                 q0 + 64 * w, h, b, sq);
    for (; next < min(n_tiles, STAGES); ++next) request(next);
  }
  __syncthreads();  // the barriers are initialised

  const int row0 = wq0 + 16 * warp + g;  // this thread's rows: row0, +8
  // K-major Q and K: a 16-deep step moves 32 B along the row, and to the
  // next panel after RB / 32 steps
  const uint64_t dq = wg_desc<DH>(Qs + wg * 64 * DH, 16, 8 * RB);
  auto kstep = [](int kc) {  // in the descriptor's 16-byte units
    return (kc % (RB / 32)) * 2 + (kc / (RB / 32)) * (64 * RB / 16);
  };
  const float scale = p.scale * LOG2E;   // scores in the log2 domain
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * GK, st = kt % STAGES;
    if (tid == 0) {  // refill released stages, at most STAGES tiles ahead
      for (; next < n_tiles && next < kt + STAGES; ++next) {
        const int parity = (next / STAGES - 1) & 1;
        if (next > kt && !mbar_test(&empty[next % STAGES], parity)) break;
        mbar_wait(&empty[next % STAGES], parity);
        request(next);
      }
    }
    __syncwarp();  // warp 0 meets again before its aligned wgmma
    mbar_wait(&fullk[st], (kt / STAGES) & 1);
    if (p.causal && k0 > wq0 + 63) {  // wholly above our rows
      if (lane == 0) mbar_arrive(&empty[st]);
      continue;
    }

    // s = Q K^T: Dh / 16 steps of m64n64k16, both operands K-major
    const uint64_t dk = wg_desc<DH>(Ks + st * GK * DH, 16, 8 * RB);
    float s[32];
    wgmma_fence();
    wgmma_ss_n64_first(s, dq, dk);
#pragma unroll
    for (int kc = 1; kc < DH / 16; ++kc)
      wgmma_ss_n64(s, dq + kstep(kc), dk + kstep(kc));
    wgmma_commit();
    wgmma_wait();
    reg_fence(s);

    // mask the ragged end and, on the diagonal, the future (only those
    // tiles; the scale is applied inside the exponent below)
    if (k0 + GK > p.Sk || (p.causal && k0 + GK > wq0 + 16 * warp)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (col >= p.Sk || (p.causal && col > row)) s[i] = NEG_INF;
      }
    }

    // online softmax on the fragments: a row lives in one quad of lanes;
    // m is kept scaled, in the log2 domain
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
        mx = fmaxf(mx, fmaxf(s[4 * nn + 2 * r], s[4 * nn + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * nn + 2 * r + e];
          x = fast_exp2(fmaf(x, scale, -m_new));
          sum += x;
        }
      l[r] = alpha[r] * l[r] + sum;  // this thread's share; the quad sums last
    }
    // rescale acc, unless no row of this warp has a new max (x 1 is exact)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {
        acc[4 * dn] *= alpha[0];
        acc[4 * dn + 1] *= alpha[0];
        acc[4 * dn + 2] *= alpha[1];
        acc[4 * dn + 3] *= alpha[1];
      }
    }

    // acc += P V: P rounded to bf16 in registers as the A operand, V
    // MN-major; four m64n{Dh}k16 steps of 16 keys
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
    const uint64_t dv = wg_desc<DH>(Vs + st * GK * DH, GK * RB, 8 * RB);
    mbar_wait(&fullv[st], (kt / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)  // 16 keys, 16 rows of RB bytes, a step
      wgmma_rs<DH>(acc, pa[j], dv + j * RB);
    wgmma_commit();
    wgmma_wait();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with st
  }

  // normalise, stage the warp's 16 rows in its own rows of the Q tile
  // (16-byte chunks XOR-swizzled by row against bank conflicts), and store
  // them 16 bytes a lane
  constexpr int SW = CH < 8 ? CH : 8;
  bf16* Os = Qs + (wg * 64 + warp * 16) * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const int rr = g + 8 * r;
    if (p.lse && t == 0 && row0 + 8 * r < p.Sq)  // m is log2, scaled
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + row0 + 8 * r] =
          (m[r] + log2f(l[r])) * 0.6931471805599453f;
#pragma unroll
    for (int dn = 0; dn < CH; ++dn)
      *reinterpret_cast<uint32_t*>(Os + rr * DH + (dn ^ (rr % SW)) * 8 +
                                   2 * t) =
          pack_bf16(acc[4 * dn + 2 * r] * inv, acc[4 * dn + 2 * r + 1] * inv);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int rr = i / CH, c = i % CH;
    const int row = wq0 + 16 * warp + rr;
    if (row < p.Sq)
      *reinterpret_cast<uint4*>(o + static_cast<int64_t>(row) * p.o_ss +
                                c * 8) =
          *reinterpret_cast<const uint4*>(Os + rr * DH + (c ^ (rr % SW)) * 8);
  }
}

// ------------------------------------------------------------- launch --

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

template <int DH>
cudaError_t launch_fp32(const FlashParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = fp32_smem_bytes<DH>();
  static bool configured = false;
  cudaError_t err = configure(flash_fwd_fp32<DH>, smem, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_fwd_fp32<DH><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16(const FlashParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes<DH>();
  static bool configured = false;
  cudaError_t err = configure(flash_fwd_bf16<DH>, smem, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  Slots sq, sk, sv;
  if ((err = make_map<DH>(&tq, &sq, p.q, p.Sq, p.H, B, p.q_ss, p.q_sh,
                      p.q_sb)) != cudaSuccess ||
      (err = make_map<DH>(&tk, &sk, p.k, p.Sk, p.KV, B, p.k_ss, p.k_sh,
                      p.k_sb)) != cudaSuccess ||
      (err = make_map<DH>(&tv, &sv, p.v, p.Sk, p.KV, B, p.v_ss, p.v_sh,
                      p.v_sb)) != cudaSuccess)
    return err;
  const int n_q = (p.Sq + 64 * NWG - 1) / (64 * NWG);
  if (B > 65535 || n_q > 65535) return cudaErrorInvalidValue;
  dim3 grid(p.H, B, n_q);
  flash_fwd_bf16<DH><<<grid, GNT, smem, stream>>>(tq, tk, tv, p, sq, sk, sv);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const FlashParams& p, int dtype, int B,
                   cudaStream_t stream) {
  if (dtype == 0) return launch_fp32<DH>(p, B, stream);
  if (dtype == 1) return launch_bf16<DH>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and o hold Sq rows, k and v Sk.
// Strides are in elements; the last dimension of every tensor is
// contiguous.  lse: null, or a contiguous (B, H, Sq) float32 buffer that
// receives each row's log-sum-exp of its scaled, masked scores (m + log
// l), which the backward (flash_attention_bwd.cu) reads.  Returns a
// cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Sk, int H, int KV, int DH, int64_t q_sb, int64_t q_ss,
    int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
    int causal, float* lse, void* stream) {
  FlashParams p{q,    k,    v,    o,    Sq,   Sk,   H,    KV,   q_sb,
                q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
                o_ss, o_sh, scale, causal, lse};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 16: return launch<16>(p, dtype, B, st);
    case 32: return launch<32>(p, dtype, B, st);
    case 64: return launch<64>(p, dtype, B, st);
    case 128: return launch<128>(p, dtype, B, st);
    default: return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory one block of flash_attention_fwd takes, in
// bytes, for dtype (0 = float32, 1 = bfloat16) and head size DH; 0 when
// there is no such instantiation.
extern "C" int flash_attention_smem_bytes(int dtype, int DH) {
  auto pick = [&](auto fp32, auto bf16) {
    return static_cast<int>(dtype == 0 ? fp32 : dtype == 1 ? bf16 : 0);
  };
  switch (DH) {
    case 16: return pick(fp32_smem_bytes<16>(), wg_smem_bytes<16>());
    case 32: return pick(fp32_smem_bytes<32>(), wg_smem_bytes<32>());
    case 64: return pick(fp32_smem_bytes<64>(), wg_smem_bytes<64>());
    case 128: return pick(fp32_smem_bytes<128>(), wg_smem_bytes<128>());
    default: return 0;
  }
}
