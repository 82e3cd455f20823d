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
// on the bf16 tensor cores.  Bytes bind; operations bind only at longer S:
// at whisper's encoder (B 16, S 1,500, 16 heads, Dh 64, full) 0.149 ms of
// operations against 0.059 ms of bytes, and at qwen3-0.6b's training shape
// (B 4, S 4,096, 16/8 heads, Dh 128, causal) 0.278 ms against 0.060.
//
// The bf16 kernel (flash_fwd_bf16), the one serving and training run,
// is built to keep the tensor cores fed and its exponentials under them:
//  - both products run as warpgroup wgmma with fp32 accumulation: s = Q K^T
//    as m64n64k16 with Q's fragments in registers (read once an item with
//    ldmatrix, which halves the shared-memory reads of the product that
//    had both operands there) and K in shared memory; acc += P V as
//    m64n{Dh}k16 with P from registers;
//  - operands stay bf16 in shared memory, in the 128-byte (64- or 32-byte
//    at small Dh) swizzle that TMA writes and wgmma reads;
//  - warp-specialised: three warpgroups, one block an SM.  setmaxnreg gives
//    the producer's warpgroup 24 registers a thread and the two consumer
//    warpgroups 240 (64,512 of the SM's 65,536).  One producer thread keeps
//    TMA loads (cp.async.bulk.tensor) of Q and of 64-key K and V tiles in
//    flight, into a ring as deep as shared memory holds (5 stages at Dh
//    128, 8 below), with full and empty mbarriers; K and V land on
//    barriers of their own.  A consumer warp releases a stage by arriving
//    at its empty barrier, never at a block barrier.  TMA reads nothing
//    outside the (B, Sq | Sk, H | KV, Dh) views and fills rows past their
//    ends with zeros (0 x NaN is NaN, so stale bits must never land);
//  - inside a consumer warpgroup, tile j's online softmax runs under tile j
//    - 1's P V and tile j + 1's QK^T, issued together just before it (its
//    scores in a second register fragment, so a consumer holds three
//    tiles and the ring needs three stages or more).  A step issues its
//    products and waits for them with no branch in between, or ptxas
//    serialises them (C7513): the diagonal and ragged tiles' elementwise
//    mask is a copy of the step of its own, chosen for the warpgroup, and
//    acc's rescale is unconditional (x 1 is exact);
//  - the softmax runs in registers on the accumulator fragments (row max
//    and sum over the quad of lanes sharing a row, log2 domain, the scale
//    in one fma); P is rounded to bf16 in registers as the A operand of
//    P V, so scores never touch shared memory;
//  - persistent: min(items, SMs) blocks, each walking the work items (128
//    query rows of one head of one sequence) blockIdx.x, + gridDim.x, ...,
//    heaviest first (the query tile the slowest index, from the last), by
//    a static stride: no counter, no workspace.  The ring's and Q's
//    mbarrier parities run on across items; the next item's Q loads once
//    both consumers hold this item's in registers, under this item's
//    products and epilogue.  O is staged in a tile of its own (no TMA
//    reads or writes it, so no proxy fence is needed), 16 bytes a lane;
//  - an item's two 64-row halves alternate between the consumers: under
//    the causal mask the upper half reads one tile fewer (tiles wholly
//    above the diagonal are never loaded), so over two items both do the
//    same work, and the ring lets them drift apart instead of waiting.
// None of this moves a rounding point: the arithmetic and its order are
// emulate.attention_bf16_emulated's.  Measured on the H100 and left out
// (PERF.md): ping-pong between the consumers (named barriers around each
// step's products), up to 6% slower at four of the six timed shapes.
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

constexpr int CWG = 2;                // consumer warpgroups, 64 query rows each
constexpr int GNT = 128 * (CWG + 1);  // threads a block, the producer's too
constexpr int ROWS = 64 * CWG;        // query rows of a work item
constexpr int GK = 64;                // keys per K/V tile
constexpr int PRODUCER_REGS = 24;     // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 240;
constexpr int MAX_STAGES = 8;         // the K/V ring's depth at most
constexpr size_t SMEM_MAX = 232448;   // a block's shared memory on Hopper

// Q (64 rows per consumer warpgroup), O's staging rows as many, then
// `stages` x (K tile, V tile), in the swizzled layout (1024-byte aligned);
// then the mbarriers: K full, V full and empty per stage, Q full, Q empty.
template <int DH>
__host__ __device__ constexpr size_t smem_for(int stages) {
  return 1024 + (2 * ROWS + 2 * stages * GK) * DH * sizeof(bf16) +
         (3 * stages + 2) * sizeof(uint64_t);
}
// The K/V ring's depth: as many stages as fit, at most MAX_STAGES.
template <int DH>
__host__ __device__ constexpr int ring_stages() {
  int n = MAX_STAGES;
  while (smem_for<DH>(n) > SMEM_MAX) --n;
  return n;
}
template <int DH>
constexpr size_t wg_smem_bytes() {
  return smem_for<DH>(ring_stages<DH>());
}

// A work item: query rows q0 .. q0 + ROWS - 1 of head h of sequence b.
struct Item {
  int q0, h, b;
};

// Item w of n_q x B x H, heaviest first: the query tile is the slowest
// index, from the last one, then the sequence, then the head.
__device__ __forceinline__ Item item_of(int w, int n_q, int H, int B) {
  const int bh = H * B, r = w % bh;
  return {(n_q - 1 - w / bh) * ROWS, r % H, r / H};
}

// The K/V tiles an item's block loads: every one of Sk's, or, causal,
// those at or left of its last row.
__device__ __forceinline__ int item_tiles(int q0, const FlashParams& p) {
  const int n = (p.Sk + GK - 1) / GK;
  return p.causal ? min(n, (q0 + ROWS - 1) / GK + 1) : n;
}

// This warp's 16 rows of a warpgroup's 64-row Q tile, every column, as
// the A fragments of Dh / 16 steps, read with ldmatrix through the tile's
// swizzle (a 16-byte chunk's index XOR the byte offset's bits 7..).
template <int DH>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DH / 16][4],
                                       const bf16* Q, int warp, int lane) {
  constexpr uint32_t RB = Swz<DH>::RB, MASK = RB / 16 - 1;
  const uint32_t row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const char* base = reinterpret_cast<const char*>(Q);
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    const uint32_t byte = 2 * (16 * kc + 8 * (lane >> 4));
    const uint32_t off = byte / RB * 64 * RB + row * RB + byte % RB;
    ldmatrix_x4(qa[kc], base + (off ^ (((off >> 7) & MASK) << 4)));
  }
}

// s = Q K^T of one tile: Dh / 16 steps of m64n64k16, Q's fragments in
// registers, K K-major in shared memory (a 16-deep step moves 32 B along
// the row, and to the next panel after RB / 32 steps, in the descriptor's
// 16-byte units).  Committed as one group.
template <int DH>
__device__ __forceinline__ void qk_issue(float (&s)[32],
                                         const uint32_t (&qa)[DH / 16][4],
                                         const bf16* K) {
  constexpr int RB = Swz<DH>::RB;
  const uint64_t dk = wg_desc<DH>(K, 16, 8 * RB);
  wgmma_fence();
  wgmma_rs_n64_first(s, qa[0], dk);
#pragma unroll
  for (int kc = 1; kc < DH / 16; ++kc) {
    const int step = (kc % (RB / 32)) * 2 + (kc / (RB / 32)) * (64 * RB / 16);
    wgmma_rs_n64(s, qa[kc], dk + step);
  }
  wgmma_commit();
}

// acc += P V: P (bf16, registers) the A operand, V MN-major; four
// m64n{Dh}k16 steps of 16 keys.  Committed as one group.
template <int DH>
__device__ __forceinline__ void pv_issue(float (&acc)[DH / 2],
                                         const uint32_t (&pa)[4][4],
                                         const bf16* V) {
  constexpr int RB = Swz<DH>::RB;
  const uint64_t dv = wg_desc<DH>(V, GK * RB, 8 * RB);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)  // 16 keys, 16 rows of RB bytes, a step
    wgmma_rs<DH>(acc, pa[j], dv + j * RB);
  wgmma_commit();
}

// -1e30 at keys past Sk and, causal, right of the row: the thread's rows
// are row0 and row0 + 8, s[i] is key k0 + 8 (i >> 2) + 2 t + (i & 1) of
// row row0 + 8 ((i >> 1) & 1).  The scale is applied in the exponent.
__device__ __forceinline__ void mask_tile(float (&s)[32], int k0, int row0,
                                          const FlashParams& p) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
    const int row = row0 + 8 * ((i >> 1) & 1);
    if (col >= p.Sk || (p.causal && col > row)) s[i] = NEG_INF;
  }
}

// The online softmax of one tile on the fragments, in place: a row lives
// in one quad of lanes; m is kept scaled, in the log2 domain, and s
// becomes exp2(s scale - m_new); l gathers this thread's share (the quad
// sums last); alpha is acc's rescale.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale) {
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
    l[r] = alpha[r] * l[r] + sum;
  }
}

// acc *= alpha, every tile: x 1 is exact, and a test here, between a
// step's products and their wait, was measured slower than the multiplies.
template <int DH>
__device__ __forceinline__ void rescale(float (&acc)[DH / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn) {
    acc[4 * dn] *= alpha[0];
    acc[4 * dn + 1] *= alpha[0];
    acc[4 * dn + 2] *= alpha[1];
    acc[4 * dn + 3] *= alpha[1];
  }
}

// P rounded to bf16 in registers, as four A fragments of 16 keys.
__device__ __forceinline__ void to_p(uint32_t (&pa)[4][4],
                                     const float (&s)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
}

// A step's mask, chosen at compile time.
struct On {
  static constexpr bool value = true;
};
struct Off {
  static constexpr bool value = false;
};

// A warp's 16 rows (wrow0..): each row's lse, then acc normalised and
// rounded once, staged in the warp's own rows of the O tile (16-byte
// chunks XOR-swizzled by row against bank conflicts) and stored 16 bytes
// a lane.  Nothing but these stores touches the O tile.
template <int DH>
__device__ __forceinline__ void store_item(float (&acc)[DH / 2],
                                           const float (&m)[2], float (&l)[2],
                                           bf16* Ow, const FlashParams& p,
                                           const Item& x, int wrow0) {
  constexpr int CH = DH / 8, SW = CH < 8 ? CH : 8;  // 16-byte chunks a row
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* o = static_cast<bf16*>(p.o) + x.b * p.o_sb + x.h * p.o_sh;
  __syncwarp();  // the lanes are done reading the last item's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const int rr = g + 8 * r, row = wrow0 + rr;
    if (p.lse && t == 0 && row < p.Sq)  // m is log2, scaled
      p.lse[(static_cast<int64_t>(x.b) * p.H + x.h) * p.Sq + row] =
          (m[r] + log2f(l[r])) * 0.6931471805599453f;
#pragma unroll
    for (int dn = 0; dn < CH; ++dn)
      *reinterpret_cast<uint32_t*>(Ow + rr * DH + (dn ^ (rr % SW)) * 8 +
                                   2 * t) =
          pack_bf16(acc[4 * dn + 2 * r] * inv, acc[4 * dn + 2 * r + 1] * inv);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int rr = i / CH, c = i % CH;
    if (wrow0 + rr < p.Sq)
      *reinterpret_cast<uint4*>(o + static_cast<int64_t>(wrow0 + rr) *
                                        p.o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(Ow + rr * DH + (c ^ (rr % SW)) * 8);
  }
}

// The accumulator of m64nN (PTX ISA): warp w of the warpgroup holds rows
// 16 w + g and 16 w + g + 8; d[4 i + e] is column 8 i + 2 t + (e & 1) of
// row g + 8 (e >> 1), the layout of mma.m16n8k16's fragments side by side;
// an A operand from registers takes mma.m16n8k16's A layout in each warp.
//
// Three warpgroups: warpgroup 0 the producer (one thread starts every TMA
// load), 1 and 2 the consumers, 64 query rows each.  A block walks the
// work items blockIdx.x, + gridDim.x, ...; the ring's tile count `it` and
// the item count `n` run alike in all three, and give every mbarrier's
// parity.
template <int DH>
__global__ void __launch_bounds__(GNT, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, FlashParams p,
                   Slots sq, Slots sk, Slots sv, int B, int n_q) {
  constexpr int TILE = GK * DH;
  constexpr uint32_t TILE_BYTES = TILE * sizeof(bf16);
  constexpr int STAGES = ring_stages<DH>();
  static_assert(DH % 16 == 0 && DH <= 128, "unsupported head size");
  static_assert(STAGES >= 3, "a consumer holds three tiles at once");

  extern __shared__ float4 smem4[];
  bf16* Qs = align1024(smem4);
  bf16* Os = Qs + ROWS * DH;
  bf16* Ks = Os + ROWS * DH;      // STAGES tiles
  bf16* Vs = Ks + STAGES * TILE;  // STAGES tiles
  uint64_t* fullk = reinterpret_cast<uint64_t*>(Vs + STAGES * TILE);
  uint64_t* fullv = fullk + STAGES;
  uint64_t* empty = fullv + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 1;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_items = n_q * B * p.H;
  const int G = p.H / p.KV;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&fullk[st], 1);
      mbar_init(&fullv[st], 1);
      mbar_init(&empty[st], 4 * CWG);  // one arrival per consumer warp
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 4 * CWG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised

  if (wg == 0) {  // the producer
    regs_dec<PRODUCER_REGS>();
    if (tid == 0) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
        const Item x = item_of(w, n_q, p.H, B);
        const int T = item_tiles(x.q0, p), kvh = x.h / G;
        // the next item's Q as soon as both consumers hold this one's in
        // registers
        if (n > 0) mbar_wait(qempty, (n - 1) & 1);
        mbar_expect_tx(qfull, ROWS * DH * sizeof(bf16));
        for (int c = 0; c < CWG; ++c)
          tma_tile<DH>(Qs + c * 64 * DH, &tq, qfull, x.q0 + 64 * c, x.h, x.b,
                       sq);
        // K and V land on barriers of their own, so that QK^T need not
        // wait for V
        for (int j = 0; j < T; ++j, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
          mbar_expect_tx(&fullk[st], TILE_BYTES);
          tma_tile<DH>(Ks + st * TILE, &tk, &fullk[st], j * GK, kvh, x.b, sk);
          mbar_expect_tx(&fullv[st], TILE_BYTES);
          tma_tile<DH>(Vs + st * TILE, &tv, &fullv[st], j * GK, kvh, x.b, sv);
        }
      }
    }
  } else {  // a consumer
    regs_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const float scale = p.scale * LOG2E;  // scores in the log2 domain
    bf16* Ow = Os + (c * 64 + warp * 16) * DH;  // this warp's 16 rows
    int it = 0, n = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
      const Item x = item_of(w, n_q, p.H, B);
      const int T = item_tiles(x.q0, p);
      // The item's two halves alternate between the warpgroups: under the
      // causal mask the upper half reads one tile fewer, so over two items
      // both do the same work, and the ring lets them drift apart.
      const int half = c ^ (n & 1);
      const int wq0 = x.q0 + 64 * half;  // this warpgroup's rows
      // tiles at or left of our last row; the block's others we release
      const int M = p.causal ? min(T, (wq0 + 63) / GK + 1) : T;
      const int row0 = wq0 + 16 * warp + (lane >> 2);  // rows row0, +8
      auto st_of = [&](int j) { return (it + j) % STAGES; };
      auto par_of = [&](int j) { return ((it + j) / STAGES) & 1; };
      auto release = [&](int j) {  // this warp is done with tile j's stage
        if (lane == 0) mbar_arrive(&empty[st_of(j)]);
      };
      // the ragged end and, on the diagonal, the future: only those tiles
      // are masked, decided for the warpgroup as a whole
      auto masked = [&](int j) {
        return j * GK + GK > p.Sk || (p.causal && j * GK + GK > wq0);
      };
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
      float acc[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
      uint32_t qa[DH / 16][4], pa[4][4];
      mbar_wait(qfull, n & 1);
      load_q<DH>(qa, Qs + half * 64 * DH, warp, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(qempty);  // Q is in registers

      // Tile j's softmax runs under tile j - 1's P V and tile j + 1's
      // QK^T, issued together just before it (the first tile lacks the
      // one, the last the other), its scores in a second fragment.  A step
      // issues and waits for its products with no branch in between, or
      // ptxas serialises them: the mask is a copy of the step of its own.
      float sa[32], sb[32];
      auto soft = [&](auto mk, int j, float(&s)[32]) {
        if constexpr (decltype(mk)::value) mask_tile(s, j * GK, row0, p);
        softmax_tile(s, m, l, alpha, scale);
      };
      auto first = [&](auto mk) {  // S_1 under tile 0's softmax
        mbar_wait(&fullk[st_of(1)], par_of(1));
        qk_issue<DH>(sb, qa, Ks + st_of(1) * TILE);
        soft(mk, 0, sa);  // acc is 0: no rescale
        to_p(pa, sa);
        wgmma_wait<0>();
        reg_fence(sb);
      };
      auto mid = [&](auto mk, int j, float(&cur)[32], float(&nxt)[32]) {
        mbar_wait(&fullk[st_of(j + 1)], par_of(j + 1));
        mbar_wait(&fullv[st_of(j - 1)], par_of(j - 1));
        pv_issue<DH>(acc, pa, Vs + st_of(j - 1) * TILE);
        qk_issue<DH>(nxt, qa, Ks + st_of(j + 1) * TILE);
        soft(mk, j, cur);
        wgmma_wait<1>();  // tile j - 1's P V is done
        reg_fence(acc);
        release(j - 1);
        rescale<DH>(acc, alpha);
        to_p(pa, cur);
        wgmma_wait<0>();  // tile j + 1's scores are in
        reg_fence(nxt);
      };
      auto last = [&](auto mk, int j, float(&cur)[32]) {
        mbar_wait(&fullv[st_of(j - 1)], par_of(j - 1));
        pv_issue<DH>(acc, pa, Vs + st_of(j - 1) * TILE);
        soft(mk, j, cur);
        wgmma_wait<0>();
        reg_fence(acc);
        release(j - 1);
        rescale<DH>(acc, alpha);
        to_p(pa, cur);
      };
      mbar_wait(&fullk[st_of(0)], par_of(0));
      qk_issue<DH>(sa, qa, Ks + st_of(0) * TILE);
      wgmma_wait<0>();
      reg_fence(sa);
      if (M == 1) {
        if (masked(0)) soft(On{}, 0, sa); else soft(Off{}, 0, sa);
        to_p(pa, sa);  // acc is 0: no rescale
      } else if (masked(0)) {
        first(On{});
      } else {
        first(Off{});
      }
      for (int j = 1; j + 1 < M; ++j) {  // S_j is in sb for odd j
        if (masked(j)) {
          if (j & 1) mid(On{}, j, sb, sa); else mid(On{}, j, sa, sb);
        } else {
          if (j & 1) mid(Off{}, j, sb, sa); else mid(Off{}, j, sa, sb);
        }
      }
      if (M > 1) {
        const int j = M - 1;
        if (masked(j)) {
          if (j & 1) last(On{}, j, sb); else last(On{}, j, sa);
        } else {
          if (j & 1) last(Off{}, j, sb); else last(Off{}, j, sa);
        }
      }
      mbar_wait(&fullv[st_of(M - 1)], par_of(M - 1));
      pv_issue<DH>(acc, pa, Vs + st_of(M - 1) * TILE);
      wgmma_wait<0>();
      reg_fence(acc);
      release(M - 1);
      for (int j = M; j < T; ++j) {  // tiles only the other half reads
        mbar_wait(&fullk[st_of(j)], par_of(j));
        release(j);
      }
      store_item<DH>(acc, m, l, Ow, p, x, wq0 + 16 * warp);
      it += T;
    }
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
  const int64_t n_q = (p.Sq + ROWS - 1) / ROWS;
  const int64_t items = n_q * B * p.H;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  // persistent: one block an SM at most, each walking items by a stride;
  // each device's SM count is read once
  static int sms_of[64] = {};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!sms_of[dev] &&
      (err = cudaDeviceGetAttribute(&sms_of[dev],
                                    cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return err;
  const int grid = static_cast<int>(items < sms_of[dev] ? items : sms_of[dev]);
  flash_fwd_bf16<DH><<<grid, GNT, smem, stream>>>(
      tq, tk, tv, p, sq, sk, sv, B, static_cast<int>(n_q));
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

// The threads of one block of flash_attention_fwd for dtype (0 = float32,
// 1 = bfloat16); 0 for another.
extern "C" int flash_attention_threads(int dtype) {
  return dtype == 0 ? NT : dtype == 1 ? GNT : 0;
}
