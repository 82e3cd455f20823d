// Decode (one query token) attention for Hopper (sm_90a), grouped-query:
// flash-decoding with the cache length split across the blocks of a
// cluster.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// decode_attention_grouped (body _decode_kernel).  Same function: the G
// query heads of one KV head attend to the cache positions t <= pos with
// an online softmax in fp32 (m, l, acc), mask value -1e30, l clamped at
// 1e-30, the output in q's dtype.  The TPU walks the cache along a
// sequential grid axis on its one core; here positions 0..pos may be cut
// into splits that run as blocks side by side and are merged at the end
// (flash-decoding, arXiv:2311.01282).
//
// What bounds it on the H100: every cache entry up to pos is read once and
// used for 4 * G flops, about 8 flops a byte at G 4, far below the 295 at
// which the card turns compute-bound, so bytes bind: at the serving cells
// (B 8, T 576 and B 32, T 256; KV 8, Dh 128, bf16) 18.9 and 33.5 MB, 0.0057
// and 0.0100 ms at 3.35 TB/s.  What the design does about it:
//  - the cache streams: a block is eight warps, and each warp owns chunks
//    of 8 positions of its split, round robin.  A warp keeps its next two
//    chunks of K and V in flight with 16-byte cp.async copies (bf16 stays
//    bf16 in shared memory) in a three-stage ring of its own, waited on by
//    cp.async.wait_group and __syncwarp: no block-wide barrier per tile;
//    8 KB in flight a warp, 128 KB an SM at two blocks;
//  - few instructions a byte.  A first version did the dot products on
//    the CUDA cores, reduced by shuffles, and was bound by instruction
//    issue, not by memory.  In bf16 both products run on the tensor cores
//    with fp32 accumulation, fed from the ring by ldmatrix:
//      S (heads x 8 positions) = q K^T as mma m16n8k16, the G <= 8 heads
//      as rows, q in registers for the whole split;
//      acc^T (Dh x heads) += V^T P^T as mma m16n8k8, where P^T's fragment
//      is the lane's own two scores of S, exponentiated and rounded to
//      bf16: no shuffle and no shared memory between the two products.
//    The ring holds 16-byte pieces XOR-swizzled by row, so ldmatrix's 8
//    rows fall in different banks.  The softmax runs on the fragments in
//    the log2 domain (the scale folded into one FMA, as in K2), and acc is
//    rescaled only when a head's maximum moves.  fp32, which the tensor
//    cores cannot take at 2e-5, keeps a CUDA-core body in the same ring: a
//    row over Dh / 4 lanes, dot products reduced by shuffles;
//  - splits only where they pay: the grid is (KV * head chunks, B,
//    n_split), and the splits of one (b, head chunk) form a cluster.  The
//    host (kernels/decode_attention/kernel.py::split_count) adds splits
//    while the grid stays within one block for every two SMs, up to 8 and
//    up to the cache's tiles: sixty-four 8-warp blocks already draw what
//    the card's memory gives this access pattern, and a split costs its
//    merge.  The grid does not depend on pos: the kernel reads pos from
//    device memory and cuts 0..pos itself into at most n_split splits of
//    whole 64-position tiles, none starting past pos (kernel.py::
//    splits_of); a block past them computes nothing but takes part in the
//    cluster's barriers and writes.  So one launch, captured in a CUDA
//    graph, serves every position, and for one shape, pos and card the
//    plan is fixed, so the result is deterministic;
//  - rows past pos are never read (the copy of such a row reads 0 bytes
//    and writes zeros, and its weight is 0), so stale or NaN slots cannot
//    reach the result; the cache is read in place in the model's
//    (B, T, KV, Dh) layout through strides;
//  - merges in a fixed order, inside the launch: a block merges its eight
//    warps in warp order in shared memory.  With one split it writes the
//    output.  Otherwise it leaves its split's fp32 (m, l, acc) in its
//    shared memory; after a cluster barrier each block reads every split's
//    part through distributed shared memory, merges them in split order
//    with weights 2^(m_i - M) and writes its share of the output; a second
//    barrier keeps every part alive until read.  No workspace, no counter
//    and no second launch: a merge through a global workspace (a second
//    kernel, or the last block found by a counter) cost more on the H100
//    than the splits won.
// Head groups larger than 8 are cut into chunks of 8 heads, a block each.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;    // positions: a split is a whole number of tiles
constexpr int NW = 8;       // warps a block
constexpr int NT = 32 * NW;
constexpr int STAGES = 3;   // chunks a warp has in its ring
constexpr int CH = 8;       // positions a chunk
constexpr int GMAX = 8;     // query heads a block at most
constexpr int MAX_SPLIT = 8;  // splits of one (b, kv head): a cluster
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const long long* pos;  // one value in device memory
  int G, n_hc, T, n_split;
  int64_t q_sb, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_sh;
  float scale;
};

// What one warp needs to stream its chunks of one split.
struct WarpJob {
  int t_begin, t_end;  // the split's positions, t_end <= pos + 1
  int mine;            // chunks of this warp
  int warp, lane;
  __device__ int chunk0(int j) const { return t_begin + (warp + j * NW) * CH; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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

// Dynamic shared memory of a block: the warps' rings, later reused for
// the merge of the warps (NW x GMAX heads x (DH + 2) floats) and the
// split's merged (m, l, acc) that the other blocks of its cluster read.
template <int DH, int PIECES_A_STAGE>
constexpr size_t block_smem() {
  constexpr size_t ring = NW * STAGES * PIECES_A_STAGE * 16;
  constexpr size_t merge = (NW + 1) * GMAX * (DH + 2) * sizeof(float);
  return ring > merge ? ring : merge;
}

// ------------------------------------------------------------ fp32 body --
// A row of DH over LPR = DH / 4 lanes, RPI = 32 / LPR rows a warp-wide
// copy, RPL rows of a chunk a lane; each lane reads back only the pieces
// it copied, and the dot products are reduced by shuffles.

template <int DH>
struct FmaBody {
  static constexpr int VEC = 4;
  static constexpr int LPR = DH / VEC;
  static constexpr int RPI = 32 / LPR;
  static constexpr int RPL = CH / RPI;
  static constexpr int STAGE = 2 * RPL * 32;  // 16-byte pieces: K, then V
  static_assert(RPL >= 1 && LPR <= 32, "unsupported head size");

  // Streams the warp's chunks; leaves its (m, l, acc) in mw / lw / aw.
  static __device__ void run(const DecodeParams& p, const WarpJob& w,
                             const float* qb, const float* kb,
                             const float* vb, int ng, uint4* ring, float* mw,
                             float* lw, float* aw) {
    const int lane = w.lane, sub = lane / LPR, col = (lane % LPR) * VEC;
    const float c = p.scale * LOG2E;  // scores in the log2 domain
    float qr[GMAX][VEC];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < ng) {
        const float4 x =
            *reinterpret_cast<const float4*>(qb + g * p.q_sh + col);
        qr[g][0] = x.x * c;
        qr[g][1] = x.y * c;
        qr[g][2] = x.z * c;
        qr[g][3] = x.w * c;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[g][e] = 0.f;
      }
    }
    float m[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
    }
    auto issue = [&](int j) {
      if (j < w.mine) {
        uint4* st = ring + (j % STAGES) * STAGE;
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          const int t = w.chunk0(j) + i * RPI + sub;
          const bool ok = t < w.t_end;
          const int64_t row = ok ? t : w.t_begin;
          cp_async16(st + i * 32 + lane, kb + row * p.k_st + col, ok);
          cp_async16(st + (RPL + i) * 32 + lane, vb + row * p.v_st + col, ok);
        }
      }
      cp_async_commit();  // empty groups keep the count of groups in step
    };
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) issue(j);

    for (int j = 0; j < w.mine; ++j) {
      issue(j + STAGES - 1);        // into the stage chunk j - 1 has left
      cp_async_wait<STAGES - 1>();  // this lane's copies of chunk j landed
      const uint4* st = ring + (j % STAGES) * STAGE;
      const int r0 = w.chunk0(j) + sub;
      float s[RPL][GMAX];
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const float4 k4 = *reinterpret_cast<const float4*>(st + i * 32 + lane);
        const float kf[VEC] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
          for (int off = 1; off < LPR; off <<= 1)
            d += __shfl_xor_sync(FULL, d, off);
          s[i][g] = d;
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float cm = NEG_INF;
#pragma unroll
        for (int i = 0; i < RPL; ++i)
          if (r0 + i * RPI < w.t_end) cm = fmaxf(cm, s[i][g]);
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1)
          cm = fmaxf(cm, __shfl_xor_sync(FULL, cm, off));
        const float m_new = fmaxf(m[g], cm);
        const float alpha = exp2f(m[g] - m_new);
        m[g] = m_new;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const bool ok = r0 + i * RPI < w.t_end;
        const float4 v4 = *reinterpret_cast<const float4*>(st + (RPL + i) * 32 + lane);
        const float vf[VEC] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          const float pr = ok ? exp2f(s[i][g] - m[g]) : 0.f;
          l[g] += pr;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
        }
      }
    }
    cp_async_wait<0>();
    // the lanes of one row agree: add across the rows of a warp-wide copy
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) {
        l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
      }
    }
    __syncthreads();  // every warp is done with its ring
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        mw[w.warp * GMAX + g] = m[g];
        lw[w.warp * GMAX + g] = l[g];
      }
    }
    if (lane < LPR) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          aw[(w.warp * GMAX + g) * DH + col + e] = acc[g][e];
    }
  }
};

// ------------------------------------------------------------ bf16 body --
// A chunk is 8 rows of K and of V, each row DH / 8 pieces of 16 bytes;
// piece c of row r sits at slot r * NP + (c ^ (r % NP)), so the 8 rows of
// one ldmatrix hit 8 different bank groups (NP >= 8; at Dh 32 and 16 two
// rows share one).  The heads are the rows of S = q K^T (rows 8..15 of
// the m16 tile are zero), the columns of acc^T = V^T P^T.

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
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(ptr)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(ptr)));
}

// d += a b: m16n8k16, bf16 in, fp32 accumulate (a1 = a3 = 0: rows 8..15)
__device__ __forceinline__ void mma_k16(float (&d)[4], uint32_t a0,
                                        uint32_t a2, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
// d += a b: m16n8k8, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
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

template <int DH>
struct MmaBody {
  static constexpr int NP = DH / 8;         // pieces a row
  static constexpr int PIECES = CH * NP;    // of K (or V) a chunk
  static constexpr int STAGE = 2 * PIECES;  // K, then V
  static constexpr int PPL = (PIECES + 31) / 32;  // pieces a lane copies
  static constexpr int KS = DH / 16;        // k16 steps of q K^T
  static constexpr int MT = DH / 16;        // m16 tiles of acc^T

  static __device__ int slot(int r, int c) { return r * NP + (c ^ (r % NP)); }

  static __device__ void run(const DecodeParams& p, const WarpJob& w,
                             const bf16* qb, const bf16* kb, const bf16* vb,
                             int ng, uint4* ring, float* mw, float* lw,
                             float* aw) {
    const int lane = w.lane, grp = lane >> 2, tig = lane & 3;
    const float c = p.scale * LOG2E;
    // q as the A operand of m16n8k16: row grp (a head), columns 2 tig, +1
    // (a0) and 8 + 2 tig, +1 (a2) of each k16 step
    uint32_t qa[KS][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (grp < ng) {
        const bf16* qr = qb + grp * p.q_sh + ks * 16 + 2 * tig;
        qa[ks][0] = *reinterpret_cast<const uint32_t*>(qr);
        qa[ks][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
      } else {
        qa[ks][0] = qa[ks][1] = 0u;
      }
    }
    // lane's state: m and l of head grp (l over its own columns), and
    // acc^T rows (dims) 16 mt + grp (+ 8), columns (heads) 2 tig, +1
    float m = NEG_INF, l = 0.f;
    float acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

    auto issue = [&](int j) {
      if (j < w.mine) {
        uint4* st = ring + (j % STAGES) * STAGE;
#pragma unroll
        for (int i = 0; i < PPL; ++i) {
          const int piece = i * 32 + lane;
          if (piece < PIECES) {
            const int r = piece / NP, cc = piece % NP;
            const int t = w.chunk0(j) + r;
            const bool ok = t < w.t_end;
            const int64_t row = ok ? t : w.t_begin;
            cp_async16(st + slot(r, cc), kb + row * p.k_st + cc * 8, ok);
            cp_async16(st + PIECES + slot(r, cc), vb + row * p.v_st + cc * 8,
                       ok);
          }
        }
      }
      cp_async_commit();  // empty groups keep the count of groups in step
    };
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) issue(j);

    // ldmatrix: lane gives the address of row (lane & 7) of matrix
    // (lane >> 3); matrix i of a call covers pieces cb + i
    const int lr = lane & 7, lm = lane >> 3;
    for (int j = 0; j < w.mine; ++j) {
      issue(j + STAGES - 1);        // into the stage chunk j - 1 has left
      cp_async_wait<STAGES - 1>();  // this lane's copies of chunk j landed
      __syncwarp();                 // and every other lane's
      const uint4* st = ring + (j % STAGES) * STAGE;

      // S = q K^T for 8 positions: lane holds S[grp][2 tig], S[grp][2 tig+1]
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (NP >= 4) {
#pragma unroll
        for (int cb = 0; cb < NP; cb += 4) {
          uint32_t kf[4];
          ldsm_x4(kf, st + slot(lr, cb + lm));
          mma_k16(s, qa[cb / 2][0], qa[cb / 2][1], kf[0], kf[1]);
          mma_k16(s, qa[cb / 2 + 1][0], qa[cb / 2 + 1][1], kf[2], kf[3]);
        }
      } else {
        uint32_t kf[4];
        ldsm_x2(kf, st + slot(lr, lm & 1));
        mma_k16(s, qa[0][0], qa[0][1], kf[0], kf[1]);
      }
      const int t0 = w.chunk0(j) + 2 * tig;
      const bool ok0 = t0 < w.t_end, ok1 = t0 + 1 < w.t_end;
      float cm = fmaxf(ok0 ? s[0] : NEG_INF, ok1 ? s[1] : NEG_INF);
      cm = fmaxf(cm, __shfl_xor_sync(FULL, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(FULL, cm, 2));
      const float m_new = fmaxf(m, cm * c);
      const float p0 = ok0 ? fast_exp2(fmaf(s[0], c, -m_new)) : 0.f;
      const float p1 = ok1 ? fast_exp2(fmaf(s[1], c, -m_new)) : 0.f;
      if (__any_sync(FULL, m_new != m)) {
        // acc^T's columns are heads 2 tig and 2 tig + 1, whose alpha the
        // lanes 8 tig and 8 tig + 4 hold
        const float alpha = fast_exp2(m - m_new);
        const float a0 = __shfl_sync(FULL, alpha, 8 * tig);
        const float a1 = __shfl_sync(FULL, alpha, 8 * tig + 4);
        l *= alpha;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][0] *= a0;
          acc[mt][1] *= a1;
          acc[mt][2] *= a0;
          acc[mt][3] *= a1;
        }
      }
      m = m_new;
      l += p0 + p1;
      // acc^T += V^T P^T: P^T's fragment (k = positions 2 tig, +1; n =
      // head grp) is the lane's own pair
      const uint32_t pb = pack_bf16(p0, p1);
      if constexpr (NP >= 4) {
#pragma unroll
        for (int cb = 0; cb < NP; cb += 4) {
          uint32_t vf[4];
          ldsm_x4_t(vf, st + PIECES + slot(lr, cb + lm));
          mma_k8(acc[cb / 2], vf[0], vf[1], pb);
          mma_k8(acc[cb / 2 + 1], vf[2], vf[3], pb);
        }
      } else {
        uint32_t vf[4];
        ldsm_x2_t(vf, st + PIECES + slot(lr, lm & 1));
        mma_k8(acc[0], vf[0], vf[1], pb);
      }
      __syncwarp();  // every lane has read the stage before it is refilled
    }
    cp_async_wait<0>();
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    __syncthreads();  // every warp is done with its ring
    if (tig == 0) {
      mw[w.warp * GMAX + grp] = m;
      lw[w.warp * GMAX + grp] = l;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float* a = aw + (w.warp * GMAX + 2 * tig) * DH + 16 * mt + grp;
      a[0] = acc[mt][0];
      a[DH] = acc[mt][1];
      a[8] = acc[mt][2];
      a[DH + 8] = acc[mt][3];
    }
  }
};

template <typename T, int DH>
struct Body;
template <int DH>
struct Body<float, DH> : FmaBody<DH> {};
template <int DH>
struct Body<bf16, DH> : MmaBody<DH> {};

// ---------------------------------------------------------------- kernel --

template <typename T, int DH>
__global__ void __launch_bounds__(NT) decode_attn_split(DecodeParams p) {
  using Impl = Body<T, DH>;
  extern __shared__ uint4 smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kvh = blockIdx.x / p.n_hc, g0 = (blockIdx.x % p.n_hc) * GMAX;
  const int b = blockIdx.y, split = blockIdx.z;
  const int ng = min(GMAX, p.G - g0);  // query heads of this block
  const int h0 = kvh * p.G + g0;     // its first query head

  // the splits of positions 0..pos (kernel.py::splits_of), pos clamped
  // to the cache so that no value of it reads past the cache
  const int pos = static_cast<int>(
      min(max(*p.pos, -1LL), static_cast<long long>(p.T) - 1));
  const int n_tiles = max(pos, 0) / TILE + 1;
  const int per = (n_tiles + min(p.n_split, n_tiles) - 1) /
                  min(p.n_split, n_tiles);
  const int n_live = (n_tiles + per - 1) / per;
  const int split_rows = per * TILE;

  WarpJob w;
  w.t_begin = split * split_rows;
  w.t_end = split < n_live ? min(w.t_begin + split_rows, pos + 1)
                           : w.t_begin;  // past the splits: no rows
  const int n_chunks = (w.t_end - w.t_begin + CH - 1) / CH;
  w.mine = n_chunks > warp ? (n_chunks - warp + NW - 1) / NW : 0;
  w.warp = warp;
  w.lane = lane;

  float* mw = reinterpret_cast<float*>(smem);  // NW x GMAX, per warp
  float* lw = mw + NW * GMAX;                     // NW x GMAX
  float* aw = lw + NW * GMAX;                     // NW x GMAX x DH
  float* part = aw + NW * GMAX * DH;              // the split's (m, l, acc)
  Impl::run(p, w, static_cast<const T*>(p.q) + b * p.q_sb + h0 * p.q_sh,
            static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh,
            static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh, ng,
            smem + warp * STAGES * Impl::STAGE, mw, lw, aw);
  __syncthreads();

  // merge the warps in warp order (a warp with no rows has weight 0)
  T* out = static_cast<T*>(p.o) + b * p.o_sb + h0 * p.o_sh;
  for (int e = threadIdx.x; e < ng * DH; e += NT) {
    const int g = e / DH, c = e % DH;
    float M = NEG_INF;
#pragma unroll
    for (int i = 0; i < NW; ++i) M = fmaxf(M, mw[i * GMAX + g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float wt = exp2f(mw[i * GMAX + g] - M);
      ls = fmaf(wt, lw[i * GMAX + g], ls);
      as = fmaf(wt, aw[(i * GMAX + g) * DH + c], as);
    }
    if (p.n_split == 1) {
      out[g * p.o_sh + c] = repro::to_out<T>(as / fmaxf(ls, 1e-30f));
    } else {
      part[2 * GMAX + e] = as;
      if (c == 0) {
        part[g] = M;
        part[GMAX + g] = ls;
      }
    }
  }
  if (p.n_split == 1) return;

  // merge the live splits, which are the first blocks of this cluster, in
  // split order; block r writes the elements r, r + n_split, ... of 128
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's part is in its shared memory
  const int ns = p.n_split;
  for (int e = split * NT + threadIdx.x; e < ng * DH; e += ns * NT) {
    const int g = e / DH, c = e % DH;
    float M = NEG_INF;
    for (int r = 0; r < n_live; ++r)
      M = fmaxf(M, *cluster.map_shared_rank(part + g, r));
    float ls = 0.f, as = 0.f;
    for (int r = 0; r < n_live; ++r) {
      const float* pr = cluster.map_shared_rank(part, r);
      const float wt = exp2f(pr[g] - M);
      ls = fmaf(wt, pr[GMAX + g], ls);
      as = fmaf(wt, pr[2 * GMAX + e], as);
    }
    out[g * p.o_sh + c] = repro::to_out<T>(as / fmaxf(ls, 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its part
}

template <typename T, int DH>
constexpr size_t smem_bytes() {
  return block_smem<DH, Body<T, DH>::STAGE>();
}

template <typename T, int DH>
cudaError_t launch(const DecodeParams& p, int B, int KV, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DH>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attn_split<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_attn_split<T, DH>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // the splits of one (b, head chunk) form a cluster
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = p.n_split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV * p.n_hc, B, p.n_split);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_attn_split<T, DH>, p);
}

template <typename T>
cudaError_t dispatch(const DecodeParams& p, int B, int KV, int DH,
                     cudaStream_t stream) {
  switch (DH) {
    case 16: return launch<T, 16>(p, B, KV, stream);
    case 32: return launch<T, 32>(p, B, KV, stream);
    case 64: return launch<T, 64>(p, B, KV, stream);
    case 128: return launch<T, 128>(p, B, KV, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int smem_for(int DH) {
  switch (DH) {
    case 16: return static_cast<int>(smem_bytes<T, 16>());
    case 32: return static_cast<int>(smem_bytes<T, 32>());
    case 64: return static_cast<int>(smem_bytes<T, 64>());
    case 128: return static_cast<int>(smem_bytes<T, 128>());
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, H, Dh), k/v: (B, T, KV, Dh),
// o: (B, H, Dh), with H = KV * G and strides in elements; the last
// dimension of every tensor is contiguous.  pos: one int64 in device
// memory, read by the kernel.  Attends to t <= pos (pos clamped to
// [-1, T - 1]) in at most n_split (1 to 8, at most T's 64-position tiles)
// splits of whole tiles; the launch does not depend on pos.  Returns a
// cudaError_t.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* pos,
    int dtype, int B, int KV, int G, int DH, int T, int n_split,
    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb, int64_t o_sh,
    float scale, void* stream) {
  if (n_split < 1 || n_split > MAX_SPLIT || T < 1 ||
      static_cast<int64_t>(n_split - 1) * TILE >= T)
    return cudaErrorInvalidValue;
  DecodeParams p{q,    k,    v,    o,    static_cast<const long long*>(pos),
                 G,    (G + GMAX - 1) / GMAX, T, n_split, q_sb, q_sh, k_sb,
                 k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, KV, DH, st);
  if (dtype == 1) return dispatch<bf16>(p, B, KV, DH, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one block for a dtype code and head size; -1
// if not built.
extern "C" int decode_attention_smem_bytes(int dtype, int DH) {
  if (dtype == 0) return smem_for<float>(DH);
  if (dtype == 1) return smem_for<bf16>(DH);
  return -1;
}
