// K4: GBT training on the card, for sm_90a.  Three kernels:
//
//   gbt_grow   a whole fit in one launch: every tree of every problem,
//              histograms, split search, leaf values, tree entries, row
//              moves and the boosting update between trees, with the
//              fit's state in shared memory for the whole fit;
//   gbt_hist   the per-node gradient/hessian histograms of one tree level;
//   gbt_split  the split step that grows the level from them.
//
// `core.gbt.grow_forests` calls gbt_grow for a fit whose state fits a
// thread-block cluster's shared memory (`ops.fits_on_chip`: every fit of
// the ALA's path, the registry's and the Fig 7 GBTs), and otherwise grows
// the fit level by level, gbt_hist and gbt_split a level.  Both paths give
// the same trees bit for bit: gbt_grow's arithmetic is gbt_hist's contract
// and gbt_split's own device functions below.
//
// Replaces the TPU kernel `gbt_hist` (src/repro/kernels/gbt_hist/kernel.py,
// pallas_call in `gbt_hist`, body `_hist_kernel`), which builds
//     hist[f, b, {g, h}] = sum_n [bins[n, f] == b] * (grad_n, hess_n)
// as a one-hot matmul on the MXU (a TPU has no atomics) and separates tree
// nodes with one zero-masked pass per node; and the reference's float64
// numpy split search between launches (fit_packed_forest in
// src/repro/core/gbt.py).
//
// gbt_hist computes, batched over L problems and keyed by node in one
// launch:
//     out[l, node, f, b, {g, h}] = sum over rows n with node[l, n] == node
//                                   and bins[l, n, f] == b of (g, h)[l, n]
// A row whose node or bin id lies outside its range adds nothing.
//
// Contract: each output cell is the fp32 sum of its rows taken in
// increasing row order, starting from +0.0.  So two launches give the same
// bits, a problem gives the same bits alone or among L others, and a row of
// zero weight changes nothing (x + 0.0 == x), which makes compacted rows and
// zero-weighted rows histogram identically.  numpy's float32 `np.add.at`
// over the flat cell index adds in the same order and gives the same bits.
// Global atomics would not: their order changes from run to run, and with
// it ties between candidate splits.
//
// Histogram design: one block of 256 threads per (problem l, feature f,
// group of up to 256 cells), a cell being one (node, bin) pair owned by one
// thread.  Rows come in tiles of 2,048, the next tile's loads in flight
// while this one is summed.  Each of the 8 warps keys eight 32-row chunks
// of the tile in row order; a row's rank among its cell's rows in the warp
// comes from nine ballots (the lanes with the same key) and a per-warp
// count.  Counts scanned cell by cell, warp by warp, give every row its
// place in a copy of the tile bucketed by cell in shared memory, in row
// order within each cell (a stable counting sort), and the cell's thread
// sums its run in order.  The work is about n per feature and cell group,
// where the first design (one thread per cell walking every row) did n x
// cells compares.  A tile of at most 64 rows (Alg 3's 48-row problems,
// Alg 7's first 32-row log) skips the sort: its rows go to shared memory
// in order and every cell's thread reads them all, which takes one
// barrier where the sort takes four.
//
// gbt_split: one block of 256 threads per problem.  One thread per valid
// node sums feature 0's bins in numpy's pairwise order (Gtot, Htot) and
// takes the leaf value.  The (node, feature) rows of bins, staged in shared
// memory a round at a time, are cut into runs, one thread a run: it
// repeats the sequential float64 cumsum up to its run (so its GL and HL are
// np.cumsum's), computes the gain of fit_packed_forest for each bin and
// keeps numpy argmax's winner (the first NaN, else the first maximum: a
// total order, so a warp per node merges the runs in any order).  One
// thread numbers the children in node order and writes the tree; then
// every row moves to its child, or adds its leaf's value to pred and
// leaves the tree.  After the last level each row in the fit gets its next
// gradient and returns to the root.  All float64 arithmetic is written
// with _rn intrinsics, so no FMA contracts it and the trees equal the host
// loop's bit for bit.
//
// gbt_grow: one thread-block cluster per problem, the features split across
// its blocks (`grow_plan`: at most 8 blocks, the portable cluster size, so
// f <= 8 gives one feature a block and Alg 7's 24 three; fewer blocks when
// the problems are many, so that every cluster is resident at once, as
// cudaOccupancyMaxActiveClusters counts them on the card at hand: the
// registry's 114 problems take 2 blocks of 4 features).  Each block holds
// in shared memory, for the whole fit, a copy of the problem's rows (every
// feature's bin id as a byte, node, grad, hess, pred) and, for feature 0 and
// its own features, the rows sorted by bin (ids in row order, built once).
// A level:
//   1. thread (feature, bin) zeroes its cell of every valid node and walks
//      the bin's rows in row order, adding each row's (g, h) into its
//      node's cell: gbt_hist's contract, with no sort a level.  The loads
//      of 8 rows go out together; each add is a load, add and store of the
//      cell with no branch, since the lanes of a warp walk different bins
//      and a branch a row would part them;
//   2. one thread a valid node sums feature 0's bins (Gtot, Htot, the leaf
//      value) in every block, so no block waits for another's totals;
//   3. the block searches its own features with gbt_split's rounds and
//      writes each node's best candidate into every block of the cluster
//      through distributed shared memory (a buffer a level parity);
//   4. one cluster barrier; then every block merges the candidates (a
//      group of lanes a node, by shuffles) in the same total order,
//      numbers the children with ballots, and moves its own copy of the
//      rows, so the copies stay equal without a second barrier; block 0
//      writes the tree entries.
// The last level of a tree histograms feature 0 alone and takes no
// barrier: its nodes are leaves.  After it every row in the fit takes its
// next gradient (pred and y in float64) and returns to the root.  Block 0
// writes the rows' state back once, at the end.
//
// Bound: a level moves a few kilobytes at the ALA's shapes, so each launch
// is bound by its latency, not by bytes or operations; at n 8,192 the
// histogram's bytes are some 0.36 MB (0.11 us at 3.35 TB/s), and its four
// tiles run one after another within a block.  The split step is bound by
// its per-thread chains (the cumsum, two float64 divisions a candidate),
// on one SM per problem.  gbt_grow removes the launches, the host's work
// between them and the histograms' round trip through device memory; what
// remains is latency: a level's critical path is the longest bin's row
// walk, the search's per-thread chain and one cluster barrier
// (`python -m repro_torch.bench.k4_grow` prints each part's share).
#include <cooperative_groups.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---- histograms ------------------------------------------------------
constexpr int CELLS = 256;        // cells a block owns, one a thread
constexpr int HIST_THREADS = CELLS;
constexpr int HIST_WARPS = HIST_THREADS / 32;
constexpr int ROW_TILE = 2048;    // rows bucketed per pass
constexpr int CHUNKS = ROW_TILE / 32 / HIST_WARPS;  // 32-row chunks a warp keys
constexpr int WALK_ROWS = 64;     // a tile this short is walked, not bucketed
static_assert(WALK_ROWS <= 32 * CHUNKS && WALK_ROWS <= CELLS * HIST_WARPS,
              "a walked tile is warp 0's rows and fits s_place");

// The lanes of the warp whose key equals this lane's, for keys in
// [-1, CELLS): nine ballots over the bits of key + 1.  (What
// __match_any_sync answers, in a time that does not grow with the number
// of distinct keys.)
__device__ __forceinline__ unsigned same_key_lanes(int key) {
  const int k = key + 1;
  unsigned peers = FULL;
#pragma unroll
  for (int bit = 0; bit < 9; ++bit) {
    const bool on = (k >> bit) & 1;
    const unsigned set = __ballot_sync(FULL, on);
    peers &= on ? set : ~set;
  }
  return peers;
}

__global__ void __launch_bounds__(HIST_THREADS)
gbt_hist_kernel(const int* __restrict__ bins, const float* __restrict__ grad,
                const float* __restrict__ hess, const int* __restrict__ node,
                float2* __restrict__ out, int n, int f, int n_nodes,
                int n_bins) {
  __shared__ int s_place[HIST_WARPS][CELLS];  // counts, then write offsets
  __shared__ int s_start[CELLS];
  __shared__ int s_total[CELLS];
  __shared__ int s_warp_sum[HIST_WARPS];
  __shared__ float2 s_gh[ROW_TILE];  // the tile bucketed by cell
  const int l = blockIdx.z;
  const int feat = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * CELLS;
  const int my_cells = static_cast<int>(
      min(static_cast<int64_t>(CELLS),
          static_cast<int64_t>(n_nodes) * n_bins - c0));
  const int c = threadIdx.x;  // owns cell c0 + c where c < my_cells
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned lanes_below = (1u << lane) - 1;
  const int64_t row0 = static_cast<int64_t>(l) * n;
  // this warp's rows of the tile at t0: t0 + (warp * CHUNKS + j) * 32 + lane
  // (every load reads a valid row, the last one past the end, so that no
  // branch keeps the loads of one chunk from those of the next)
  int key[CHUNKS];
  float g[CHUNKS], h[CHUNKS];
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int r = t0 + (warp * CHUNKS + j) * 32 + lane;
      const int64_t i = row0 + min(r, n - 1);
      const int b = bins[i * f + feat];
      const int nd = node[i];
      g[j] = grad[i];
      h[j] = hess[i];
      const int64_t cell = static_cast<int64_t>(nd) * n_bins + b - c0;
      key[j] = r < n && b >= 0 && b < n_bins && nd >= 0 && nd < n_nodes &&
                       cell >= 0 && cell < my_cells
                   ? static_cast<int>(cell)
                   : -1;
    }
  };
  if (n > 0) load(0);
  float acc_g = 0.f;
  float acc_h = 0.f;
  for (int t0 = 0; t0 < n; t0 += ROW_TILE) {
    const int rows = min(ROW_TILE, n - t0);
    if (rows <= WALK_ROWS) {
      // a short tile (the last one) is cheaper walked than bucketed: its
      // rows, all warp 0's, go to shared memory in order and every cell's
      // thread reads them all, adding its own
      int* s_key = &s_place[0][0];
      if (warp == 0) {
#pragma unroll
        for (int j = 0; j < WALK_ROWS / 32; ++j) {
          s_key[j * 32 + lane] = key[j];
          s_gh[j * 32 + lane] = make_float2(g[j], h[j]);
        }
      }
      __syncthreads();
      for (int r = 0; r < rows; ++r) {
        if (s_key[r] == c) {
          acc_g += s_gh[r].x;
          acc_h += s_gh[r].y;
        }
      }
      break;
    }
    const int warps = (rows + 32 * CHUNKS - 1) / (32 * CHUNKS);  // with rows
    if (warp < warps) {
#pragma unroll
      for (int w = 0; w < CELLS / 32; ++w) s_place[warp][w * 32 + lane] = 0;
    }
    __syncwarp();
    // ranks: rows of the same cell before this one in the warp's chunks
    int rank[CHUNKS];
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      rank[j] = 0;
      if ((warp * CHUNKS + j) * 32 < rows) {  // the chunk holds rows
        const unsigned peers = same_key_lanes(key[j]);
        const int before = key[j] >= 0 ? s_place[warp][key[j]] : 0;
        rank[j] = before + __popc(peers & lanes_below);
        __syncwarp();
        if (key[j] >= 0 && lane == __ffs(peers) - 1) {
          s_place[warp][key[j]] = before + __popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // cell c's run starts after every row of the cells before it; within
    // the run, warp w's rows follow those of the warps before it
    int total = 0;
#pragma unroll
    for (int w = 0; w < HIST_WARPS; ++w) {
      if (w < warps) {
        const int v = s_place[w][c];
        s_place[w][c] = total;
        total += v;
      }
    }
    int incl = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp_sum[warp] = incl;
    __syncthreads();
    int start = incl - total;
#pragma unroll
    for (int w = 0; w < HIST_WARPS; ++w) {
      if (w < warp) start += s_warp_sum[w];
    }
    s_start[c] = start;
    s_total[c] = total;
#pragma unroll
    for (int w = 0; w < HIST_WARPS; ++w) {
      if (w < warps) s_place[w][c] += start;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      if (key[j] >= 0) {
        s_gh[s_place[warp][key[j]] + rank[j]] = make_float2(g[j], h[j]);
      }
    }
    __syncthreads();
    const bool more = t0 + ROW_TILE < n;
    if (more) load(t0 + ROW_TILE);  // in flight while this tile is summed
    if (c < my_cells) {
      const int end = s_start[c] + s_total[c];
#pragma unroll 8
      for (int k = s_start[c]; k < end; ++k) {
        const float2 v = s_gh[k];
        acc_g += v.x;
        acc_h += v.y;
      }
    }
    if (more) __syncthreads();  // the tile is consumed
  }
  if (c < my_cells) {
    const int64_t cell = c0 + c;
    const int64_t nd = cell / n_bins;
    const int64_t b = cell - nd * n_bins;
    out[((static_cast<int64_t>(l) * n_nodes + nd) * f + feat) * n_bins + b] =
        make_float2(acc_g, acc_h);
  }
}


// ---- the split step --------------------------------------------------
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_WARPS = SPLIT_THREADS / 32;
constexpr int MAX_BINS = 128;     // numpy sums rows of up to 128 in one block
constexpr int MAX_WIDTH = 256;    // nodes of one level: max_depth <= 8
constexpr int STAGE = 4096;       // histogram cells (g, h) staged at once

// np.sum over the n <= 128 float64 values of each component of a
// histogram row a[0 .. n - 1] (the g and the h of every bin): (G, H), each
// in numpy's pairwise order, added to the reduction's initial 0.0.  The two
// sums run side by side.
__device__ void numpy_sums(const float2* a, int n, double* G, double* H) {
  double g, h;
  if (n < 8) {
    g = h = 0.0;
    for (int i = 0; i < n; ++i) {
      g = __dadd_rn(g, a[i].x);
      h = __dadd_rn(h, a[i].y);
    }
  } else {
    double rg[8], rh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      rg[j] = a[j].x;
      rh[j] = a[j].y;
    }
    int i = 8;
    for (; i < n - n % 8; i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rg[j] = __dadd_rn(rg[j], a[i + j].x);
        rh[j] = __dadd_rn(rh[j], a[i + j].y);
      }
    }
    g = __dadd_rn(__dadd_rn(__dadd_rn(rg[0], rg[1]), __dadd_rn(rg[2], rg[3])),
                  __dadd_rn(__dadd_rn(rg[4], rg[5]), __dadd_rn(rg[6], rg[7])));
    h = __dadd_rn(__dadd_rn(__dadd_rn(rh[0], rh[1]), __dadd_rn(rh[2], rh[3])),
                  __dadd_rn(__dadd_rn(rh[4], rh[5]), __dadd_rn(rh[6], rh[7])));
    for (; i < n; ++i) {
      g = __dadd_rn(g, a[i].x);
      h = __dadd_rn(h, a[i].y);
    }
  }
  *G = __dadd_rn(0.0, g);
  *H = __dadd_rn(0.0, h);
}

// numpy argmax's order of candidates: a NaN first, the lower flat index
// among NaNs; else the larger gain, the lower flat index among equals
__device__ __forceinline__ bool better(double g, int i, double bg, int bi) {
  const bool nan = isnan(g);
  const bool bnan = isnan(bg);
  if (nan != bnan) return nan;
  if (!nan && g != bg) return g > bg;
  return i < bi;
}

// a node's leaf value, float32(-G / (H + lambda))
__device__ __forceinline__ float leaf_value(double G, double H, double lam) {
  return __double2float_rn(__ddiv_rn(-G, __dadd_rn(H, lam)));
}

// a row's prediction after its leaf: pred + float32(lr) * leaf, the product
// in float32
__device__ __forceinline__ double add_leaf(double p, float lr, float leaf) {
  return __dadd_rn(p, static_cast<double>(__fmul_rn(lr, leaf)));
}

// a node splits on its best candidate where the gain is finite and above
// 1e-12
__device__ __forceinline__ bool splits(double gain) {
  return isfinite(gain) && gain > 1e-12;
}

// The valid nodes of a level of `width` nodes whose first node is `first`,
// as the level asks for `asked`: none where the level would not fit the
// tree of N nodes (a caller's mistake), so that no write falls outside it.
// A level's children take ids below first + 3 * asked.
__device__ __forceinline__ int level_nodes(int first, int asked, int width,
                                           bool last, int N) {
  return first >= 0 && asked >= 0 && asked <= width &&
                 first + (last ? 1 : 3) * asked <= N
             ? asked
             : 0;
}

// One round of the split search.  The round holds `rows` (node, feature)
// histogram rows of n_bins (g, h) cells, items r0 .. r0 + rows - 1 of a
// level's node-major list of `nf` features a node (item i: node i / nf,
// feature k0 + i % nf); `row_of(il)` points at the round's row il.  Each
// row's bins are cut into `parts` runs, thread part * rows + il taking run
// `part` of row il: it repeats the sequential float64 cumsum up to its run
// (so its GL and HL are np.cumsum's), computes the gain of
// fit_packed_forest for each bin and keeps its best by `better`.  A warp per
// node then merges the round's runs into the node's best so far (s_gain,
// s_idx).  The caller has the rows, s_G and s_H ready and s_rg, s_ri free.
template <typename RowOf>
__device__ void search_round(RowOf row_of, int r0, int rows, int nf, int k0,
                             int n_bins, const double* s_G,
                             const double* s_H, double lam, double mcw,
                             double* s_rg, int* s_ri, double* s_gain,
                             int* s_idx) {
  const int parts = min(n_bins, max(1, SPLIT_THREADS / rows));
  const int run = (n_bins + parts - 1) / parts;
  const int part = threadIdx.x / rows;
  const int il = threadIdx.x - part * rows;
  double bg = -INFINITY;
  int bi = INT_MAX;
  if (part < parts) {
    const int j = (r0 + il) / nf;
    const int k = k0 + r0 + il - j * nf;
    const float2* row = row_of(il);
    const double G = s_G[j];
    const double H = s_H[j];
    const double C = __ddiv_rn(__dmul_rn(G, G), __dadd_rn(H, lam));
    double GL = row[0].x;  // np.cumsum's order, so GL and HL are its
    double HL = row[0].y;
    auto candidate = [&](int b) {
      const double GR = __dsub_rn(G, GL);
      const double HR = __dsub_rn(H, HL);
      // every candidate's gain is computed, so no branch keeps the
      // divisions of neighbouring bins apart; masked ones are -inf
      const double a = __ddiv_rn(__dmul_rn(GL, GL), __dadd_rn(HL, lam));
      const double c = __ddiv_rn(__dmul_rn(GR, GR), __dadd_rn(HR, lam));
      const double v = __dmul_rn(0.5, __dsub_rn(__dadd_rn(a, c), C));
      const bool ok = HL >= mcw && HR >= mcw && b < n_bins - 1;
      const double gain = ok ? v : -INFINITY;
      if (better(gain, k * n_bins + b, bg, bi)) {
        bg = gain;
        bi = k * n_bins + b;
      }
    };
    const int b0 = part * run;
    const int b1 = min(n_bins, b0 + run);
    if (b0 < b1) {
#pragma unroll 8
      for (int b = 1; b < b0; ++b) {
        GL = __dadd_rn(GL, row[b].x);
        HL = __dadd_rn(HL, row[b].y);
      }
      if (b0 == 0) candidate(0);
#pragma unroll 4
      for (int b = max(b0, 1); b < b1; ++b) {
        GL = __dadd_rn(GL, row[b].x);
        HL = __dadd_rn(HL, row[b].y);
        candidate(b);
      }
    }
  }
  s_rg[threadIdx.x] = bg;
  s_ri[threadIdx.x] = bi;
  __syncthreads();
  // merge the round into each node's best, one warp per node
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int j = r0 / nf + warp; j <= (r0 + rows - 1) / nf; j += SPLIT_WARPS) {
    const int i0 = max(r0, j * nf) - r0;  // the node's rows in the round
    const int cnt = min(r0 + rows, (j + 1) * nf) - r0 - i0;
    double mg = s_gain[j];
    int mi = s_idx[j];
    for (int q = lane; q < cnt * parts; q += 32) {
      const int u = (q / cnt) * rows + i0 + q % cnt;
      if (better(s_rg[u], s_ri[u], mg, mi)) {
        mg = s_rg[u];
        mi = s_ri[u];
      }
    }
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      const double og = __shfl_down_sync(FULL, mg, d);
      const int oi = __shfl_down_sync(FULL, mi, d);
      if (better(og, oi, mg, mi)) {
        mg = og;
        mi = oi;
      }
    }
    if (lane == 0) {
      s_gain[j] = mg;
      s_idx[j] = mi;
    }
  }
}

// Copies `rows` histogram rows of n_bins (g, h) cells, the first at `src`
// and each `src_stride` cells after the one before, into `dst`, rows
// `dst_stride` cells apart; eight loads in flight a thread.
__device__ __forceinline__ void stage_rows(float2* dst, int dst_stride,
                                           const float2* src,
                                           int64_t src_stride, int rows,
                                           int n_bins) {
#pragma unroll 8
  for (int i = threadIdx.x; i < rows * n_bins; i += SPLIT_THREADS) {
    const int r = i / n_bins;
    const int b = i - r * n_bins;
    dst[r * dst_stride + b] = src[r * src_stride + b];
  }
}

__global__ void __launch_bounds__(SPLIT_THREADS)
gbt_split_kernel(const float2* __restrict__ hist, const int* __restrict__ bins,
                 const double* __restrict__ y, const double* __restrict__ w,
                 double* __restrict__ pred, float* __restrict__ grad,
                 int* __restrict__ node, int* __restrict__ level,
                 int* __restrict__ feature, int* __restrict__ threshold,
                 int* __restrict__ left, int* __restrict__ right,
                 float* __restrict__ value, int* __restrict__ n_nodes_out,
                 int width, int n, int f, int n_bins, int T, int N, int t,
                 int last, double lam, double mcw, float lr) {
  __shared__ float2 s_hist[STAGE];      // histogram rows of one round
  __shared__ double s_G[MAX_WIDTH];
  __shared__ double s_H[MAX_WIDTH];
  __shared__ double s_gain[MAX_WIDTH];  // the node's best candidate
  __shared__ int s_idx[MAX_WIDTH];
  __shared__ float s_leaf[MAX_WIDTH];
  __shared__ int s_base[MAX_WIDTH];     // left child's level index, or -1
  __shared__ double s_rg[SPLIT_THREADS];  // one round's candidates
  __shared__ int s_ri[SPLIT_THREADS];
  const int l = blockIdx.x;
  const int first = level[2 * l];
  const int n_valid =
      level_nodes(first, level[2 * l + 1], width, last, N);
  const int64_t tree = (static_cast<int64_t>(l) * T + t) * N;
  // staged rows lie an odd number of cells apart, so that the threads of
  // a warp, each on its own row, read from different banks
  const int stride = n_bins | 1;
  const int per_round = min(SPLIT_THREADS, STAGE / stride);  // rows staged
  // node (l, j)'s feature k is row j * f + k of the problem's histograms
  const float2* hl = hist + static_cast<int64_t>(l) * width * f * n_bins;
  // Gtot, Htot and the leaf value of every valid node, from feature 0
  for (int j0 = 0; j0 < n_valid; j0 += per_round) {
    const int rows = min(per_round, n_valid - j0);
    __syncthreads();  // the stage is free
    stage_rows(s_hist, stride, hl + static_cast<int64_t>(j0) * f * n_bins,
               static_cast<int64_t>(f) * n_bins, rows, n_bins);
    __syncthreads();
    const int j = j0 + threadIdx.x;
    if (threadIdx.x < rows) {
      double G, H;
      numpy_sums(s_hist + threadIdx.x * stride, n_bins, &G, &H);
      s_G[j] = G;
      s_H[j] = H;
      s_leaf[j] = leaf_value(G, H, lam);
      s_gain[j] = -INFINITY;
      s_idx[j] = INT_MAX;
    }
  }
  // every (node, feature) walks its bins, node-major, a round of rows at a
  // time
  const int items = last ? 0 : n_valid * f;
  for (int r0 = 0; r0 < items; r0 += per_round) {
    const int rows = min(per_round, items - r0);
    __syncthreads();  // the stage and the round's candidates are free
    stage_rows(s_hist, stride, hl + static_cast<int64_t>(r0) * n_bins, n_bins,
               rows, n_bins);
    __syncthreads();
    const float2* stage = s_hist;
    search_round([stage, stride](int il) { return stage + il * stride; }, r0,
                 rows, f, 0, n_bins, s_G, s_H, lam, mcw, s_rg, s_ri, s_gain,
                 s_idx);
  }
  __syncthreads();
  // number the children in node order and write the tree
  if (threadIdx.x == 0) {
    const int next = first + n_valid;
    int k = 0;
    for (int j = 0; j < n_valid; ++j) {
      const int64_t at = tree + first + j;
      if (!last && splits(s_gain[j])) {
        s_base[j] = 2 * k;
        feature[at] = s_idx[j] / n_bins;
        threshold[at] = s_idx[j] % n_bins;
        left[at] = next + 2 * k;
        right[at] = next + 2 * k + 1;
        ++k;
      } else {
        s_base[j] = -1;
        value[at] = s_leaf[j];
      }
    }
    if (last) {
      n_nodes_out[static_cast<int64_t>(l) * T + t] = min(next, N);
      level[2 * l] = 0;
      level[2 * l + 1] = 1;
    } else {
      level[2 * l] = next;
      level[2 * l + 1] = 2 * k;
    }
  }
  __syncthreads();
  // rows: into a child, or into a leaf, which adds its value to pred
  for (int r = threadIdx.x; r < n; r += SPLIT_THREADS) {
    const int64_t i = static_cast<int64_t>(l) * n + r;
    int nd = node[i];
    double p = pred[i];
    if (nd >= 0 && nd < n_valid) {
      const int base = s_base[nd];
      if (base >= 0) {
        const int k = s_idx[nd] / n_bins;
        const int thr = s_idx[nd] % n_bins;
        nd = base + (bins[i * f + k] > thr ? 1 : 0);
      } else {
        p = add_leaf(p, lr, s_leaf[nd]);
        pred[i] = p;
        nd = -1;
      }
    }
    if (last) {  // the next tree: every row in the fit at the root
      const bool in_fit = w[i] > 0.0;
      grad[i] = in_fit ? __double2float_rn(__dsub_rn(p, y[i])) : 0.f;
      nd = in_fit ? 0 : -1;
    }
    node[i] = nd;
  }
}

// ---- a whole fit in one launch ------------------------------------------
constexpr int GROW_THREADS = SPLIT_THREADS;  // search_round's block
constexpr int GROW_WARPS = GROW_THREADS / 32;
constexpr int GROW_BLOCKS_SM = 2;    // the registers are cut for 2 an SM
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int MAX_ROWS = 65535;      // row ids are 16-bit
constexpr int MAX_DEPTH = 8;
constexpr int WALK = 8;              // rows a histogram thread loads at once

// Built with -DGBT_GROW_PROFILE (bench/k4_grow.py), thread 0 of block 0
// adds the clock cycles of each part of the fit into g_grow_profile: 0
// set-up, 1 histograms, 2 totals, 3 search, 4 candidates and the cluster
// barrier, 5 decisions, 6 row moves, 7 a last level after its totals; 8
// and 9 count searching and last levels.  Otherwise the marks are empty.
#ifdef GBT_GROW_PROFILE
__device__ long long g_grow_profile[16];
#define GROW_MARK_START long long mark_ = clock64();
#define GROW_MARK(k)                                     \
  if (blockIdx.x == 0 && threadIdx.x == 0) {             \
    const long long now_ = clock64();                    \
    g_grow_profile[k] += now_ - mark_;                   \
    mark_ = now_;                                        \
  }
#define GROW_COUNT(k) \
  if (blockIdx.x == 0 && threadIdx.x == 0) ++g_grow_profile[k];
#else
#define GROW_MARK_START
#define GROW_MARK(k)
#define GROW_COUNT(k)
#endif
constexpr int64_t GROW_SMEM = 232448;  // shared memory a block can have
// a row's bin id as a byte: in range, or out of it below or above, which
// no histogram counts and which moves the row left or right as the int
// would
constexpr unsigned char BIN_BELOW = 0xfe;
constexpr unsigned char BIN_ABOVE = 0xff;
static_assert(MAX_BINS < BIN_BELOW, "bin ids and the two marks differ");
static_assert(MAX_WIDTH == 1 << MAX_DEPTH, "a level's nodes");

// How f features split over a cluster of at most `most` blocks: `per`
// features a block, `blocks` blocks; block r owns features
// r * per .. min(f, (r + 1) * per).  `grow_plan` picks `most`.
struct GrowSplit {
  int per, blocks;
};
__host__ __device__ inline GrowSplit grow_split(int f, int most) {
  const int per = (f + most - 1) / most;
  return {per, (f + per - 1) / per};
}

// Byte offsets of a block's arrays in its dynamic shared memory, each
// rounded up to 8 bytes; `bytes` is their sum.  `ops.grow_smem_bytes`
// repeats this arithmetic for the host, so the two say the same.
struct GrowLayout {
  int64_t pred, hist, G, H, gain, cand_g, rg, node, grad, hess, leaf, idx,
      base, feat, thr, cand_i, ri, mask, offs, ids, bins, bytes;
};

__host__ __device__ inline int64_t take(int64_t* at, int64_t bytes) {
  const int64_t o = *at;
  *at += (bytes + 7) / 8 * 8;
  return o;
}

__host__ __device__ inline GrowLayout grow_layout(GrowSplit sp, int n, int f,
                                                  int n_bins, int max_depth) {
  const int64_t nh = sp.per + (sp.blocks > 1 ? 1 : 0);  // histogram features
  const int64_t W = int64_t{1} << max_depth;     // the last level's nodes
  const int64_t WS = W > 1 ? W / 2 : 1;          // a searching level's
  const int64_t stride = n_bins | 1;
  const int64_t searching = max_depth > 0 ? nh * WS : 0;
  const int64_t hist_rows = searching > W ? searching : W;
  GrowLayout g;
  int64_t at = 0;
  g.pred = take(&at, 8 * int64_t{n});
  g.hist = take(&at, 8 * hist_rows * stride);
  g.G = take(&at, 8 * W);
  g.H = take(&at, 8 * W);
  g.gain = take(&at, 8 * W);
  g.cand_g = take(&at, 8 * 2 * sp.blocks * WS);
  g.rg = take(&at, 8 * GROW_THREADS);
  g.node = take(&at, 4 * int64_t{n});
  g.grad = take(&at, 4 * int64_t{n});
  g.hess = take(&at, 4 * int64_t{n});
  g.leaf = take(&at, 4 * W);
  g.idx = take(&at, 4 * W);
  g.base = take(&at, 4 * W);
  g.feat = take(&at, 4 * W);
  g.thr = take(&at, 4 * W);
  g.cand_i = take(&at, 4 * 2 * sp.blocks * WS);
  g.ri = take(&at, 4 * GROW_THREADS);
  g.mask = take(&at, 4 * GROW_WARPS);
  g.offs = take(&at, 4 * nh * (n_bins + 1));
  g.ids = take(&at, 2 * nh * n);
  g.bins = take(&at, int64_t{n} * f);
  g.bytes = at;
  return g;
}

struct GrowArgs {
  const int* bins;   // (L, n, f)
  const double* y;   // (L, n)
  const double* w;   // (L, n)
  double* pred;      // (L, n)
  float* grad;       // (L, n)
  const float* hess; // (L, n)
  int* node;         // (L, n)
  int* level;        // (L, 2)
  int* feature;      // (L, T, N), and the next three
  int* threshold;
  int* left;
  int* right;
  float* value;      // (L, T, N)
  int* n_nodes;      // (L, T)
  int n, f, n_bins, T, max_depth;
  GrowSplit split;   // grow_plan's
  double lam, mcw;
  float lr;
};

__global__ void __launch_bounds__(GROW_THREADS, GROW_BLOCKS_SM)
gbt_grow_kernel(const GrowArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, f = a.f, n_bins = a.n_bins, max_depth = a.max_depth;
  const GrowLayout lay = grow_layout(a.split, n, f, n_bins, max_depth);
  double* s_pred = reinterpret_cast<double*>(smem + lay.pred);
  float2* s_hist = reinterpret_cast<float2*>(smem + lay.hist);
  double* s_G = reinterpret_cast<double*>(smem + lay.G);
  double* s_H = reinterpret_cast<double*>(smem + lay.H);
  double* s_gain = reinterpret_cast<double*>(smem + lay.gain);
  double* s_cand_g = reinterpret_cast<double*>(smem + lay.cand_g);
  double* s_rg = reinterpret_cast<double*>(smem + lay.rg);
  int* s_node = reinterpret_cast<int*>(smem + lay.node);
  float* s_grad = reinterpret_cast<float*>(smem + lay.grad);
  float* s_hess = reinterpret_cast<float*>(smem + lay.hess);
  float* s_leaf = reinterpret_cast<float*>(smem + lay.leaf);
  int* s_idx = reinterpret_cast<int*>(smem + lay.idx);
  int* s_base = reinterpret_cast<int*>(smem + lay.base);
  int* s_feat = reinterpret_cast<int*>(smem + lay.feat);
  int* s_thr = reinterpret_cast<int*>(smem + lay.thr);
  int* s_cand_i = reinterpret_cast<int*>(smem + lay.cand_i);
  int* s_ri = reinterpret_cast<int*>(smem + lay.ri);
  unsigned* s_mask = reinterpret_cast<unsigned*>(smem + lay.mask);
  int* s_offs = reinterpret_cast<int*>(smem + lay.offs);
  uint16_t* s_ids = reinterpret_cast<uint16_t*>(smem + lay.ids);
  unsigned char* s_bins = smem + lay.bins;

  const int C = static_cast<int>(cluster.num_blocks());
  int P = 1;  // C rounded up to a power of two: lanes a node's merge takes
  while (P < C) P <<= 1;
  const int rank = static_cast<int>(cluster.block_rank());
  const int l = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const unsigned lanes_below = (1u << lane) - 1;
  // this block's features k0 .. k0 + n_own - 1, in histogram slots own0 ..;
  // slot 0 is always feature 0, whose bins give every node's totals
  const int per = a.split.per;
  const int k0 = rank * per;
  const int n_own = min(f, k0 + per) - k0;
  const int own0 = k0 == 0 ? 0 : 1;
  const int nh = n_own + own0;
  const int W = 1 << max_depth;
  const int WS = W > 1 ? W / 2 : 1;
  const int N = 2 * W - 1;
  const int stride = n_bins | 1;
  const int nb1 = n_bins + 1;
  const int64_t row0 = static_cast<int64_t>(l) * n;
  GROW_MARK_START

  // the problem's rows, once
  for (int r = tid; r < n; r += GROW_THREADS) {
    s_node[r] = a.node[row0 + r];
    s_grad[r] = a.grad[row0 + r];
    s_hess[r] = a.hess[row0 + r];
    s_pred[r] = a.pred[row0 + r];
  }
  for (int64_t i = tid; i < static_cast<int64_t>(n) * f; i += GROW_THREADS) {
    const int b = a.bins[row0 * f + i];
    s_bins[i] = b < 0 ? BIN_BELOW
                      : (b >= n_bins ? BIN_ABOVE : static_cast<unsigned char>(b));
  }
  __syncthreads();
  // each histogram feature's rows by bin, in row order: counts, offsets,
  // then the ids (a stable counting sort, one thread a (slot, bin))
  for (int it = tid; it < nh * n_bins; it += GROW_THREADS) {
    const int s = it / n_bins;
    const int b = it - s * n_bins;
    const int k = s < own0 ? 0 : k0 + s - own0;
    int cnt = 0;
    for (int r = 0; r < n; ++r) cnt += s_bins[r * f + k] == b;
    s_offs[s * nb1 + b + 1] = cnt;
  }
  __syncthreads();
  for (int s = tid; s < nh; s += GROW_THREADS) {
    int* o = s_offs + s * nb1;
    o[0] = 0;
    for (int b = 0; b < n_bins; ++b) o[b + 1] += o[b];
  }
  __syncthreads();
  for (int it = tid; it < nh * n_bins; it += GROW_THREADS) {
    const int s = it / n_bins;
    const int b = it - s * n_bins;
    const int k = s < own0 ? 0 : k0 + s - own0;
    uint16_t* ids = s_ids + static_cast<int64_t>(s) * n;
    int q = s_offs[s * nb1 + b];
    for (int r = 0; r < n; ++r) {
      if (s_bins[r * f + k] == b) ids[q++] = static_cast<uint16_t>(r);
    }
  }
  __syncthreads();
  GROW_MARK(0)

  int first = a.level[2 * l];
  int asked = a.level[2 * l + 1];
  int phase = 0;  // cluster barriers passed; its parity picks the buffer
  for (int t = 0; t < a.T; ++t) {
    const int64_t tree = (static_cast<int64_t>(l) * a.T + t) * N;
    for (int depth = 0; depth <= max_depth; ++depth) {
      const bool last = depth == max_depth;
      const int nv = level_nodes(first, asked, 1 << depth, last, N);
      if (!last && nv == 0) {  // nothing to grow: the level moves no row
        asked = 0;
        continue;
      }
      // 1. histograms: thread (slot, bin) owns that cell of every valid
      // node (node j's at row j * hs + slot) and adds the bin's rows in
      // row order.  The last level needs feature 0 alone.
      const int hs = last ? 1 : nh;
      for (int it = tid; it < hs * n_bins; it += GROW_THREADS) {
        const int s = it / n_bins;
        const int b = it - s * n_bins;
        float2* col = s_hist + s * stride + b;
        const int step = hs * stride;
        for (int j = 0; j < nv; ++j) col[j * step] = make_float2(0.f, 0.f);
        const uint16_t* ids = s_ids + static_cast<int64_t>(s) * n;
        const int q1 = s_offs[s * nb1 + b + 1];
        // WALK rows at a time: their loads first, all in flight, then the
        // adds in row order, each a load, add and store of the row's cell
        // with no branch (a row off the level's nodes adds to node 0's
        // cell and is not stored), so that the lanes of a warp, each on its
        // own bin, never part
        for (int q = s_offs[s * nb1 + b]; q < q1; q += WALK) {
          int r[WALK], nd[WALK];
          float g[WALK], h[WALK];
#pragma unroll
          for (int i = 0; i < WALK; ++i) r[i] = ids[min(q + i, q1 - 1)];
#pragma unroll
          for (int i = 0; i < WALK; ++i) {
            nd[i] = q + i < q1 ? s_node[r[i]] : -1;
            g[i] = s_grad[r[i]];
            h[i] = s_hess[r[i]];
          }
#pragma unroll
          for (int i = 0; i < WALK; ++i) {
            const bool ok =
                static_cast<unsigned>(nd[i]) < static_cast<unsigned>(nv);
            float2* c = col + (ok ? nd[i] : 0) * step;
            float2 v = *c;
            v.x = __fadd_rn(v.x, g[i]);
            v.y = __fadd_rn(v.y, h[i]);
            if (ok) *c = v;
          }
        }
      }
      __syncthreads();
      GROW_MARK(1)
      // 2. every valid node's totals and leaf value, from feature 0
      for (int j = tid; j < nv; j += GROW_THREADS) {
        double G, H;
        numpy_sums(s_hist + j * hs * stride, n_bins, &G, &H);
        s_G[j] = G;
        s_H[j] = H;
        s_leaf[j] = leaf_value(G, H, a.lam);
        s_gain[j] = -INFINITY;
        s_idx[j] = INT_MAX;
      }
      __syncthreads();
      GROW_MARK(2)
      if (last) {
        // every valid node is a leaf; then every row in the fit takes its
        // next gradient and starts the next tree at the root
        if (rank == 0) {
          for (int j = tid; j < nv; j += GROW_THREADS)
            a.value[tree + first + j] = s_leaf[j];
          if (tid == 0) a.n_nodes[static_cast<int64_t>(l) * a.T + t] =
              min(first + nv, N);
        }
        for (int r = tid; r < n; r += GROW_THREADS) {
          double p = s_pred[r];
          const int nd = s_node[r];
          if (static_cast<unsigned>(nd) < static_cast<unsigned>(nv)) {
            p = add_leaf(p, a.lr, s_leaf[nd]);
            s_pred[r] = p;
          }
          const bool in_fit = a.w[row0 + r] > 0.0;
          s_grad[r] = in_fit ? __double2float_rn(__dsub_rn(p, a.y[row0 + r]))
                             : 0.f;
          s_node[r] = in_fit ? 0 : -1;
        }
        first = 0;
        asked = 1;
        __syncthreads();
        GROW_MARK(7)
        GROW_COUNT(9)
        continue;
      }
      // 3. the best split of each node among this block's features
      const int items = nv * n_own;
      for (int r0 = 0; r0 < items; r0 += GROW_THREADS) {
        if (r0) __syncthreads();  // the last round's candidates are merged
        search_round(
            [=](int il) {
              const int i = r0 + il;
              const int j = i / n_own;
              return s_hist + (j * nh + own0 + i - j * n_own) * stride;
            },
            r0, min(GROW_THREADS, items - r0), n_own, k0, n_bins, s_G, s_H,
            a.lam, a.mcw, s_rg, s_ri, s_gain, s_idx);
      }
      __syncthreads();
      GROW_MARK(3)
      // ... to every block of the cluster
      const int buf = phase & 1;
      for (int e = tid; e < nv * C; e += GROW_THREADS) {
        const int j = e / C;
        const int d = e - j * C;
        const int at = (buf * C + rank) * WS + j;
        cluster.map_shared_rank(s_cand_g, d)[at] = s_gain[j];
        cluster.map_shared_rank(s_cand_i, d)[at] = s_idx[j];
      }
      cluster.sync();
      ++phase;
      GROW_MARK(4)
      // 4. the decisions, the same in every block: each node's best over
      // the blocks (lane r of a group of P takes block r's candidate; the
      // group reduces by shuffles), its children numbered in node order
      for (int e0 = 0; e0 < nv * P; e0 += GROW_THREADS) {
        const int e = e0 + tid;
        const int j = e / P;
        const int r = e - j * P;
        double bg = -INFINITY;
        int bi = INT_MAX;
        if (j < nv && r < C) {
          bg = s_cand_g[(buf * C + r) * WS + j];
          bi = s_cand_i[(buf * C + r) * WS + j];
        }
#pragma unroll
        for (int d = 1; d < MAX_CLUSTER; d <<= 1) {
          const double og = __shfl_xor_sync(FULL, bg, d);
          const int oi = __shfl_xor_sync(FULL, bi, d);
          if (d < P && better(og, oi, bg, bi)) {
            bg = og;
            bi = oi;
          }
        }
        if (j < nv && r == 0) {
          s_gain[j] = bg;
          s_idx[j] = bi;
        }
      }
      __syncthreads();
      const int j = tid;  // nv <= WS <= 128 < GROW_THREADS
      const double bg = j < nv ? s_gain[j] : -INFINITY;
      const int bi = j < nv ? s_idx[j] : INT_MAX;
      const bool split = j < nv && splits(bg);
      const unsigned m = __ballot_sync(FULL, split);
      if (lane == 0) s_mask[warp] = m;
      __syncthreads();
      int below = __popc(m & lanes_below);
      int k = 0;
#pragma unroll
      for (int w = 0; w < GROW_WARPS; ++w) {
        const int c = __popc(s_mask[w]);
        below += w < warp ? c : 0;
        k += c;
      }
      if (j < nv) {
        const int next = first + nv;
        s_base[j] = split ? 2 * below : -1;
        s_feat[j] = split ? bi / n_bins : 0;
        s_thr[j] = split ? bi % n_bins : 0;
        if (rank == 0) {
          const int64_t at = tree + first + j;
          if (split) {
            a.feature[at] = bi / n_bins;
            a.threshold[at] = bi % n_bins;
            a.left[at] = next + 2 * below;
            a.right[at] = next + 2 * below + 1;
          } else {
            a.value[at] = s_leaf[j];
          }
        }
      }
      __syncthreads();
      GROW_MARK(5)
      // rows: into a child, or into a leaf, which adds its value to pred
      for (int r = tid; r < n; r += GROW_THREADS) {
        int nd = s_node[r];
        if (static_cast<unsigned>(nd) < static_cast<unsigned>(nv)) {
          const int base = s_base[nd];
          if (base >= 0) {
            const unsigned char b = s_bins[r * f + s_feat[nd]];
            nd = base + (b != BIN_BELOW && b > s_thr[nd] ? 1 : 0);
          } else {
            s_pred[r] = add_leaf(s_pred[r], a.lr, s_leaf[nd]);
            nd = -1;
          }
          s_node[r] = nd;
        }
      }
      first += nv;
      asked = 2 * k;
      __syncthreads();
      GROW_MARK(6)
      GROW_COUNT(8)
    }
  }
  // the rows' state and the level, as the level-by-level path leaves them
  if (rank == 0) {
    for (int r = tid; r < n; r += GROW_THREADS) {
      a.pred[row0 + r] = s_pred[r];
      a.grad[row0 + r] = s_grad[r];
      a.node[row0 + r] = s_node[r];
    }
    if (tid == 0) {
      a.level[2 * l] = first;
      a.level[2 * l + 1] = asked;
    }
  }
  cluster.sync();  // no block leaves while another may still write to it
}

}  // namespace

// bins (L, n, f) int32, grad/hess (L, n) fp32, node (L, n) int32, out
// (L, n_nodes, f, n_bins, 2) fp32, all contiguous.  Returns the launch's
// CUDA error code (0 on success).
extern "C" int gbt_hist(const void* bins, const void* grad, const void* hess,
                        const void* node, void* out, int L, int n, int f,
                        int n_nodes, int n_bins, void* stream) {
  const int64_t cells = static_cast<int64_t>(n_nodes) * n_bins;
  const int64_t groups = (cells + CELLS - 1) / CELLS;
  if (L < 1 || n < 0 || f < 1 || n_nodes < 1 || n_bins < 1 ||
      L > 65535 || f > 65535 || groups > 0x7fffffff ||
      static_cast<int64_t>(L) * n * f > (int64_t{1} << 62)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(groups), f, L);
  gbt_hist_kernel<<<grid, HIST_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bins), static_cast<const float*>(grad),
      static_cast<const float*>(hess), static_cast<const int*>(node),
      static_cast<float2*>(out), n, f, n_nodes, n_bins);
  return static_cast<int>(cudaGetLastError());
}

// hist (L, width, f, n_bins, 2) fp32; bins (L, n, f) int32; y, w, pred (L,
// n) float64; grad (L, n) fp32; node (L, n) int32; level (L, 2) int32;
// feature, threshold, left, right (L, T, N) int32; value (L, T, N) fp32;
// n_nodes (L, T) int32; all contiguous.  Grows level `width = 2**depth` of
// tree t (`last`: depth == max_depth) in place.  Returns the launch's CUDA
// error code (0 on success).
extern "C" int gbt_split(const void* hist, const void* bins, const void* y,
                         const void* w, void* pred, void* grad, void* node,
                         void* level, void* feature, void* threshold,
                         void* left, void* right, void* value, void* n_nodes,
                         int L, int width, int n, int f, int n_bins, int T,
                         int N, int t, int last, double lam, double mcw,
                         float lr, void* stream) {
  if (L < 1 || width < 1 || width > MAX_WIDTH || n < 0 || f < 1 ||
      n_bins < 1 || n_bins > MAX_BINS || t < 0 || t >= T || N < 1 ||
      static_cast<int64_t>(width) * f > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gbt_split_kernel<<<L, SPLIT_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(hist), static_cast<const int*>(bins),
      static_cast<const double*>(y), static_cast<const double*>(w),
      static_cast<double*>(pred), static_cast<float*>(grad),
      static_cast<int*>(node), static_cast<int*>(level),
      static_cast<int*>(feature), static_cast<int*>(threshold),
      static_cast<int*>(left), static_cast<int*>(right),
      static_cast<float*>(value), static_cast<int*>(n_nodes), width, n, f,
      n_bins, T, N, t, last, lam, mcw, lr);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of gbt_grow takes for a fit of n
// rows, f features, n_bins bins and trees of max_depth, its features split
// over a cluster of at most `most` blocks; -1 for a fit the kernel does
// not take (n over 65,535 rows, n_bins over 128, max_depth over 8).
extern "C" long long gbt_grow_smem_bytes(int n, int f, int n_bins,
                                         int max_depth, int most) {
  if (n < 0 || n > MAX_ROWS || f < 1 || n_bins < 1 || n_bins > MAX_BINS ||
      max_depth < 0 || max_depth > MAX_DEPTH || most < 1 ||
      most > MAX_CLUSTER) {
    return -1;
  }
  return grow_layout(grow_split(f, most), n, f, n_bins, max_depth).bytes;
}

// The cluster a fit of L problems takes on the current device, as the
// `most` of grow_split(f, most): of the splits whose block fits in shared
// memory, the one that needs the fewest waves of clusters
// (cudaOccupancyMaxActiveClusters: what the card's SMs hold at once, by
// registers and shared memory), and of those the one of most blocks,
// which searches fewest features a block.  A second wave would about
// double the fit's time, where a block with more features searches a
// little longer.  Writes `most` and a block's shared memory; returns a
// CUDA error code, cudaErrorInvalidValue for a fit no split holds.
extern "C" int gbt_grow_plan(int L, int n, int f, int n_bins, int max_depth,
                             int* most_out, long long* smem) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gbt_grow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(GROW_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  long long best_waves = -1;
  *most_out = 0;
  const int top = f < MAX_CLUSTER ? f : MAX_CLUSTER;
  for (int most = top; most >= 1 && L >= 1; --most) {
    const int blocks = grow_split(f, most).blocks;
    const long long bytes = gbt_grow_smem_bytes(n, f, n_bins, max_depth, most);
    if (bytes < 0 || bytes > GROW_SMEM ||
        static_cast<int64_t>(L) * blocks > 0x7fffffff) {
      continue;
    }
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = blocks;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(L * blocks));
    cfg.blockDim = dim3(GROW_THREADS);
    cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    int active = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&active, gbt_grow_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active < 1) continue;
    const long long waves = (static_cast<long long>(L) + active - 1) / active;
    if (best_waves < 0 || waves < best_waves) {
      best_waves = waves;
      *most_out = most;
      *smem = bytes;
    }
  }
  return *most_out ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A GrowState (bins (L, n, f) int32; y, w, pred (L, n) float64; grad, hess
// (L, n) fp32; node (L, n) int32; level (L, 2) int32; feature, threshold,
// left, right (L, T, N) int32, N = 2**(max_depth + 1) - 1; value (L, T, N)
// fp32; n_nodes (L, T) int32; all contiguous): grows its T trees of every
// problem in place, as T * (max_depth + 1) launches of
// gbt_hist and gbt_split would, one cluster a problem as gbt_grow_plan
// says.  Returns the launch's CUDA error code (0 on success;
// cudaErrorInvalidValue for a fit no cluster's shared memory holds).
extern "C" int gbt_grow(const void* bins, const void* y, const void* w,
                        void* pred, void* grad, const void* hess, void* node,
                        void* level, void* feature, void* threshold,
                        void* left, void* right, void* value, void* n_nodes,
                        int L, int n, int f, int n_bins, int T,
                        int max_depth, double lam, double mcw, float lr,
                        void* stream) {
  if (T < 0) return static_cast<int>(cudaErrorInvalidValue);
  int most = 0;
  long long smem = 0;
  const int planned = gbt_grow_plan(L, n, f, n_bins, max_depth, &most, &smem);
  if (planned) return planned;
  const GrowSplit sp = grow_split(f, most);
  const int C = sp.blocks;
  if (T == 0) return 0;
  GrowArgs a;
  a.bins = static_cast<const int*>(bins);
  a.y = static_cast<const double*>(y);
  a.w = static_cast<const double*>(w);
  a.pred = static_cast<double*>(pred);
  a.grad = static_cast<float*>(grad);
  a.hess = static_cast<const float*>(hess);
  a.node = static_cast<int*>(node);
  a.level = static_cast<int*>(level);
  a.feature = static_cast<int*>(feature);
  a.threshold = static_cast<int*>(threshold);
  a.left = static_cast<int*>(left);
  a.right = static_cast<int*>(right);
  a.value = static_cast<float*>(value);
  a.n_nodes = static_cast<int*>(n_nodes);
  a.n = n;
  a.f = f;
  a.n_bins = n_bins;
  a.T = T;
  a.max_depth = max_depth;
  a.split = sp;
  a.lam = lam;
  a.mcw = mcw;
  a.lr = lr;
  // one cluster a problem, its blocks along x
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = C;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(L * C));
  cfg.blockDim = dim3(GROW_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gbt_grow_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef GBT_GROW_PROFILE
// Copies g_grow_profile's 16 counters into `out` (host memory), or zeroes
// them with `reset`.  Returns the CUDA error code.
extern "C" int gbt_grow_profile(long long* out, int reset) {
  if (reset) {
    const long long zero[16] = {};
    return static_cast<int>(
        cudaMemcpyToSymbol(g_grow_profile, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_grow_profile, 16 * sizeof(long long)));
}
#endif
