// K4: GBT training on the card, for sm_90a: the per-node gradient/hessian
// histograms of one tree level, and the split step that grows the level
// from them.  With the two, `core.gbt.grow_forests` grows whole forests on
// the device, two launches a level, with no copy back to the host until
// the fit ends.
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
// Bound: a level moves a few kilobytes at the ALA's shapes, so each launch
// is bound by its latency, not by bytes or operations; at n 8,192 the
// histogram's bytes are some 0.36 MB (0.11 us at 3.35 TB/s), and its four
// tiles run one after another within a block.  The split step is bound by
// its per-thread chains (the cumsum, two float64 divisions a candidate),
// on one SM per problem.
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
constexpr int MAX_BINS = 128;     // numpy sums rows of up to 128 in one block
constexpr int MAX_WIDTH = 256;    // nodes of one level: max_depth <= 8
constexpr int STAGE = 4096;       // histogram cells (g, h) staged at once

// np.sum over n <= 128 float64 values a[0], a[2], ..., a[2 (n - 1)] (one
// component of a histogram row), in numpy's pairwise order, added to the
// reduction's initial 0.0.
__device__ double numpy_sum(const float* a, int n) {
  double res;
  if (n < 8) {
    res = 0.0;
    for (int i = 0; i < n; ++i) res = __dadd_rn(res, a[2 * i]);
  } else {
    double r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = a[2 * j];
    int i = 8;
    for (; i < n - n % 8; i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] = __dadd_rn(r[j], a[2 * (i + j)]);
    }
    res = __dadd_rn(__dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3])),
                    __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7])));
    for (; i < n; ++i) res = __dadd_rn(res, a[2 * i]);
  }
  return __dadd_rn(0.0, res);
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
  // a level that does not fit `width` and the tree (a caller's mistake)
  // touches no memory out of bounds: it grows no node.  A level's children
  // take ids below first + 3 * n_valid.
  const int asked = level[2 * l + 1];
  const int n_valid =
      first >= 0 && asked >= 0 && asked <= width &&
              first + (last ? 1 : 3) * asked <= N
          ? asked
          : 0;
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
      const float* row = reinterpret_cast<const float*>(
          s_hist + threadIdx.x * stride);
      const double G = numpy_sum(row, n_bins);
      const double H = numpy_sum(row + 1, n_bins);
      s_G[j] = G;
      s_H[j] = H;
      s_leaf[j] = __double2float_rn(__ddiv_rn(-G, __dadd_rn(H, lam)));
      s_gain[j] = -INFINITY;
      s_idx[j] = INT_MAX;
    }
  }
  // every (node, feature) walks its bins, node-major, a round of rows at a
  // time; each row's bins are cut into `parts` runs, and thread
  // part * rows + i takes run `part` of the round's row i
  const int items = last ? 0 : n_valid * f;
  for (int r0 = 0; r0 < items; r0 += per_round) {
    const int rows = min(per_round, items - r0);
    const int parts = min(n_bins, max(1, SPLIT_THREADS / rows));
    const int run = (n_bins + parts - 1) / parts;
    __syncthreads();  // the stage and the round's candidates are free
    stage_rows(s_hist, stride, hl + static_cast<int64_t>(r0) * n_bins, n_bins,
               rows, n_bins);
    __syncthreads();
    const int part = threadIdx.x / rows;
    const int il = threadIdx.x - part * rows;
    double bg = -INFINITY;
    int bi = INT_MAX;
    if (part < parts) {
      const int j = (r0 + il) / f;
      const int k = r0 + il - j * f;
      const float2* row = s_hist + il * stride;
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
    for (int j = r0 / f + warp; j <= (r0 + rows - 1) / f;
         j += SPLIT_THREADS / 32) {
      const int i0 = max(r0, j * f) - r0;  // the node's rows in the round
      const int cnt = min(r0 + rows, (j + 1) * f) - r0 - i0;
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
  __syncthreads();
  // number the children in node order and write the tree
  if (threadIdx.x == 0) {
    const int next = first + n_valid;
    int k = 0;
    for (int j = 0; j < n_valid; ++j) {
      const double g = s_gain[j];
      const int64_t at = tree + first + j;
      if (!last && isfinite(g) && g > 1e-12) {
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
        p = __dadd_rn(p, static_cast<double>(__fmul_rn(lr, s_leaf[nd])));
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
