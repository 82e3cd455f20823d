// K4: per-node gradient/hessian histograms of GBT training, for sm_90a.
//
// Replaces the TPU kernel `gbt_hist` (src/repro/kernels/gbt_hist/kernel.py,
// pallas_call in `gbt_hist`, body `_hist_kernel`), which builds
//     hist[f, b, {g, h}] = sum_n [bins[n, f] == b] * (grad_n, hess_n)
// as a one-hot matmul on the MXU (a TPU has no atomics) and separates tree
// nodes with one zero-masked pass per node.  This kernel computes the same
// function batched over L problems and keyed by node in one launch:
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
// Design: one block per (problem l, feature f, tile of up to 256 cells); a
// cell is one (node, bin) pair and belongs to one thread.  The block stages
// its problem's rows (cell key of feature f, g, h) in shared memory, 1,024
// rows at a time, and every thread walks them in order, adding the rows
// whose key is its own cell.  All threads read the same shared word at once
// (a broadcast), so the walk has no bank conflicts.
//
// Bound: the bytes it must move (bins, grad, hess, node in, the histograms
// out) are a few kilobytes at the ALA's shapes (n <= a few hundred rows),
// so one launch is bound by its launch latency, not by memory or
// arithmetic.  Every thread visits every row of its tile (n x cells
// compares per feature), which is the work a faster version would cut.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;  // cells per block
constexpr int ROW_TILE = 1024;    // rows staged in shared memory per pass

__global__ void __launch_bounds__(MAX_THREADS)
gbt_hist_kernel(const int* __restrict__ bins, const float* __restrict__ grad,
                const float* __restrict__ hess, const int* __restrict__ node,
                float2* __restrict__ out, int n, int f, int n_nodes,
                int n_bins) {
  __shared__ int s_key[ROW_TILE];
  __shared__ float s_g[ROW_TILE];
  __shared__ float s_h[ROW_TILE];
  const int l = blockIdx.z;
  const int feat = blockIdx.y;
  const int cells = n_nodes * n_bins;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(l) * n;
  float acc_g = 0.f;
  float acc_h = 0.f;
  for (int t0 = 0; t0 < n; t0 += ROW_TILE) {
    const int rows = min(ROW_TILE, n - t0);
    __syncthreads();  // the previous tile is consumed
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int64_t i = row0 + t0 + r;
      const int b = bins[i * f + feat];
      const int nd = node[i];
      const bool ok = b >= 0 && b < n_bins && nd >= 0 && nd < n_nodes;
      s_key[r] = ok ? nd * n_bins + b : -1;
      s_g[r] = grad[i];
      s_h[r] = hess[i];
    }
    __syncthreads();
    if (cell < cells) {
      for (int r = 0; r < rows; ++r) {
        if (s_key[r] == cell) {
          acc_g += s_g[r];
          acc_h += s_h[r];
        }
      }
    }
  }
  if (cell < cells) {
    const int nd = cell / n_bins;
    const int b = cell - nd * n_bins;
    out[((static_cast<int64_t>(l) * n_nodes + nd) * f + feat) * n_bins + b] =
        make_float2(acc_g, acc_h);
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
  if (L < 1 || n < 0 || f < 1 || n_nodes < 1 || n_bins < 1 ||
      L > 65535 || f > 65535 || cells > (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t warps_of_cells = (cells + 31) / 32 * 32;
  const int threads = static_cast<int>(
      warps_of_cells < MAX_THREADS ? warps_of_cells : MAX_THREADS);
  const dim3 grid(static_cast<unsigned>((cells + threads - 1) / threads), f, L);
  gbt_hist_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bins), static_cast<const float*>(grad),
      static_cast<const float*>(hess), static_cast<const int*>(node),
      static_cast<float2*>(out), n, f, n_nodes, n_bins);
  return static_cast<int>(cudaGetLastError());
}
