// Threshold counts of the binned curve metrics on Hopper, in float32:
//   tp[t, c] = sum over i of w[i, c] * tw[i, c]            * [p[i, c] >= thr[t]]
//   fp[t, c] = sum over i of w[i, c] * (w[i, c] - tw[i, c]) * [p[i, c] >= thr[t]]
// for scores p, weighted targets tw and weights w of shape (M, C) (or a
// per-row w of shape (M,)) and T thresholds in the caller's order. The weight
// enters twice, as it does in the Pallas kernel and its jnp reference: the
// curve updates pass tw = y * w with 0/1 masks w, where w * w = w. A NaN
// score passes no threshold (every comparison with NaN is false), nor does
// -inf unless a threshold is -inf.
//
// Replaces: metrics_tpu/kernels/binned_curve.py::_kernel (the Pallas TPU
// kernel behind pallas_counts). That kernel keeps a (T, 1) accumulator in
// VMEM across a sequential grid over (8, 1024) sample tiles, builds the
// (T, 1024) compare block on the vector unit and reduces it with two MXU
// matvecs. Hopper blocks run in parallel and in no order, so nothing carries
// over between them, and float atomics would add in an order that changes
// from run to run. Here each block owns a fixed, contiguous range of sample
// rows of one column, and writes its own (T,) partial sums; a second kernel
// sums the partials of every block in a fixed order (one warp per count). The number of blocks and
// the ranges depend on M alone (not on the card), so the same input gives
// the same bits on every H100. With 0/1 weights every partial is an integer,
// exact in float32 below 2^24 samples, so the result is bit-identical to the
// plain comparison-matmul version there.
//
// What bounds it: operations. Per sample and threshold one compare and two
// adds, against 12 bytes read per sample (p, tw, w), so at T = 200 the work
// is about 50 operations per byte, far above the card's float32 rate over
// its memory rate (67 TFLOP/s / 3.35 TB/s = 20). What the design does about
// it: each thread holds kThrPerThread thresholds and their two sums in
// registers, and reads each staged sample once from shared memory (a
// broadcast: every thread of a warp reads the same address) for
// kThrPerThread compares; w * tw and w * (w - tw) are formed once per sample
// when the tile is staged. When T / kThrPerThread is below the block's
// thread count, the block splits into groups that take alternate samples of
// each tile, and the groups' sums are added in group order at the end, so
// the result does not depend on timing. T above kMaxThrPerBlock is cut into
// chunks along the grid's z axis.
// Left for later: the sorted-threshold route (bucketize + histogram + suffix
// sum, O(M log T)), coalesced loads of the C columns of a row by one block,
// and 16-byte loads.
//
// Interface: plain C functions, loaded with ctypes (no PyTorch headers). The
// launch function runs both kernels on the given stream, does not
// synchronise, allocates nothing (the caller hands in the scratch for the
// partials), and returns the CUDA error code of the launches (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kThrPerThread = 4;
constexpr int kMaxThrPerBlock = kThreads * kThrPerThread;  // 1024 thresholds per z chunk
constexpr int kTile = 1024;                                // sample rows staged in shared memory at a time
constexpr long long kMaxRowBlocks = 512;                   // row blocks per column at most
constexpr int kReduceThreads = 256;

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Rows per block: whole tiles, as few as keep the row blocks at or below
// kMaxRowBlocks. A function of M alone.
long long rows_per_block(long long m) {
  const long long tiles = ceil_div(m, kTile);
  return ceil_div(tiles, kMaxRowBlocks) * kTile;
}

// grid (row blocks, C, threshold chunks). part_tp / part_fp: (row blocks, C, T).
__global__ void __launch_bounds__(kThreads)
binned_curve_partials_kernel(const float* __restrict__ preds, const float* __restrict__ target_w,
                             const float* __restrict__ w, const float* __restrict__ thr, long long m, int n_cols,
                             int w_per_col, int n_thr, long long rows_per_blk, float* __restrict__ part_tp,
                             float* __restrict__ part_fp) {
  __shared__ float s_p[kTile];
  __shared__ float s_a[kTile];  // w * tw
  __shared__ float s_b[kTile];  // w * (w - tw)
  __shared__ float s_tp[kMaxThrPerBlock];
  __shared__ float s_fp[kMaxThrPerBlock];

  const int col = blockIdx.y;
  const int t0 = blockIdx.z * kMaxThrPerBlock;
  const int n_t = min(kMaxThrPerBlock, n_thr - t0);  // thresholds of this chunk
  const int slots = (n_t + kThrPerThread - 1) / kThrPerThread;
  const int groups = kThreads / slots;  // >= 1, since slots <= kThreads
  const int group = threadIdx.x / slots;
  const int slot = threadIdx.x % slots;
  const bool computes = group < groups;

  // this thread's thresholds: slot, slot + slots, ... within the chunk; NaN passes nothing
  float th[kThrPerThread];
  float acc_tp[kThrPerThread];
  float acc_fp[kThrPerThread];
#pragma unroll
  for (int k = 0; k < kThrPerThread; ++k) {
    const int t = slot + k * slots;
    th[k] = (computes && t < n_t) ? thr[t0 + t] : __int_as_float(0x7fc00000);  // NaN
    acc_tp[k] = 0.0f;
    acc_fp[k] = 0.0f;
  }

  const long long row0 = (long long)blockIdx.x * rows_per_blk;
  const long long row1 = min(m, row0 + rows_per_blk);
  for (long long base = row0; base < row1; base += kTile) {
    const int n = (int)min((long long)kTile, row1 - base);
    __syncthreads();  // the previous tile has been read by every group
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const long long i = base + j;
      const float p = preds[i * n_cols + col];
      const float tw = target_w[i * n_cols + col];
      const float ww = w[w_per_col ? i * n_cols + col : i];
      s_p[j] = p;
      s_a[j] = ww * tw;
      s_b[j] = ww * (ww - tw);
    }
    __syncthreads();
    if (computes) {
      for (int j = group; j < n; j += groups) {  // this group's samples, in row order
        const float p = s_p[j];
        const float a = s_a[j];
        const float b = s_b[j];
#pragma unroll
        for (int k = 0; k < kThrPerThread; ++k) {
          if (p >= th[k]) {
            acc_tp[k] += a;
            acc_fp[k] += b;
          }
        }
      }
    }
  }

  // add the groups' sums in group order: group 0 stores, then each later group adds
  for (int g = 0; g < groups; ++g) {
    if (computes && group == g) {
#pragma unroll
      for (int k = 0; k < kThrPerThread; ++k) {
        const int t = slot + k * slots;
        if (t < n_t) {
          s_tp[t] = g == 0 ? acc_tp[k] : s_tp[t] + acc_tp[k];
          s_fp[t] = g == 0 ? acc_fp[k] : s_fp[t] + acc_fp[k];
        }
      }
    }
    __syncthreads();
  }

  const long long out = ((long long)blockIdx.x * n_cols + col) * n_thr + t0;
  for (int t = threadIdx.x; t < n_t; t += kThreads) {
    part_tp[out + t] = s_tp[t];
    part_fp[out + t] = s_fp[t];
  }
}

// One warp per (column, threshold): lane l adds the partials of row blocks
// l, l + 32, ... in block order, then lane 0 takes the 32 lane sums through a
// fixed butterfly of xor shuffles, so the order of every addition is fixed.
// tp / fp: (T, C) row-major.
__global__ void __launch_bounds__(kReduceThreads)
binned_curve_sum_kernel(const float* __restrict__ part_tp, const float* __restrict__ part_fp, int row_blocks,
                        int n_cols, int n_thr, float* __restrict__ tp, float* __restrict__ fp) {
  const long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;  // col * n_thr + t, one per warp
  const int lane = threadIdx.x % 32;
  const long long cells = (long long)n_cols * n_thr;
  if (j >= cells) return;  // the whole warp leaves together
  float s_tp = 0.0f;
  float s_fp = 0.0f;
  for (int b = lane; b < row_blocks; b += 32) {
    s_tp += part_tp[b * cells + j];
    s_fp += part_fp[b * cells + j];
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    s_tp += __shfl_xor_sync(0xffffffffu, s_tp, offset);
    s_fp += __shfl_xor_sync(0xffffffffu, s_fp, offset);
  }
  if (lane == 0) {
    const int col = (int)(j / n_thr);
    const int t = (int)(j % n_thr);
    tp[(long long)t * n_cols + col] = s_tp;
    fp[(long long)t * n_cols + col] = s_fp;
  }
}

}  // namespace

extern "C" {

// The number of row blocks for m sample rows: the first dimension of the
// partials' scratch, (row blocks, C, T) floats for each of tp and fp.
long long binned_curve_row_blocks(long long m) { return m <= 0 ? 0 : ceil_div(m, rows_per_block(m)); }

// preds, target_w: m * n_cols float32 (row-major (m, n_cols)); w: m * n_cols
// float32 if w_per_col, else m (one weight per row); thr: n_thr float32;
// part_tp, part_fp: binned_curve_row_blocks(m) * n_cols * n_thr float32 of
// scratch; tp, fp: n_thr * n_cols float32 (row-major (n_thr, n_cols));
// stream: a cudaStream_t. The caller guarantees 1 <= m < 2^31,
// 1 <= n_cols <= 65535 and 1 <= n_thr <= 65535 * 1024.
int binned_curve_launch(const void* preds, const void* target_w, const void* w, int w_per_col, const void* thr,
                        long long m, int n_cols, int n_thr, void* part_tp, void* part_fp, void* tp, void* fp,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rpb = rows_per_block(m);
  const long long row_blocks = ceil_div(m, rpb);
  const dim3 grid((unsigned)row_blocks, (unsigned)n_cols, (unsigned)ceil_div(n_thr, kMaxThrPerBlock));
  float* ptp = static_cast<float*>(part_tp);
  float* pfp = static_cast<float*>(part_fp);
  binned_curve_partials_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(preds), static_cast<const float*>(target_w), static_cast<const float*>(w),
      static_cast<const float*>(thr), m, n_cols, w_per_col, n_thr, rpb, ptp, pfp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)n_cols * n_thr;
  binned_curve_sum_kernel<<<(unsigned)ceil_div(cells * 32, kReduceThreads), kReduceThreads, 0, s>>>(
      ptp, pfp, (int)row_blocks, n_cols, n_thr, static_cast<float*>(tp), static_cast<float*>(fp));
  return (int)cudaGetLastError();
}

const char* binned_curve_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
