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
// matvecs: N·T compares, cheap on a TPU's wide vector unit. Hopper blocks run
// in parallel and in no order, so nothing carries over between them, and
// float atomics would add in an order that changes from run to run.
//
// What bounds it: bytes. The function needs O(N log T) operations (sort the
// thresholds, a binary search and five flops per sample, a suffix sum: about
// 0.2 us at N = 10^6, T = 200), against 12 bytes read per sample (p, tw, w)
// and 8 written per count: 3.58 us at N = 10^6, T = 200 on the card's
// 3.35 TB/s. The first port compared every sample with every threshold
// (N·T work, 14.7x the bound at T = 200, 60.7x at T = 1024). What the design
// does about it, the sorted-threshold route (two kernels, one wrapper call),
// taken when a hist block's tables fit kSortedSmemBudget of shared memory:
//   1. hist: each block takes a fixed range of rows and sorts the thresholds
//      in shared memory (a bitonic sort of (value, index), NaN last, skipped
//      when they are ascending and free of NaN, as linspace thresholds are).
//      Each warp takes one column (C > 8: several; C <= 8: 8 / C warps per
//      column on alternate row chunks), lane l row l of each pass of 32
//      rows, the next pass loaded while this one is counted; for C > 1 the
//      warps of a block read neighbouring columns of the same rows, so the
//      sectors a warp loads serve the others from L1. A score's bucket b(p),
//      the number of sorted thresholds with p >= s, starts from a linear
//      guess between the first and the last finite threshold and walks at
//      most kWalk steps, then binary-searches; every step asks only p >= s,
//      so a NaN score lands in bucket 0 and -0.0 / +0.0 and +-inf decide as
//      in the comparison form, and the bucket is exact whatever the guess.
//      w * tw and w * (w - tw) that are both 0 or 1 (every row of a curve
//      update, whose weights are 0/1 masks) go into the block's int counts
//      by shared-memory int atomics, which sum the same in any order; other
//      values go into the warp's own float histogram (zeroed at its first
//      use) in rounds, in each of which the lowest remaining lane of every
//      bucket adds its values (an int tag per bucket elects it), so float
//      sums run in a fixed order. The block then turns float(count) + its
//      warps' float sums (in warp order) into suffix sums over the sorted
//      buckets, one warp per column (lane chunks from the top down, then the
//      chunks above a lane in a fixed order), and writes them as its partials.
//   2. reduce: one warp per (column, sorted threshold) adds the blocks'
//      partials in a fixed order (lane l takes blocks l, l + 32, ...; a fixed
//      xor butterfly adds the lanes) and writes the count to the caller's
//      index of that threshold. A NaN threshold sorts after every bucket a
//      score reaches, so its counts are 0.
// The number of blocks and their ranges depend on the shape alone, so the
// same input gives the same bits on every H100. With 0/1 weights every sum
// is an integer, exact in float32 below 2^24 samples, so the counts are
// bit-identical to the plain comparison-matmul version there.
//
// The comparison route (kernels partials + sum, as first ported) takes the
// shapes whose tables do not fit (uses_sorted; from the shapes alone): each
// block owns a fixed range of sample rows of one column, each thread holds
// kThrPerThread thresholds in registers and compares every staged sample
// with them, groups of threads take alternate samples when T is small, and
// the groups' sums are added in group order; the second kernel adds the
// blocks' partials in a fixed order (one warp per count). T above
// kMaxThrPerBlock is cut into chunks along the grid's z axis.
// Left for later: 16-byte loads, a float path that does not reserve shared
// memory for its per-warp histograms (it limits the blocks per SM at large
// T), and staging the rows of a block through shared memory for C > 1.
//
// Interface: plain C functions, loaded with ctypes (no PyTorch headers). The
// launch function runs the route's kernels on the given stream, does not
// synchronise, allocates nothing (the caller hands in the scratch), and
// returns the CUDA error code of the launches (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kThrPerThread = 4;
constexpr int kMaxThrPerBlock = kThreads * kThrPerThread;  // 1024 thresholds per z chunk
constexpr int kTile = 1024;                                // sample rows staged in shared memory at a time
constexpr long long kMaxRowBlocks = 512;                   // row blocks per column at most
constexpr int kReduceThreads = 256;

// The sorted-threshold route.
constexpr long long kMinElemsPerBlock = 2048;
constexpr long long kMaxSortedBlocks = 264;     // 2 per SM of an H100
constexpr long long kHistDiv = 2;
constexpr long long kSortedSmemBudget = 230000;  // bytes of dynamic shared memory of a hist block at most
// Rows a lane takes per pass. More rows side by side measured slower (4 spills);
// this loop over one-element arrays also ran faster on the card than the same
// loop written with scalars.
constexpr int kIlp = 1;
#define kInf __int_as_float(0x7f800000)
constexpr int kWalk = 4;  // steps a lane walks from its guessed bucket before it binary-searches

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

// ----------------------------------------------------------------- sorted-threshold route

// The warps of a hist block and the float histograms they own. A warp owns
// the histograms (one per column it takes) that only it writes. For C <= 8
// the block has 8 / C warps per column (phases), which take alternate row
// chunks; for C > 8 it has min(C, kMaxHistWarps) warps and warp w takes the
// columns w, w + kMaxHistWarps, ...
constexpr int kMaxHistWarps = 16;
constexpr int kFewColWarps = 8;  // warps of a block for C <= 8
__host__ __device__ int hist_warps(int n_cols) {
  return n_cols <= 8 ? kFewColWarps : (n_cols < kMaxHistWarps ? n_cols : kMaxHistWarps);
}
__host__ __device__ int hist_phases(int n_cols) { return n_cols <= 8 ? kFewColWarps / n_cols : 1; }
__host__ __device__ int hist_cols_per_warp(int n_cols) {
  return n_cols <= 8 ? 1 : (n_cols + kMaxHistWarps - 1) / kMaxHistWarps;
}
__host__ __device__ int hist_units(int n_cols) {
  return n_cols <= 8 ? hist_phases(n_cols) * n_cols : hist_warps(n_cols) * hist_cols_per_warp(n_cols);
}
__host__ __device__ int pow2_at_least(int t) {
  int p = 1;
  while (p < t) p <<= 1;
  return p;
}

// Dynamic shared memory of a hist block: the block's int counts (2 per
// bucket of each column), the warps' float histograms (a float2 sum and an
// int tag per bucket, and a flag per histogram), and the thresholds with
// their indices, padded to a power of two for the in-block sort.
long long hist_smem_bytes(int n_cols, int n_thr) {
  const long long buckets = n_thr + 1;
  return (long long)n_cols * buckets * sizeof(int2) +
         (long long)hist_units(n_cols) * (buckets * (sizeof(float2) + sizeof(int)) + sizeof(int)) +
         (long long)pow2_at_least(n_thr) * (sizeof(float) + sizeof(int));
}

bool uses_sorted(int n_cols, int n_thr) {
  return n_thr <= (1 << 20) && hist_smem_bytes(n_cols, n_thr) <= kSortedSmemBudget;
}

// Rows per hist block: as many blocks as keep each at kMinElemsPerBlock
// elements or more, and at 1 / kHistDiv of the buckets of its histograms or
// more (a block zeroes and writes out its counts), at most kMaxSortedBlocks
// for C <= 8 and twice that above (blocks of one column are latency-bound
// whatever their number, and fewer of them mean fewer partials to add; blocks
// of 10 columns gain from more warps per SM); a function of the shape alone.
long long sorted_rows_per_block(long long m, int n_cols, int n_thr) {
  const long long by_hist = (long long)hist_units(n_cols) * (n_thr + 1) / kHistDiv;
  long long blocks = ceil_div(m * n_cols, by_hist > kMinElemsPerBlock ? by_hist : kMinElemsPerBlock);
  const long long most = n_cols <= 8 ? kMaxSortedBlocks : 2 * kMaxSortedBlocks;
  if (blocks > most) blocks = most;
  return ceil_div(m, blocks);
}

// Threshold order: ascending, NaN last, ties in the caller's order.
__device__ __forceinline__ bool sorts_before(float a, int ia, float b, int ib) {
  const bool a_nan = isnan(a);
  const bool b_nan = isnan(b);
  if (a_nan != b_nan) return b_nan;
  if (!a_nan && a != b) return a < b;
  return ia < ib;
}

// The number of sorted thresholds s[0, n_real) with p >= s, asking only p >= s
// (a NaN score gets 0; -0.0 / +0.0 and +-inf decide as in the comparison
// form). A lane walks up to kWalk steps from its guess g, which is exact
// whatever g is; a lane the walk did not settle binary-searches.
__device__ __forceinline__ int bucket_of(float p, int g, const float* s, int n_real, int top) {
  int b = g;
  int k = 0;
  while (k < kWalk && b < n_real && p >= s[b]) {
    ++b;
    ++k;
  }
  bool settled = !(b < n_real && p >= s[b]);  // here b = n_real or p < s[b]
  if (k == 0) {  // no step up: p < s[g] (or g = n_real); walk down
    while (k < kWalk && b > 0 && !(p >= s[b - 1])) {
      --b;
      ++k;
    }
    settled = !(b > 0 && !(p >= s[b - 1]));
  }
  if (!settled) {
    b = 0;
    for (int step = top; step > 0; step >>= 1) {
      const int c = b + step;
      if (c <= n_real && p >= s[c - 1]) b = c;
    }
  }
  return b;
}

// The kIlp rows of a pass from row r of the block: r, r + 32, ...; the last row
// of the block stands in for rows past its end, whose values are then not used.
__device__ __forceinline__ void load_pass(const float* __restrict__ preds, const float* __restrict__ target_w,
                                          const float* __restrict__ w, int w_per_col, long long row0, int n_rows,
                                          int n_cols, int col, int r, float (&p)[kIlp], float (&tw)[kIlp],
                                          float (&ww)[kIlp]) {
#pragma unroll
  for (int u = 0; u < kIlp; ++u) {
    const long long row = row0 + min(r + 32 * u, n_rows - 1);
    const long long e = row * n_cols + col;
    ww[u] = __ldg(w + (w_per_col ? e : row));
    tw[u] = __ldg(target_w + e);
    p[u] = __ldg(preds + e);
  }
}

// grid: one block per sorted_rows_per_block(m, n_cols) rows; hist_warps(n_cols)
// warps. Each block sorts the thresholds in shared memory (a bitonic sort,
// skipped when they are ascending and free of NaN) and puts each score in its
// bucket. A lane whose w * tw and w * (w - tw) are both 0 or 1 (every lane of
// a curve update, whose weights are 0/1 masks) adds them to the block's int
// counts with integer atomics, which give the same sum in any order. A lane
// with other values adds them to its warp's float histogram, in rounds: in
// each, the lowest remaining lane of every bucket adds its values (an int
// tag per bucket elects it), so the float sums run in a fixed order. Each
// bucket's sum is float(count) + the warps' float sums in warp order; part[b]
// holds, per column and sorted threshold t, the block's suffix sum over the
// buckets above t: (blocks, n_cols, n_thr) float2. The next pass of rows is
// loaded while a warp counts the current one. Block 0 also writes order[t],
// the caller's index of sorted threshold t.
__global__ void __launch_bounds__(32 * kMaxHistWarps)
binned_curve_hist_kernel(const float* __restrict__ preds, const float* __restrict__ target_w,
                         const float* __restrict__ w, int w_per_col, const float* __restrict__ thr, long long m,
                         int n_cols, int n_thr, long long rows_per_blk, float2* __restrict__ part,
                         int* __restrict__ order) {
  extern __shared__ int2 smem[];
  const int n_buckets = n_thr + 1;
  const int cells = n_cols * n_buckets;
  const int units = hist_units(n_cols);
  const int n_pad = pow2_at_least(n_thr);
  int2* counts = smem;                                                      // cells
  float2* hist = reinterpret_cast<float2*>(counts + cells);                 // units x n_buckets
  int* tags = reinterpret_cast<int*>(hist + (size_t)units * n_buckets);     // units x n_buckets
  float* s_thr = reinterpret_cast<float*>(tags + (size_t)units * n_buckets);  // n_pad
  int* s_idx = reinterpret_cast<int*>(s_thr + n_pad);                       // n_pad
  int* used = s_idx + n_pad;                                                // units
  __shared__ int s_real, s_f0, s_f1;  // the first NaN, the first threshold above -inf, the last finite one
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (tid == 0) {
    s_real = n_thr;
    s_f0 = 0;
    s_f1 = -1;
  }
  for (int k = tid; k < cells; k += nthreads) counts[k] = make_int2(0, 0);
  for (int k = tid; k < units; k += nthreads) used[k] = 0;  // a float histogram is zeroed at its first use
  for (int k = tid; k < n_pad; k += nthreads) {
    s_thr[k] = k < n_thr ? thr[k] : __int_as_float(0x7fc00000);  // padding: NaN, after every threshold
    s_idx[k] = k;
  }
  __syncthreads();
  int in_order = 1;
  for (int k = tid; k < n_thr; k += nthreads) in_order &= !isnan(s_thr[k]) && (k == 0 || s_thr[k - 1] <= s_thr[k]);
  if (!__syncthreads_and(in_order)) {
    for (int size = 2; size <= n_pad; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < n_pad / 2; t += nthreads) {
          const int lo = (t / stride) * stride * 2 + t % stride;
          const int hi = lo + stride;
          const float a = s_thr[lo];
          const float b = s_thr[hi];
          const int ia = s_idx[lo];
          const int ib = s_idx[hi];
          if (sorts_before(b, ib, a, ia) == ((lo & size) == 0)) {
            s_thr[lo] = b;
            s_thr[hi] = a;
            s_idx[lo] = ib;
            s_idx[hi] = ia;
          }
        }
        __syncthreads();
      }
    }
  }
  for (int k = tid; k < n_thr; k += nthreads) {
    const float v = s_thr[k];
    if (blockIdx.x == 0) order[k] = s_idx[k];
    const bool above_neg_inf = !(v <= -kInf);  // NaN too
    const bool finite = above_neg_inf && v < kInf;
    if (isnan(v) && (k == 0 || !isnan(s_thr[k - 1]))) s_real = k;  // NaN sorts last: the first NaN
    if (above_neg_inf && (k == 0 || s_thr[k - 1] == -kInf)) s_f0 = k;
    if (finite && (k == n_thr - 1 || !(s_thr[k + 1] < kInf))) s_f1 = k;
  }
  __syncthreads();
  const int n_real = s_real;
  const int top = n_real > 0 ? 1 << (31 - __clz(n_real)) : 0;  // the largest power of two <= n_real
  // the guess: linear between the first and the last finite threshold
  const int f0 = s_f0;
  const int f1 = s_f1;
  const float lo_v = f0 < n_real ? s_thr[f0] : 0.0f;
  float scale = 0.0f;
  if (f1 > f0) {
    const float span = s_thr[f1] - lo_v;
    // a guess need not be exact: the fast division keeps the slow-path call (and its stack frame) out
    if (span > 0.0f && span < kInf) scale = __fdividef((float)(f1 - f0), span);
  }
  const float guess_max = (float)(n_real - f0);

  // this warp's columns and phase
  const bool few_cols = n_cols <= 8;
  const int phases = hist_phases(n_cols);
  const int nw = nthreads / 32;
  const int cpw = hist_cols_per_warp(n_cols);
  const int phase = few_cols ? warp / n_cols : 0;
  const long long row0 = (long long)blockIdx.x * rows_per_blk;
  const int n_rows = (int)min(rows_per_blk, m - row0);
  const int chunk = 32 * kIlp;

  const int step = phases * chunk;

  for (int j = 0; j < (few_cols ? (warp < phases * n_cols) : cpw); ++j) {
    const int col = few_cols ? warp % n_cols : warp + j * nw;
    if (col >= n_cols) break;
    const int unit = few_cols ? warp : warp * cpw + j;
    int2* col_counts = counts + (size_t)col * n_buckets;
    float2* my_hist = hist + (size_t)unit * n_buckets;
    int* my_tag = tags + (size_t)unit * n_buckets;
    bool ready = false;  // whether this warp has zeroed my_hist and my_tag
    float p[kIlp], tw[kIlp], ww[kIlp];
    int base = phase * chunk;
    if (base < n_rows) load_pass(preds, target_w, w, w_per_col, row0, n_rows, n_cols, col, base + lane, p, tw, ww);
    for (; base < n_rows; base += step) {
      float np[kIlp], ntw[kIlp], nww[kIlp];  // the next pass, loaded while this one is counted
      if (base + step < n_rows) {
        load_pass(preds, target_w, w, w_per_col, row0, n_rows, n_cols, col, base + step + lane, np, ntw, nww);
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const bool valid = base + lane + 32 * u < n_rows;
        const float a = ww[u] * tw[u];
        const float b = ww[u] * (ww[u] - tw[u]);
        const float x = (p[u] - lo_v) * scale;
        const int g = x > 0.0f ? (x < guess_max ? f0 + (int)x : n_real) : f0;  // NaN: f0
        const int k = valid ? bucket_of(p[u], g, s_thr, n_real, top) : -1;
        const bool whole = (a == 0.0f || a == 1.0f) && (b == 0.0f || b == 1.0f);
        if (k >= 0 && whole) {
          if (a != 0.0f) atomicAdd(&col_counts[k].x, 1);
          if (b != 0.0f) atomicAdd(&col_counts[k].y, 1);
        }
        bool todo = k >= 0 && !whole;
        if (!ready && __any_sync(0xffffffffu, todo)) {
          for (int i = lane; i < n_buckets; i += 32) {
            my_hist[i] = make_float2(0.0f, 0.0f);
            my_tag[i] = 32;
          }
          if (lane == 0) used[unit] = 1;
          __syncwarp();
          ready = true;
        }
        while (__any_sync(0xffffffffu, todo)) {
          if (todo) atomicMin(my_tag + k, lane);
          __syncwarp();
          if (todo && my_tag[k] == lane) {
            float2 h = my_hist[k];
            h.x += a;
            h.y += b;
            my_hist[k] = h;
            my_tag[k] = 32;
            todo = false;
          }
          __syncwarp();
        }
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        p[u] = np[u];
        tw[u] = ntw[u];
        ww[u] = nww[u];
      }
    }
  }
  __syncthreads();

  // combine in place: float(count) + the warps' float sums in warp order, per column and bucket
  float2* sums = reinterpret_cast<float2*>(counts);
  for (int k = tid; k < cells; k += nthreads) {
    const int col = k / n_buckets;
    const int bucket = k - col * n_buckets;
    const int2 c = counts[k];
    float2 acc = make_float2((float)c.x, (float)c.y);
    for (int ph = 0; ph < (few_cols ? phases : 1); ++ph) {
      const int unit = few_cols ? ph * n_cols + col : (col % nw) * cpw + col / nw;
      if (!used[unit]) continue;
      const float2 v = hist[(size_t)unit * n_buckets + bucket];
      acc.x += v.x;
      acc.y += v.y;
    }
    sums[k] = acc;
  }
  __syncthreads();

  // suffix sums, one warp per column: lane l sums its chunk of buckets from the
  // top down, adds the chunks of lanes 31, 30, ..., l + 1 in that order, and
  // writes the suffix at bucket k >= 1 (the samples passing sorted threshold k - 1)
  float2* out = part + (long long)blockIdx.x * n_cols * n_thr;
  const int per = (n_buckets + 31) / 32;
  const int k0 = lane * per;
  const int k1 = min(n_buckets, k0 + per);
  for (int col = warp; col < n_cols; col += nw) {
    const float2* h = sums + (size_t)col * n_buckets;
    float2 mine = make_float2(0.0f, 0.0f);
    for (int k = k1 - 1; k >= k0; --k) {
      mine.x += h[k].x;
      mine.y += h[k].y;
    }
    float2 above = make_float2(0.0f, 0.0f);
    for (int l = 31; l > 0; --l) {
      const float x = __shfl_sync(0xffffffffu, mine.x, l);
      const float y = __shfl_sync(0xffffffffu, mine.y, l);
      if (l > lane) {
        above.x += x;
        above.y += y;
      }
    }
    for (int k = k1 - 1; k >= k0; --k) {
      above.x += h[k].x;
      above.y += h[k].y;
      if (k >= 1) out[(long long)col * n_thr + k - 1] = above;
    }
  }
}

// One warp per (column, sorted threshold t): lane l adds the blocks' suffix
// sums of blocks l, l + 32, ... in block order, a fixed xor butterfly adds the
// lanes, and lane 0 writes the counts of threshold order[t], the caller's
// index of sorted threshold t. A NaN threshold sorts after every bucket a
// score reaches, so its counts are 0. tp / fp: (T, C) row-major.
__global__ void __launch_bounds__(kReduceThreads)
binned_curve_reduce_kernel(const float2* __restrict__ part, int blocks, int n_cols, int n_thr,
                           const int* __restrict__ order, float* __restrict__ tp, float* __restrict__ fp) {
  const long long cells = (long long)n_cols * n_thr;
  const long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;  // col * n_thr + t
  const int lane = threadIdx.x % 32;
  if (j >= cells) return;  // the whole warp leaves together
  float s_tp = 0.0f;
  float s_fp = 0.0f;
#pragma unroll 8
  for (int b = lane; b < blocks; b += 32) {
    const float2 v = part[(long long)b * cells + j];
    s_tp += v.x;
    s_fp += v.y;
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    s_tp += __shfl_xor_sync(0xffffffffu, s_tp, offset);
    s_fp += __shfl_xor_sync(0xffffffffu, s_fp, offset);
  }
  if (lane == 0) {
    const int col = (int)(j / n_thr);
    const long long i = order[j - (long long)col * n_thr];
    tp[i * n_cols + col] = s_tp;
    fp[i * n_cols + col] = s_fp;
  }
}

// Scratch of the sorted route, in 4-byte words: the blocks' suffix sums and
// the threshold order.
long long sorted_scratch_words(long long m, int n_cols, int n_thr) {
  return 2LL * n_cols * n_thr * ceil_div(m, sorted_rows_per_block(m, n_cols, n_thr)) + n_thr;
}

cudaError_t launch_sorted(const float* preds, const float* target_w, const float* w, int w_per_col,
                          const float* thr, long long m, int n_cols, int n_thr, float* scratch, float* tp, float* fp,
                          cudaStream_t s) {
  const long long rows_per_blk = sorted_rows_per_block(m, n_cols, n_thr);
  const long long blocks = ceil_div(m, rows_per_blk);
  const long long cells = (long long)n_cols * n_thr;
  float2* part = reinterpret_cast<float2*>(scratch);
  int* order = reinterpret_cast<int*>(part + blocks * cells);

  const size_t smem = (size_t)hist_smem_bytes(n_cols, n_thr);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(binned_curve_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  binned_curve_hist_kernel<<<(unsigned)blocks, 32 * hist_warps(n_cols), smem, s>>>(
      preds, target_w, w, w_per_col, thr, m, n_cols, n_thr, rows_per_blk, part, order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  binned_curve_reduce_kernel<<<(unsigned)ceil_div(cells * 32, kReduceThreads), kReduceThreads, 0, s>>>(
      part, (int)blocks, n_cols, n_thr, order, tp, fp);
  return cudaGetLastError();
}

cudaError_t launch_compare(const float* preds, const float* target_w, const float* w, int w_per_col,
                           const float* thr, long long m, int n_cols, int n_thr, float* scratch, float* tp,
                           float* fp, cudaStream_t s) {
  const long long rpb = rows_per_block(m);
  const long long row_blocks = ceil_div(m, rpb);
  const dim3 grid((unsigned)row_blocks, (unsigned)n_cols, (unsigned)ceil_div(n_thr, kMaxThrPerBlock));
  float* ptp = scratch;
  float* pfp = scratch + row_blocks * n_cols * n_thr;
  binned_curve_partials_kernel<<<grid, kThreads, 0, s>>>(preds, target_w, w, thr, m, n_cols, w_per_col, n_thr, rpb,
                                                          ptp, pfp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long cells = (long long)n_cols * n_thr;
  binned_curve_sum_kernel<<<(unsigned)ceil_div(cells * 32, kReduceThreads), kReduceThreads, 0, s>>>(
      ptp, pfp, (int)row_blocks, n_cols, n_thr, tp, fp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when (n_cols, n_thr) takes the sorted-threshold route, 0 when it takes
// the comparison route.
int binned_curve_uses_sorted(int n_cols, int n_thr) { return uses_sorted(n_cols, n_thr) ? 1 : 0; }

// The scratch that binned_curve_launch needs for m sample rows, in float32 words.
long long binned_curve_scratch_words(long long m, int n_cols, int n_thr) {
  if (m <= 0) return 0;
  if (uses_sorted(n_cols, n_thr)) return sorted_scratch_words(m, n_cols, n_thr);
  return 2 * ceil_div(m, rows_per_block(m)) * n_cols * (long long)n_thr;
}

// preds, target_w: m * n_cols float32 (row-major (m, n_cols)); w: m * n_cols
// float32 if w_per_col, else m (one weight per row); thr: n_thr float32;
// scratch: binned_curve_scratch_words(m, n_cols, n_thr) float32 words, 8-byte
// aligned; tp, fp: n_thr * n_cols float32 (row-major (n_thr, n_cols)); stream:
// a cudaStream_t. The caller guarantees 1 <= m < 2^31, 1 <= n_cols <= 65535
// and 1 <= n_thr <= 65535 * 1024.
int binned_curve_launch(const void* preds, const void* target_w, const void* w, int w_per_col, const void* thr,
                        long long m, int n_cols, int n_thr, void* scratch, void* tp, void* fp, void* stream) {
  auto launch = uses_sorted(n_cols, n_thr) ? launch_sorted : launch_compare;
  return (int)launch(static_cast<const float*>(preds), static_cast<const float*>(target_w),
                     static_cast<const float*>(w), w_per_col, static_cast<const float*>(thr), m, n_cols, n_thr,
                     static_cast<float*>(scratch), static_cast<float*>(tp), static_cast<float*>(fp),
                     static_cast<cudaStream_t>(stream));
}

const char* binned_curve_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
