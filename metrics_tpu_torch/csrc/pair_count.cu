// Pair counts on Hopper, two routes over the same pairs (row[i], col[i]) of two
// label vectors. A label is read as the caller stores it, int32 or int64, and
// only its low 32 bits count (what `.to(torch.int32)` keeps, and what the JAX
// package sees with x64 off). A pair is valid when both labels lie in range,
// the row label (the target) differs from `ignore_index` (compared after the
// truncation), and mask[i] != 0 where a mask is given. Invalid pairs are
// dropped.
//
//   table route (pair_count_launch): counts[r, c] = number of valid pairs
//     (r, c), into a zeroed (num_rows, num_cols) int32 table. The confusion
//     matrix.
//   stat-score route (stat_scores_launch): the int32 tp, fp, tn, fn of each of
//     num_classes classes, without the table: a valid pair (t, p) adds 1 to
//     tp[t] if t == p, else 1 to fn[t] and 1 to fp[p]; tn[c] = n_valid - tp[c]
//     - fn[c] - fp[c]. These are the counts the JAX package derives from the
//     (C, C) matrix (metrics_tpu/functional/classification/stat_scores.py:
//     334-339): tp = diag, fn = row sums - tp, fp = column sums - tp, tn = total
//     - tp - fn - fp, all int32.
//
// Replaces: metrics_tpu/kernels/confmat.py::_pair_count_kernel (the Pallas TPU
// kernel behind pair_count_fused) and, for the stat scores, the diag and sums
// that follow it. That kernel walks a sequential grid and carries one resident
// f32 (R, C) accumulator across grid steps, building one-hot tiles on chip for
// the MXU. Hopper blocks run in parallel and in no order, so each block counts
// its grid-stride share with int32 atomics. Integer addition does not depend
// on order, so every count is bit-identical to the bincount reference however
// the blocks interleave, and exact for every N < 2^31.
//
// What bounds it: memory. Per pair two labels are read (16 bytes as int64) and
// one or two counters are incremented; the output is R*C*4 (table) or 16*C
// (stat scores) bytes. What the design does about it:
//   - labels are read where they lie, int64 included, four pairs a thread at a
//     time with 16-byte loads when both arrays are 16-byte aligned (scalar
//     loads otherwise, and for the last n % 4 pairs): no cast pass before the
//     kernel, no mask pass for ignore_index.
//   - table route, tables that fit in a block's shared memory: each block of
//     1024 threads (one an SM) keeps a private int32 table in shared memory
//     (per-pair atomics stay on the SM). Blocks run in thread-block clusters
//     of two, one block on each SM: after counting, each block of a
//     cluster sums its half of the two tables through distributed shared
//     memory and adds only that half's non-zero cells into the output, so the
//     global flush is clusters x cells atomics, not blocks x cells.
//   - table route, larger tables (the training step's 1000 x 1000 = 4 MB):
//     atomics go straight to the output, which sits in the 50 MB L2, from
//     blocks of 64 threads, so that 1024 pairs spread over 4 SMs.
//   - stat-score route: 3*C private counters in shared memory (12 KB at
//     C = 1000), a warp-shuffle count of the valid pairs, then 3*C + 1 global
//     atomics a block; the last block to finish (a ticket taken after a fence)
//     writes tn. A grid of one block (the training step's 1024 pairs) writes
//     its counts with plain stores and takes no ticket. Above the
//     shared-memory limit the counters are the output's. No torch op follows
//     the kernel.
//   - the host side of a launch queries the device once: its SM count and
//     shared-memory limit, and each kernel's occupancy at each shared-memory
//     size, are cached per device.
//
// Interface: plain C functions, loaded with ctypes (no PyTorch headers). They
// launch on the given stream, do not synchronise, allocate nothing, and return
// the CUDA error code of the launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

// Global-atomic table blocks are small, so that a short batch (the training
// step's 1024 pairs) spreads its atomics over several SMs.
constexpr int kThreads = 64;
constexpr int kGlobalBlocksPerSm = 32;
constexpr int kWideThreads = 1024;  // shared-memory table blocks and stat-score blocks, one an SM
// Blocks per cluster of the shared-memory table branch. Two beat 1 (no cluster),
// 4, 8 and 16 at the six-metric collection's shape (PERF.md, section 6).
constexpr int kCluster = 2;
// A stat-score block streams at least this many pairs a thread before the grid grows.
constexpr int kStatPairsPerThread = 8;

struct Rule {
  int rows, cols;
  int ignore;  // dropped row label (an int32: the wrappers reject any other ignore_index)
  int has_ignore;
  const uint8_t* mask;  // NULL: every pair
};

__device__ __forceinline__ bool valid(const Rule& rule, int r, int c, long long i) {
  bool ok = (unsigned)r < (unsigned)rule.rows && (unsigned)c < (unsigned)rule.cols;
  if (rule.has_ignore) ok = ok && r != rule.ignore;
  if (rule.mask) ok = ok && rule.mask[i] != 0;
  return ok;
}

// Labels 4g .. 4g + 3, as the low 32 bits of each.
__device__ __forceinline__ void load4(const int32_t* p, long long g, bool vec, int v[4]) {
  if (vec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p) + g);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldg(p + 4 * g + k);
  }
}

__device__ __forceinline__ void load4(const long long* p, long long g, bool vec, int v[4]) {
  if (vec) {
    const int4* q = reinterpret_cast<const int4*>(p) + 2 * g;
    const int4 a = __ldg(q), b = __ldg(q + 1);
    v[0] = a.x; v[1] = a.z; v[2] = b.x; v[3] = b.z;  // little-endian: the low word comes first
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = (int)__ldg(p + 4 * g + k);
  }
}

__device__ __forceinline__ int load1(const int32_t* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ int load1(const long long* p, long long i) { return (int)__ldg(p + i); }

// Calls f(r, c, i) on this thread's grid-stride share of the pairs, four at a time.
template <typename R, typename C, typename F>
__device__ __forceinline__ void for_each_pair(const R* row, const C* col, long long n, bool vec, F&& f) {
  const long long groups = n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long g = tid; g < groups; g += stride) {
    int r[4], c[4];
    load4(row, g, vec, r);
    load4(col, g, vec, c);
#pragma unroll
    for (int k = 0; k < 4; ++k) f(r[k], c[k], 4 * g + k);
  }
  const long long i = 4 * groups + tid;  // the last n % 4 pairs
  if (i < n) f(load1(row, i), load1(col, i), i);
}

// Every kernel takes its labels untyped; R and C are the row and column label types.
template <typename R, typename C>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kWideThreads)
pair_count_cluster_kernel(const void* row_, const void* col_, long long n, Rule rule, bool vec, int32_t* out) {
  const R* row = static_cast<const R*>(row_);
  const C* col = static_cast<const C*>(col_);
  extern __shared__ int32_t hist[];
  const int cells = rule.rows * rule.cols;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for_each_pair(row, col, n, vec, [&](int r, int c, long long i) {
    if (valid(rule, r, c, i)) atomicAdd(&hist[r * rule.cols + c], 1);
  });

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every table of the cluster is complete
  // This block's slice [lo, hi) of the cells, summed over the cluster's tables (their loads
  // of a cell issued together); only non-zero sums become global atomics.
  const int chunk = (cells + kCluster - 1) / kCluster;
  const int lo = min(cells, (int)cluster.block_rank() * chunk);
  const int hi = min(cells, lo + chunk);
  const int32_t* tables[kCluster];
#pragma unroll
  for (int b = 0; b < kCluster; ++b) tables[b] = cluster.map_shared_rank(hist, b);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    int32_t part[kCluster];
#pragma unroll
    for (int b = 0; b < kCluster; ++b) part[b] = tables[b][i];
    int32_t v = 0;
#pragma unroll
    for (int b = 0; b < kCluster; ++b) v += part[b];
    if (v != 0) atomicAdd(&out[i], v);
  }
  cluster.sync();  // no block leaves while another still reads its table
}

template <typename R, typename C>
__global__ void __launch_bounds__(kThreads)
pair_count_global_kernel(const void* row_, const void* col_, long long n, Rule rule, bool vec, int32_t* out) {
  const R* row = static_cast<const R*>(row_);
  const C* col = static_cast<const C*>(col_);
  for_each_pair(row, col, n, vec, [&](int r, int c, long long i) {
    if (valid(rule, r, c, i)) atomicAdd(&out[(long long)r * rule.cols + c], 1);
  });
}

// out: tp | fp | tn | fn (num_classes each), then the valid count and the ticket, all zeroed.
template <typename R, typename C, bool kShared>
__global__ void __launch_bounds__(kWideThreads)
stat_scores_kernel(const void* target_, const void* preds_, long long n, Rule rule, bool vec, int32_t* out) {
  const R* target = static_cast<const R*>(target_);
  const C* preds = static_cast<const C*>(preds_);
  // kShared: tp | fn | fp; then the block's valid count and its last-block flag (no static
  // shared memory, so that the counters may take all of the opt-in limit)
  extern __shared__ int32_t counters[];
  const int classes = rule.rows;
  int32_t& block_valid = counters[kShared ? 3 * classes : 0];
  int32_t& last = counters[kShared ? 3 * classes + 1 : 1];
  int32_t* out_tp = out;
  int32_t* out_fp = out + classes;
  int32_t* out_tn = out + 2 * classes;
  int32_t* out_fn = out + 3 * classes;
  int32_t* out_valid = out + 4 * classes;
  unsigned* ticket = reinterpret_cast<unsigned*>(out + 4 * classes + 1);
  int32_t* tp = kShared ? counters : out_tp;
  int32_t* fn = kShared ? counters + classes : out_fn;
  int32_t* fp = kShared ? counters + 2 * classes : out_fp;
  if (kShared)
    for (int i = threadIdx.x; i < 3 * classes; i += blockDim.x) counters[i] = 0;
  if (threadIdx.x == 0) block_valid = 0;
  __syncthreads();

  int n_valid = 0;
  for_each_pair(target, preds, n, vec, [&](int t, int p, long long i) {
    if (!valid(rule, t, p, i)) return;
    ++n_valid;
    if (t == p) {
      atomicAdd(&tp[t], 1);
    } else {
      atomicAdd(&fn[t], 1);
      atomicAdd(&fp[p], 1);
    }
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n_valid += __shfl_down_sync(0xffffffffu, n_valid, o);
  if ((threadIdx.x & 31) == 0 && n_valid != 0) atomicAdd(&block_valid, n_valid);
  __syncthreads();

  if (kShared && gridDim.x == 1) {  // one block: its counts are the output, written without atomics
    for (int c = threadIdx.x; c < classes; c += blockDim.x) {
      out_tp[c] = tp[c];
      out_fp[c] = fp[c];
      out_fn[c] = fn[c];
      out_tn[c] = block_valid - tp[c] - fn[c] - fp[c];
    }
    return;
  }
  if (kShared) {
    for (int c = threadIdx.x; c < classes; c += blockDim.x) {
      if (tp[c] != 0) atomicAdd(&out_tp[c], tp[c]);
      if (fn[c] != 0) atomicAdd(&out_fn[c], fn[c]);
      if (fp[c] != 0) atomicAdd(&out_fp[c], fp[c]);
    }
  }
  if (threadIdx.x == 0 && block_valid != 0) atomicAdd(out_valid, block_valid);
  __threadfence();  // this block's counts are visible on the device before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1 ? 1 : 0;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int32_t total = __ldcg(out_valid);
  for (int c = threadIdx.x; c < classes; c += blockDim.x)
    out_tn[c] = total - __ldcg(out_tp + c) - __ldcg(out_fn + c) - __ldcg(out_fp + c);
}

// Dynamic shared memory of a stat-score block: 3 * num_classes counters where they are
// shared, then the block's valid count and flag.
size_t stat_scores_smem(int num_classes, bool shared) {
  return ((shared ? 3 * (size_t)num_classes : 0) + 2) * sizeof(int32_t);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

typedef void (*AnyKernel)(const void*, const void*, long long, Rule, bool, int32_t*);

// The instantiation of one kernel for the two label widths (wide: int64, else int32).
AnyKernel by_width(int row_wide, int col_wide, AnyKernel narrow_narrow, AnyKernel narrow_wide, AnyKernel wide_narrow,
                   AnyKernel wide_wide) {
  if (row_wide) return col_wide ? wide_wide : wide_narrow;
  return col_wide ? narrow_wide : narrow_narrow;
}

#define BY_WIDTH(kernel, ...)                                                                        \
  by_width(row_wide, col_wide, kernel<int32_t, int32_t, ##__VA_ARGS__>, kernel<int32_t, long long, ##__VA_ARGS__>, \
           kernel<long long, int32_t, ##__VA_ARGS__>, kernel<long long, long long, ##__VA_ARGS__>)

// What a launch asks of the device, cached per device so that a launch queries
// it once: the SM count and the opt-in shared memory per block, and each
// kernel's occupancy (clusters or blocks resident at once) at each dynamic
// shared-memory size. The wrappers may be called from several host threads.
constexpr int kMaxDevices = 64;
constexpr int kMaxOccupancies = 64;

struct DeviceLimits {
  bool known;
  int sms, smem_optin;
};

struct Occupancy {
  int dev;
  AnyKernel kernel;
  size_t smem;
  int value;
};

std::mutex cache_mutex;
DeviceLimits limits_cache[kMaxDevices];
Occupancy occupancy_cache[kMaxOccupancies];
int occupancies = 0;

cudaError_t device_limits(int* dev, int* sms, int* smem_optin) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(cache_mutex);
  if (*dev < kMaxDevices && limits_cache[*dev].known) {
    *sms = limits_cache[*dev].sms;
    *smem_optin = limits_cache[*dev].smem_optin;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
  if (err != cudaSuccess) return err;
  if (*dev < kMaxDevices) limits_cache[*dev] = {true, *sms, *smem_optin};
  return cudaSuccess;
}

// Clusters (cluster kernel) or blocks per SM (any other) of `kernel` resident at
// once with `smem` bytes of dynamic shared memory, at least 1. On first use of a
// kernel on a device it also lifts the kernel's dynamic shared-memory limit to
// the device's opt-in maximum.
cudaError_t resident(int dev, int smem_optin, AnyKernel kernel, bool cluster, size_t smem, int* out) {
  std::lock_guard<std::mutex> lock(cache_mutex);
  bool lifted = false;
  for (int k = 0; k < occupancies; ++k) {
    const Occupancy& o = occupancy_cache[k];
    if (o.dev != dev || o.kernel != kernel) continue;
    lifted = true;
    if (o.smem == smem) {
      *out = o.value;
      return cudaSuccess;
    }
  }
  cudaError_t err;
  if (!lifted && smem_optin > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin);
    if (err != cudaSuccess) return err;
  }
  int value = 0;
  if (cluster) {
    cudaLaunchConfig_t cfg = {};  // the cluster's size is the kernel's own (__cluster_dims__)
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kWideThreads);
    cfg.dynamicSmemBytes = smem;
    err = cudaOccupancyMaxActiveClusters(&value, kernel, &cfg);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&value, kernel, kWideThreads, smem);
  }
  if (err != cudaSuccess) return err;
  if (value < 1) return cluster ? cudaErrorInvalidClusterSize : cudaErrorInvalidConfiguration;
  // a full cache is not an error: later launches of this (kernel, smem) query again
  if (occupancies < kMaxOccupancies) occupancy_cache[occupancies++] = {dev, kernel, smem, value};
  *out = value;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// 1 when a (num_rows, num_cols) table takes the shared-memory branch on the
// current device, 0 when it takes the global-atomic branch, a negative CUDA
// error code when the device cannot be queried.
int pair_count_uses_shared(int num_rows, int num_cols) {
  int dev = 0, sms = 0, smem_optin = 0;
  const cudaError_t err = device_limits(&dev, &sms, &smem_optin);
  if (err != cudaSuccess) return -(int)err;
  const long long bytes = (long long)num_rows * num_cols * (long long)sizeof(int32_t);
  return bytes <= smem_optin ? 1 : 0;
}

// row, col: n labels on the device, int64 where *_wide != 0, else int32; mask:
// n uint8 or NULL; out: num_rows * num_cols int32, zeroed by the caller;
// has_ignore != 0 drops pairs whose row label equals ignore_index; stream: a
// cudaStream_t. The caller guarantees 1 <= n < 2^31 and
// num_rows * num_cols < 2^31.
int pair_count_launch(const void* row, int row_wide, const void* col, int col_wide, const void* mask, long long n,
                      int num_rows, int num_cols, int ignore_index, int has_ignore, void* out, void* stream) {
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = device_limits(&dev, &sms, &smem_optin);
  if (err != cudaSuccess) return (int)err;
  const Rule rule = {num_rows, num_cols, ignore_index, has_ignore, static_cast<const uint8_t*>(mask)};
  const bool vec = aligned16(row) && aligned16(col);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)num_rows * num_cols;
  const size_t smem = (size_t)cells * sizeof(int32_t);

  if (smem <= (size_t)smem_optin) {
    // one block an SM (two blocks an SM, which 30 registers a thread allow, share its
    // atomics and ran 1.2x slower), as many clusters as the card holds at once and the
    // pairs need: at least `cells` pairs and one group of 4 a thread per cluster
    AnyKernel kernel = BY_WIDTH(pair_count_cluster_kernel);
    int clusters = 0;
    err = resident(dev, smem_optin, kernel, true, smem, &clusters);
    if (err != cudaSuccess) return (int)err;
    const long long grid = std::min({(long long)clusters, (long long)(sms / kCluster), ceil_div(n, cells),
                                     ceil_div(ceil_div(n, 4), (long long)kWideThreads * kCluster)});
    kernel<<<(unsigned)(grid * kCluster), kWideThreads, smem, s>>>(row, col, n, rule, vec, o);
  } else {
    long long grid = ceil_div(ceil_div(n, 4), kThreads);
    if (grid > (long long)sms * kGlobalBlocksPerSm) grid = (long long)sms * kGlobalBlocksPerSm;
    BY_WIDTH(pair_count_global_kernel)<<<(unsigned)grid, kThreads, 0, s>>>(row, col, n, rule, vec, o);
  }
  return (int)cudaGetLastError();
}

// 1 when num_classes' counters fit in shared memory (the stat-score kernel's
// shared branch), 0 when they are the output's, a negative CUDA error code when
// the device cannot be queried.
int stat_scores_uses_shared(int num_classes) {
  int dev = 0, sms = 0, smem_optin = 0;
  const cudaError_t err = device_limits(&dev, &sms, &smem_optin);
  if (err != cudaSuccess) return -(int)err;
  return stat_scores_smem(num_classes, true) <= (size_t)smem_optin ? 1 : 0;
}

// target, preds: n labels on the device, int64 where *_wide != 0, else int32;
// out: 4 * num_classes + 2 int32, zeroed by the caller, receives tp | fp | tn |
// fn, then the valid count and the ticket; has_ignore != 0 drops pairs whose
// target equals ignore_index. The caller guarantees 1 <= n < 2^31 and
// 4 * num_classes + 2 < 2^31.
int stat_scores_launch(const void* target, int row_wide, const void* preds, int col_wide, long long n,
                       int num_classes, int ignore_index, int has_ignore, void* out, void* stream) {
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = device_limits(&dev, &sms, &smem_optin);
  if (err != cudaSuccess) return (int)err;
  const Rule rule = {num_classes, num_classes, ignore_index, has_ignore, nullptr};
  const bool vec = aligned16(target) && aligned16(preds);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = stat_scores_smem(num_classes, true);
  const bool shared = smem <= (size_t)smem_optin;
  AnyKernel kernel = shared ? BY_WIDTH(stat_scores_kernel, true) : BY_WIDTH(stat_scores_kernel, false);
  const size_t dyn = shared ? smem : stat_scores_smem(num_classes, false);
  int per_sm = 0;
  err = resident(dev, smem_optin, kernel, false, dyn, &per_sm);
  if (err != cudaSuccess) return (int)err;
  long long grid = ceil_div(n, (long long)kWideThreads * kStatPairsPerThread);
  if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  kernel<<<(unsigned)grid, kWideThreads, dyn, s>>>(target, preds, n, rule, vec, o);
  return (int)cudaGetLastError();
}

const char* pair_count_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
