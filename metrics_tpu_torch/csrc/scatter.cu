// Scatter kernels of the sketch plane on Hopper, in int32 end to end:
//   hist_add:     out[i] = bins[i] + sum of val[k] over the k with idx[k] == i
//   hist_max:     out[i] = max(bins[i], max of val[k] over the k with idx[k] == i)
//   cms_rows_add: out[j, c] = counts[j, c] + number of n with valid[n] and cols[n, j] == c
// Samples whose index lies outside [0, B) (or whose column lies outside
// [0, width)) contribute nothing. The caller hands in `out` as a copy of
// `bins` / `counts`; the kernels fold the batch into it.
//
// Replaces: metrics_tpu/kernels/scatter.py::_scatter_kernel (the Pallas TPU
// kernel behind hist_add_pallas, hist_max_pallas and cms_rows_add_pallas).
// That kernel compares each (8, 512) sample tile against an iota of a bin
// block, reduces the one-hot mask on the vector unit into a resident per-bin
// accumulator, and walks bin blocks and sample tiles on a sequential grid; the
// count-min table took one such pass per depth row. Hopper blocks run in
// parallel and in no order, and a one-hot compare costs B operations per
// sample, so neither carries over: here every block folds its grid-stride
// share of the samples with int32 atomics, and the count-min table is one
// launch over all depth rows. Integer addition (modulo 2^32) and integer max
// do not depend on order, so the result is bit-identical to the plain
// index_add / scatter_reduce version however the blocks interleave.
//
// What bounds it: memory. Per sample the work is one range test and one
// atomic against 8 bytes read (an int32 index and an int32 value; for the
// count-min table depth int32 columns and one uint8 flag), plus the table
// read and written once. What the design does about it:
//   - small tables (B * 4 bytes fit in a block's shared memory, up to the
//     opt-in maximum of 227 KB): each block keeps a private table in shared
//     memory, starting at the op's identity (0 for add, INT32_MIN for max),
//     so the per-sample atomics never leave the SM; at the end the block
//     folds only the bins it changed into the output with one global atomic
//     each. Above 48 KB (HyperLogLog p = 14, 64 KB) this needs dynamic shared
//     memory opted in with cudaFuncSetAttribute.
//   - large tables (HyperLogLog p = 16, 256 KB; a 4 x 65536 count-min table):
//     atomics go straight to the output, which sits in the 50 MB L2.
//   - add skips zero weights (the DDSketch stores get weight 0 for every
//     value of the other sign), and max skips a value that is not above what
//     the slot already holds: slots only grow, so a stale read can only make
//     the test pass, never skip a value that would have changed the slot.
// Left for later: warp-aggregated atomics for skewed (Zipf) keys, 16-byte
// loads, and more loads in flight per thread for the low-occupancy p = 14
// shared table.
//
// Interface: plain C functions, loaded with ctypes (no PyTorch headers). Each
// launches on the given stream, does not synchronise, allocates nothing, and
// returns the CUDA error code of the launch (0 on success).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Cap on resident blocks per SM for the global-atomic grid-stride loops.
constexpr int kGlobalBlocksPerSm = 8;

enum Op { kAdd = 0, kMax = 1 };

template <int kOp>
__device__ __forceinline__ int32_t identity() {
  return kOp == kAdd ? 0 : INT_MIN;
}

// Folds v into *slot (shared or global memory), skipping values that cannot
// change it.
template <int kOp>
__device__ __forceinline__ void fold(int32_t* slot, int32_t v) {
  if (kOp == kAdd) {
    if (v != 0) atomicAdd(slot, v);
  } else {
    if (v > *slot) atomicMax(slot, v);
  }
}

template <int kOp>
__device__ __forceinline__ void hist_shared(const int32_t* __restrict__ idx, const int32_t* __restrict__ val,
                                            long long n, int n_bins, int32_t* __restrict__ out) {
  extern __shared__ int32_t table[];
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) table[i] = identity<kOp>();
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
    const int b = idx[k];
    if ((unsigned)b < (unsigned)n_bins) fold<kOp>(&table[b], val[k]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int32_t v = table[i];
    if (v != identity<kOp>()) fold<kOp>(&out[i], v);
  }
}

template <int kOp>
__device__ __forceinline__ void hist_global(const int32_t* __restrict__ idx, const int32_t* __restrict__ val,
                                            long long n, int n_bins, int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
    const int b = idx[k];
    if ((unsigned)b < (unsigned)n_bins) fold<kOp>(&out[b], val[k]);
  }
}

// One __global__ per op and branch, so that a profile names each one.
__global__ void __launch_bounds__(kThreads)
hist_add_shared_kernel(const int32_t* idx, const int32_t* val, long long n, int n_bins, int32_t* out) {
  hist_shared<kAdd>(idx, val, n, n_bins, out);
}

__global__ void __launch_bounds__(kThreads)
hist_add_global_kernel(const int32_t* idx, const int32_t* val, long long n, int n_bins, int32_t* out) {
  hist_global<kAdd>(idx, val, n, n_bins, out);
}

__global__ void __launch_bounds__(kThreads)
hist_max_shared_kernel(const int32_t* idx, const int32_t* val, long long n, int n_bins, int32_t* out) {
  hist_shared<kMax>(idx, val, n, n_bins, out);
}

__global__ void __launch_bounds__(kThreads)
hist_max_global_kernel(const int32_t* idx, const int32_t* val, long long n, int n_bins, int32_t* out) {
  hist_global<kMax>(idx, val, n, n_bins, out);
}

// cols: (n, depth) row-major; valid: n flags. Each thread takes whole samples.
__global__ void __launch_bounds__(kThreads)
cms_rows_add_shared_kernel(const int32_t* __restrict__ cols, const uint8_t* __restrict__ valid, long long n,
                           int depth, int width, int32_t* __restrict__ out) {
  extern __shared__ int32_t table[];
  const int cells = depth * width;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) table[i] = 0;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
    if (!valid[k]) continue;
    const int32_t* c = cols + k * depth;
    for (int j = 0; j < depth; ++j) {
      const int col = c[j];
      if ((unsigned)col < (unsigned)width) atomicAdd(&table[j * width + col], 1);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int32_t v = table[i];
    if (v != 0) atomicAdd(&out[i], v);
  }
}

__global__ void __launch_bounds__(kThreads)
cms_rows_add_global_kernel(const int32_t* __restrict__ cols, const uint8_t* __restrict__ valid, long long n,
                           int depth, int width, int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
    if (!valid[k]) continue;
    const int32_t* c = cols + k * depth;
    for (int j = 0; j < depth; ++j) {
      const int col = c[j];
      if ((unsigned)col < (unsigned)width) atomicAdd(&out[(long long)j * width + col], 1);
    }
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// 1 when a table of `cells` int32 fits in a block's shared memory on the
// current device, 0 when it does not, a negative CUDA error code when the
// device cannot be queried.
int uses_shared(long long cells) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  return cells * (long long)sizeof(int32_t) <= smem_optin ? 1 : 0;
}

// The grid for `samples` samples: for the shared branch at most the blocks
// that fit on the card at once, each streaming at least max(cells, 4 *
// kThreads) samples, which keeps the zeroing and merging of the private table
// small against the stream; for the global branch up to kGlobalBlocksPerSm
// blocks per SM. Sets *smem to the dynamic shared memory to launch with.
cudaError_t plan(const void* kernel, bool shared, long long samples, long long cells, unsigned* grid,
                 size_t* smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long blocks = 0;
  if (shared) {
    *smem = (size_t)cells * sizeof(int32_t);
    if (*smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, *smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
    const long long per_block = cells > 4 * kThreads ? cells : 4 * kThreads;
    blocks = ceil_div(samples, per_block);
    if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  } else {
    *smem = 0;
    blocks = ceil_div(samples, kThreads);
    if (blocks > (long long)sms * kGlobalBlocksPerSm) blocks = (long long)sms * kGlobalBlocksPerSm;
  }
  *grid = (unsigned)(blocks < 1 ? 1 : blocks);
  return cudaSuccess;
}

typedef void (*HistKernel)(const int32_t*, const int32_t*, long long, int, int32_t*);

int hist_launch(HistKernel shared_kernel, HistKernel global_kernel, const void* idx, const void* val,
                long long n, int n_bins, void* out, void* stream) {
  const int shared = uses_shared(n_bins);
  if (shared < 0) return -shared;
  HistKernel kernel = shared ? shared_kernel : global_kernel;
  unsigned grid = 0;
  size_t smem = 0;
  cudaError_t err = plan((const void*)kernel, shared, n, n_bins, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(val), n, n_bins, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int scatter_uses_shared(long long cells) { return uses_shared(cells); }

// idx, val: n int32 on the device; out: n_bins int32, a copy of bins; stream:
// a cudaStream_t. The caller guarantees 1 <= n < 2^31 and 1 <= n_bins < 2^31.
int hist_add_launch(const void* idx, const void* val, long long n, int n_bins, void* out, void* stream) {
  return hist_launch(hist_add_shared_kernel, hist_add_global_kernel, idx, val, n, n_bins, out, stream);
}

int hist_max_launch(const void* idx, const void* val, long long n, int n_bins, void* out, void* stream) {
  return hist_launch(hist_max_shared_kernel, hist_max_global_kernel, idx, val, n, n_bins, out, stream);
}

// cols: n * depth int32 (row-major (n, depth)); valid: n uint8; out: depth *
// width int32, a copy of counts. The caller guarantees 1 <= n < 2^31,
// depth >= 1, width >= 1 and depth * width < 2^31.
int cms_rows_add_launch(const void* cols, const void* valid, long long n, int depth, int width, void* out,
                        void* stream) {
  const long long cells = (long long)depth * width;
  const int shared = uses_shared(cells);
  if (shared < 0) return -shared;
  const void* kernel = shared ? (const void*)cms_rows_add_shared_kernel : (const void*)cms_rows_add_global_kernel;
  unsigned grid = 0;
  size_t smem = 0;
  cudaError_t err = plan(kernel, shared, n, cells, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  const int32_t* c = static_cast<const int32_t*>(cols);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    cms_rows_add_shared_kernel<<<grid, kThreads, smem, s>>>(c, v, n, depth, width, o);
  } else {
    cms_rows_add_global_kernel<<<grid, kThreads, smem, s>>>(c, v, n, depth, width, o);
  }
  return (int)cudaGetLastError();
}

const char* scatter_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
