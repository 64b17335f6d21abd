// Pair count on Hopper: counts[r, c] = number of i with row[i] == r, col[i] == c
// and mask[i] != 0, into a zeroed (num_rows, num_cols) int32 table. Pairs with a
// negative or out-of-range index on either side are dropped.
//
// Replaces: metrics_tpu/kernels/confmat.py::_pair_count_kernel (the Pallas TPU
// kernel behind pair_count_fused). That kernel walks a sequential grid and
// carries one resident f32 (R, C) accumulator across grid steps, building the
// one-hot tiles on chip for the MXU. Hopper blocks run in parallel and in no
// order, so nothing is carried between blocks here: every block counts its own
// grid-stride share of the pairs with int32 atomics. Integer addition does not
// depend on order, so the result is bit-identical to the bincount reference
// however the blocks interleave, and int32 counts stay exact for every
// N < 2^31 (the TPU kernel's f32 accumulator bounded it to N < 2^24).
//
// What bounds it: memory. The work is N compares and N increments against
// 9 bytes read per pair (two int32 indices and a uint8 mask) plus the
// R*C*4-byte output, which the caller zeroes and the kernel writes once. There
// is no arithmetic to speak of, so the least time is those bytes over the
// card's memory rate. What the design does about it:
//   - small tables (R*C*4 bytes fit in a block's shared memory, up to the
//     opt-in maximum): each block keeps a private int32 histogram in shared
//     memory, so the per-pair atomics never leave the SM; at the end the block
//     adds only its non-zero bins into the output with global atomics. The
//     grid is sized so each block streams at least about R*C pairs, which keeps
//     the zeroing and merging of the private table small against the stream.
//   - large tables (the training step's 1000 x 1000 = 4 MB): atomics go
//     straight to the output. At N = 1024 pairs that is 1024 increments into a
//     table that sits in the 50 MB L2, and the kernel's time is its launch.
// Left for later: vectorised 16-byte index loads and warp-aggregated atomics
// for skewed (diagonal-heavy) tables.
//
// Interface: a plain C function, loaded with ctypes (no PyTorch headers). It
// launches on the given stream, does not synchronise, allocates nothing, and
// returns the CUDA error code of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Caps on resident blocks per SM for the grid-stride loops: enough warps to
// cover memory latency, few enough that the small-table merge stays cheap.
constexpr int kGlobalBlocksPerSm = 8;

typedef void (*PairCountKernel)(const int32_t*, const int32_t*, const uint8_t*, long long, int, int,
                                int32_t*);

template <bool kHasMask>
__global__ void __launch_bounds__(kThreads)
pair_count_shared_kernel(const int32_t* __restrict__ row, const int32_t* __restrict__ col,
                         const uint8_t* __restrict__ mask, long long n, int num_rows, int num_cols,
                         int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  const int cells = num_rows * num_cols;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int r = row[i];
    const int c = col[i];
    bool ok = (unsigned)r < (unsigned)num_rows && (unsigned)c < (unsigned)num_cols;
    if (kHasMask) ok = ok && mask[i] != 0;
    if (ok) atomicAdd(&hist[r * num_cols + c], 1);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int32_t v = hist[i];
    if (v != 0) atomicAdd(&out[i], v);
  }
}

template <bool kHasMask>
__global__ void __launch_bounds__(kThreads)
pair_count_global_kernel(const int32_t* __restrict__ row, const int32_t* __restrict__ col,
                         const uint8_t* __restrict__ mask, long long n, int num_rows, int num_cols,
                         int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int r = row[i];
    const int c = col[i];
    bool ok = (unsigned)r < (unsigned)num_rows && (unsigned)c < (unsigned)num_cols;
    if (kHasMask) ok = ok && mask[i] != 0;
    if (ok) atomicAdd(&out[(long long)r * num_cols + c], 1);
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// 1 when a (num_rows, num_cols) table takes the shared-memory branch on the
// current device, 0 when it takes the global-atomic branch, a negative CUDA
// error code when the device cannot be queried.
int pair_count_uses_shared(int num_rows, int num_cols) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  const long long bytes = (long long)num_rows * num_cols * (long long)sizeof(int32_t);
  return bytes <= smem_optin ? 1 : 0;
}

// row, col: n int32 on the device; mask: n uint8 or NULL; out: num_rows *
// num_cols int32, zeroed by the caller; stream: a cudaStream_t. The caller
// guarantees 1 <= n < 2^31 and num_rows * num_cols < 2^31.
int pair_count_launch(const void* row, const void* col, const void* mask, long long n, int num_rows,
                      int num_cols, void* out, void* stream) {
  const int shared = pair_count_uses_shared(num_rows, num_cols);
  if (shared < 0) return -shared;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  const int32_t* r = static_cast<const int32_t*>(row);
  const int32_t* c = static_cast<const int32_t*>(col);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)num_rows * num_cols;

  if (shared) {
    PairCountKernel kernel = m ? pair_count_shared_kernel<true> : pair_count_shared_kernel<false>;
    const size_t smem = (size_t)cells * sizeof(int32_t);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
    // each block streams at least max(cells, 4 * kThreads) pairs
    const long long per_block = cells > 4 * kThreads ? cells : 4 * kThreads;
    long long grid = ceil_div(n, per_block);
    if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
    kernel<<<(unsigned)grid, kThreads, smem, s>>>(r, c, m, n, num_rows, num_cols, o);
  } else {
    PairCountKernel kernel = m ? pair_count_global_kernel<true> : pair_count_global_kernel<false>;
    long long grid = ceil_div(n, kThreads);
    if (grid > (long long)sms * kGlobalBlocksPerSm) grid = (long long)sms * kGlobalBlocksPerSm;
    kernel<<<(unsigned)grid, kThreads, 0, s>>>(r, c, m, n, num_rows, num_cols, o);
  }
  return (int)cudaGetLastError();
}

const char* pair_count_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
