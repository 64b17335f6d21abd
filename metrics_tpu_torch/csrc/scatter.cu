// Scatter kernels of the sketch plane on Hopper, in int32 end to end:
//   hist_add:     out[i] = bins[i] + sum of val[k] over the k with idx[k] == i
//   hist_max:     out[i] = max(bins[i], max of val[k] over the k with idx[k] == i)
//   cms_rows_add: out[j, c] = counts[j, c] + number of n with valid[n] and cols[n, j] == c
// Samples whose index lies outside [0, B) (or whose column lies outside
// [0, width)) contribute nothing. The caller hands in `out` as a copy of
// `bins` / `counts`; the kernels fold the batch into it. cms_rows_add takes
// its columns from two sources: a (n, depth) int32 array and n uint8 flags
// (the columns route), or n int32 ids whose columns it hashes in registers,
// cols[n, j] = column(ids[n], j) of cm_hash.cuh, valid[n] = ids[n] >= 0 (the
// ids route).
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
// read and written once. But a scattered atomic or read of device memory
// costs the L2 far more than its 4 bytes: the first global branch for tables
// beyond shared memory (HyperLogLog p = 16) ran at 4.6x the byte bound. What
// the design does about it, by branch of hist_add / hist_max:
//   - shared (B * 4 bytes fit a block's shared memory, up to the opt-in 227
//     KB): each block keeps a private table in shared memory, starting at the
//     op's identity (0 for add, INT32_MIN for max), so the per-sample atomics
//     never leave the SM; at the end the block folds the slots it changed into
//     the output with one atomic each, lanes on consecutive slots. Above 48 KB
//     (HyperLogLog p = 14, 64 KB) this needs dynamic shared memory opted in
//     with cudaFuncSetAttribute.
//   - packed (hist_max, B up to twice the int32 slots of a block, N >= B:
//     HyperLogLog p = 16): the same with int16 slots, two to a 32-bit word,
//     raised by a compare-and-swap loop that stops as soon as the slot is not
//     below the value; values outside [-32767, 32767] go straight to the
//     output. One block of 1024 threads per SM.
//   - global (any other table, or N < B): atomics go straight to the output,
//     which sits in the 50 MB L2, one sample per thread per pass; lanes of a
//     warp with the same slot first fold their values together
//     (__match_any_sync, the lowest lane goes on), which cuts the atomics on
//     the hot slots of Zipf-skewed keys; max skips a value that is not above
//     what the slot holds: slots only grow, so a stale read can only make the
//     test pass, never skip a value that would have changed the slot.
// Every branch with a table in shared memory loads its samples 16 bytes at a
// time (idx and val at one offset from a 16-byte boundary; a scalar head up
// to the boundary for a view with a storage offset and a scalar tail for
// N % 4), two such loads in flight per thread, or 4 single loads a grid stride
// apart when idx and val sit at different offsets. A block's private table
// costs its zeroing and its fold at the end, one atomic per slot it changed:
// at p = 16 and 2^22 samples that fold is a large share of the time, which is
// why the packed branch takes one block per SM. Taking more
// samples per thread in the global branch (16-byte loads, every slot read
// before any atomic) made it slower, not faster: more reads of a slot before
// its atomic lands mean more stale reads and more atomics on hot slots.
//
// cms_rows_add. The columns route moves 17 bytes a sample at depth 4 (four
// int32 columns and a flag) and its bound is bytes. The ids route reads 4
// bytes an id and writes no (n, depth) column array for it to read back, and
// the least time for its work is the larger of
//   bytes: 4 * n + 8 * depth * width (the ids read once, the table read and
//          written once) over 3.35 TB/s, and
//   operations: 11 * depth * n (per id and row: the xor with the row seed,
//          three shift-xor steps of 2, two multiplies, the modulo as a mask at
//          a power-of-two width, the add) over 132 SMs x 128 lanes x the SM
//          clock;
// at 2^22 ids into 4 x 2048 that is 5.03 us of bytes against 5.52 us of
// operations at 1980 MHz: the operations bind. Both routes load 16 bytes at a
// time, add with one plain atomic per (sample, row) (see add_one for why not
// warp-aggregated), and in the shared branch take at most one block of 1024
// threads per SM (see cms_plan).
//
// Interface: plain C functions, loaded with ctypes (no PyTorch headers). Each
// launches on the given stream, does not synchronise, allocates nothing, and
// returns the CUDA error code of the launch (0 on success).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cm_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBigThreads = 1024;  // hist_max's packed and cms_rows_add's shared branch: one block fills an SM
// Cap on resident blocks per SM for the global-atomic grid-stride loops.
constexpr int kGlobalBlocksPerSm = 8;
constexpr uint32_t kPackedEmpty = 0x80008000u;  // two int16 slots at -32768: not changed

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

// Calls fn(idx[k], val[k]) for this thread's grid-stride share of the
// samples, with a sample index of -1 for the padding of a short pass. When idx
// and val sit at one offset from a 16-byte boundary the samples come 4 to a
// load, two loads of each in flight; the up to 3 samples before the boundary
// and the N % 4 after the last vector are taken one by one by the first
// threads. Otherwise each thread loads 4 single samples a grid stride apart.
template <typename Fn>
__device__ __forceinline__ void for_each_sample(const int32_t* __restrict__ idx, const int32_t* __restrict__ val,
                                                long long n, Fn&& fn) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uintptr_t at = reinterpret_cast<uintptr_t>(idx);
  if (((at ^ reinterpret_cast<uintptr_t>(val)) & 15) == 0) {
    const long long head = min(n, (long long)(((16 - (at & 15)) & 15) / sizeof(int32_t)));
    const long long n_vec = (n - head) / 4;
    const int4* idx4 = reinterpret_cast<const int4*>(idx + head);
    const int4* val4 = reinterpret_cast<const int4*>(val + head);
    for (long long k = tid; k < n_vec; k += 2 * stride) {
      const bool two = k + stride < n_vec;
      const int4 b0 = __ldg(idx4 + k);
      const int4 v0 = __ldg(val4 + k);
      const int4 b1 = two ? __ldg(idx4 + k + stride) : make_int4(-1, -1, -1, -1);
      const int4 v1 = two ? __ldg(val4 + k + stride) : make_int4(0, 0, 0, 0);
      fn(b0.x, v0.x);
      fn(b0.y, v0.y);
      fn(b0.z, v0.z);
      fn(b0.w, v0.w);
      fn(b1.x, v1.x);
      fn(b1.y, v1.y);
      fn(b1.z, v1.z);
      fn(b1.w, v1.w);
    }
    const long long tail = head + n_vec * 4;  // samples [0, head) and [tail, n) one by one
    if (tid < head + (n - tail)) {
      const long long k = tid < head ? tid : tail + (tid - head);
      fn(idx[k], val[k]);
    }
  } else {
    for (long long k = tid; k < n; k += 4 * stride) {
      int b[4];
      int32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long j = k + u * stride;
        b[u] = j < n ? __ldg(idx + j) : -1;
        v[u] = j < n ? __ldg(val + j) : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) fn(b[u], v[u]);
    }
  }
}

template <int kOp>
__device__ __forceinline__ void hist_shared(const int32_t* __restrict__ idx, const int32_t* __restrict__ val,
                                            long long n, int n_bins, int32_t* __restrict__ out) {
  extern __shared__ int32_t table[];
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) table[i] = identity<kOp>();
  __syncthreads();

  for_each_sample(idx, val, n, [&](int b, int32_t v) {
    if ((unsigned)b < (unsigned)n_bins) fold<kOp>(&table[b], v);
  });
  __syncthreads();

  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int32_t v = table[i];
    if (v != identity<kOp>()) fold<kOp>(&out[i], v);
  }
}

template <int kOp>
__device__ __forceinline__ void hist_global(const int32_t* __restrict__ idx, const int32_t* __restrict__ val,
                                            long long n, int n_bins, int32_t* __restrict__ out) {
  __shared__ int32_t stage[kThreads];
  const int lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
    const int b = idx[k];
    const int32_t v = val[k];
    const bool in = (unsigned)b < (unsigned)n_bins;
    // lanes with the same slot: the lowest folds their values together and goes on
    const unsigned active = __activemask();
    const unsigned peers = __match_any_sync(active, in ? b : -1 - lane);
    stage[threadIdx.x] = v;
    __syncwarp(active);
    if (in && lane == __ffs(peers) - 1) {
      int32_t w = v;
      for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1) {
        const int32_t x = stage[threadIdx.x - lane + __ffs(rest) - 1];
        w = kOp == kAdd ? w + x : max(w, x);
      }
      fold<kOp>(&out[b], w);
    }
    __syncwarp(active);
  }
}

// hist_max into int16 slots, two to a 32-bit word of shared memory; -32768
// marks a slot the block did not change. The compare-and-swap loop stops as
// soon as the slot is not below v.
__device__ __forceinline__ void max_packed(uint32_t* words, int b, int32_t v) {
  uint32_t* word = words + (b >> 1);
  const int shift = (b & 1) * 16;
  uint32_t old = *word;
  while ((int32_t)(int16_t)(old >> shift) < v) {
    const uint32_t want = (old & ~(0xffffu << shift)) | ((uint32_t)(v & 0xffff) << shift);
    const uint32_t seen = atomicCAS(word, old, want);
    if (seen == old) return;
    old = seen;
  }
}

__global__ void __launch_bounds__(kBigThreads)
hist_max_packed_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ val, long long n, int n_bins,
                       int32_t* __restrict__ out) {
  extern __shared__ uint32_t words[];  // (n_bins + 1) / 2
  for (int i = threadIdx.x; i < (n_bins + 1) / 2; i += blockDim.x) words[i] = kPackedEmpty;
  __syncthreads();

  for_each_sample(idx, val, n, [&](int b, int32_t v) {
    if ((unsigned)b >= (unsigned)n_bins) return;
    if (v > -32768 && v <= 32767) {
      max_packed(words, b, v);
    } else {
      fold<kMax>(&out[b], v);
    }
  });
  __syncthreads();

  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int32_t v = (int16_t)(words[i >> 1] >> ((i & 1) * 16));
    if (v != -32768) atomicMax(&out[i], v);
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

// ---------------------------------------------------------------- count-min table
//
// Both column sources fold into one table (a block's private copy in shared
// memory when it fits, else the output in global memory) through add_one.

// table[cell] += 1: one atomic per (sample, row). Folding a warp's lanes on
// the same cell first (__match_any_sync, the lowest lane adding the group's
// popcount) was measured 4.6x slower on the shared branch at 2^22 Zipf(1.1)
// ids into 4 x 2048 (H100: 124.5 against 27.0 us from ids, 130.6 against
// 35.4 us from columns): the hottest id takes ~10% of the stream, about 3
// lanes of a warp, and the match costs more than the atomics it saves.
__device__ __forceinline__ void add_one(int32_t* table, int cell) { atomicAdd(table + cell, 1); }

// Calls fn(x[e]) for this thread's grid-stride share of x[0, n), and fn(-1)
// for the padding of a short pass. After a head of up to 3 elements to the
// 16-byte boundary the elements come 4 to a load, two loads in flight; the
// head and the n % 4 after the last vector are taken one by one by the first
// threads.
template <typename Fn>
__device__ __forceinline__ void for_each_id(const int32_t* __restrict__ x, long long n, Fn&& fn) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uintptr_t at = reinterpret_cast<uintptr_t>(x);
  const long long head = min(n, (long long)(((16 - (at & 15)) & 15) / sizeof(int32_t)));
  const long long n_vec = (n - head) / 4;
  const int4* x4 = reinterpret_cast<const int4*>(x + head);
  for (long long k = tid; k < n_vec; k += 2 * stride) {
    const int4 a = __ldg(x4 + k);
    const int4 b = k + stride < n_vec ? __ldg(x4 + k + stride) : make_int4(-1, -1, -1, -1);
    fn(a.x);
    fn(a.y);
    fn(a.z);
    fn(a.w);
    fn(b.x);
    fn(b.y);
    fn(b.z);
    fn(b.w);
  }
  const long long tail = head + n_vec * 4;  // elements [0, head) and [tail, n) one by one
  if (tid < head + (n - tail)) fn(x[tid < head ? tid : tail + (tid - head)]);
}

// The ids route: counts[j, column(id, j)] += 1 for every id >= 0, the columns
// hashed in registers (cm_hash.cuh). Shared memory holds the row seeds and,
// in the shared branch, the block's table after them.
template <bool kPow2, bool kShared>
__device__ __forceinline__ void cms_ids(const int32_t* __restrict__ ids, long long n, int depth, int width,
                                        int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  uint32_t* seeds = reinterpret_cast<uint32_t*>(smem);
  int32_t* table = kShared ? smem + depth : out;
  const int cells = depth * width;
  for (int j = threadIdx.x; j < depth; j += blockDim.x) seeds[j] = cm_hash::row_seed(j);
  if (kShared) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) table[i] = 0;
  }
  __syncthreads();

  for_each_id(ids, n, [&](int32_t id) {
    if (id < 0) return;
    for (int j = 0; j < depth; ++j) add_one(table, j * width + cm_hash::column<kPow2>(id, seeds[j], (uint32_t)width));
  });

  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int32_t v = table[i];
      if (v != 0) atomicAdd(&out[i], v);
    }
  }
}

// One __global__ per branch, so that a profile names each one.
__global__ void __launch_bounds__(kBigThreads)
cms_rows_add_ids_shared_kernel(const int32_t* ids, long long n, int depth, int width, int32_t* out) {
  cms_ids<false, true>(ids, n, depth, width, out);
}

__global__ void __launch_bounds__(kBigThreads)
cms_rows_add_ids_shared_pow2_kernel(const int32_t* ids, long long n, int depth, int width, int32_t* out) {
  cms_ids<true, true>(ids, n, depth, width, out);
}

__global__ void __launch_bounds__(kThreads)
cms_rows_add_ids_global_kernel(const int32_t* ids, long long n, int depth, int width, int32_t* out) {
  cms_ids<false, false>(ids, n, depth, width, out);
}

__global__ void __launch_bounds__(kThreads)
cms_rows_add_ids_global_pow2_kernel(const int32_t* ids, long long n, int depth, int width, int32_t* out) {
  cms_ids<true, false>(ids, n, depth, width, out);
}

// The columns route: counts[j, cols[s, j]] += 1 for every s with valid[s]
// and 0 <= cols[s, j] < width. cols is (n, depth) row-major. When it sits on
// a 16-byte boundary a lane takes 4 samples at a time: their 4 * depth
// columns are depth 16-byte loads (up to 4 in flight). The n % 4 samples
// after the last group, or every sample of an unaligned array, go one by one.
template <bool kShared>
__device__ __forceinline__ void cms_cols(const int32_t* __restrict__ cols, const uint8_t* __restrict__ valid,
                                         long long n, int depth, int width, int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int32_t* table = kShared ? smem : out;
  const int cells = depth * width;
  if (kShared) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) table[i] = 0;
    __syncthreads();
  }
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const auto add = [&](int col, int row) {
    if ((unsigned)col < (unsigned)width) add_one(table, row * width + col);
  };

  const bool aligned = (reinterpret_cast<uintptr_t>(cols) & 15) == 0;
  const long long groups = aligned ? n / 4 : 0;
  const int4* cols4 = reinterpret_cast<const int4*>(cols);
  for (long long g = tid; g < groups; g += stride) {
    unsigned flags = 0;  // bit q: sample 4g + q is valid
#pragma unroll
    for (int q = 0; q < 4; ++q) flags |= (__ldg(valid + 4 * g + q) != 0) << q;
    int q = 0, row = 0;  // the sample in the group and the row of the next element
    for (int u0 = 0; u0 < depth; u0 += 4) {
      int4 c[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) c[v] = u0 + v < depth ? __ldg(cols4 + g * depth + u0 + v) : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (u0 + v < depth) {
          const int e[4] = {c[v].x, c[v].y, c[v].z, c[v].w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            if ((flags >> q) & 1) add(e[w], row);
            if (++row == depth) {
              row = 0;
              ++q;
            }
          }
        }
      }
    }
  }
  for (long long s = groups * 4 + tid; s < n; s += stride) {
    if (__ldg(valid + s) == 0) continue;
    for (int j = 0; j < depth; ++j) add(__ldg(cols + s * depth + j), j);
  }

  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int32_t v = table[i];
      if (v != 0) atomicAdd(&out[i], v);
    }
  }
}

__global__ void __launch_bounds__(kBigThreads)
cms_rows_add_shared_kernel(const int32_t* cols, const uint8_t* valid, long long n, int depth, int width,
                           int32_t* out) {
  cms_cols<true>(cols, valid, n, depth, width, out);
}

__global__ void __launch_bounds__(kThreads)
cms_rows_add_global_kernel(const int32_t* cols, const uint8_t* valid, long long n, int depth, int width,
                           int32_t* out) {
  cms_cols<false>(cols, valid, n, depth, width, out);
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
// blocks per SM. `smem` is the dynamic shared memory a block launches with.
cudaError_t plan(const void* kernel, bool shared, long long samples, long long cells, size_t smem, unsigned* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  long long blocks = 0;
  if (shared) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
    const long long per_block = cells > 4 * kThreads ? cells : 4 * kThreads;
    blocks = ceil_div(samples, per_block);
    if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  } else {
    blocks = ceil_div(samples, kThreads);
    if (blocks > (long long)sms * kGlobalBlocksPerSm) blocks = (long long)sms * kGlobalBlocksPerSm;
  }
  *grid = (unsigned)(blocks < 1 ? 1 : blocks);
  return cudaSuccess;
}

typedef void (*HistKernel)(const int32_t*, const int32_t*, long long, int, int32_t*);

// The int32 slots a block's shared memory holds on the current device, or a
// negative CUDA error code.
long long block_slots() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(long long)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(long long)err;
  return smem_optin / (long long)sizeof(int32_t);
}

// The branch of hist_add (op 0) or hist_max (op 1) for n samples into n_bins
// slots: 0 global, 1 shared, 2 packed; a negative CUDA error code when the
// device cannot be queried. The packed branch keeps a table beyond one
// block's shared memory, so it takes N >= B, which keeps the table's fold at
// the end small against the stream.
int hist_branch(long long n, long long n_bins, int op) {
  const int shared = uses_shared(n_bins);
  if (shared != 0) return shared;
  if (op != kMax || n < n_bins) return 0;
  const long long slots = block_slots();
  if (slots < 0) return (int)slots;
  return n_bins <= 2 * slots ? 2 : 0;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// The grid and block of a count-min kernel: the global branch as plan() sets
// it out; the shared branch at most one block of kBigThreads per SM, each
// streaming at least max(cells, 4 * kBigThreads) samples. A block's table
// costs one global atomic per cell at the end, so fewer, larger blocks fold
// less: at 2^22 ids into 4 x 2048 this took the ids route from 27.2 to 19.0
// us and the columns route from 35.7 to 29.5 (H100, against up to 7 blocks of
// 256 threads a SM).
cudaError_t cms_plan(const void* kernel, bool shared, long long n, long long cells, size_t smem, unsigned* grid,
                     int* threads) {
  *threads = kThreads;
  cudaError_t err = plan(kernel, shared, n, cells, smem, grid);
  if (err != cudaSuccess || !shared) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long blocks = ceil_div(n, cells > 4 * kBigThreads ? cells : 4 * kBigThreads);
  *grid = (unsigned)(blocks < sms ? blocks : sms);
  *threads = kBigThreads;
  return cudaSuccess;
}

int hist_launch(int op, HistKernel shared_kernel, HistKernel global_kernel, const void* idx, const void* val,
                long long n, int n_bins, void* out, void* stream) {
  const int branch = hist_branch(n, n_bins, op);
  if (branch < 0) return -branch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const int32_t* v = static_cast<const int32_t*>(val);
  int32_t* o = static_cast<int32_t*>(out);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  if (branch == 2) {  // one block per SM
    const size_t smem = (size_t)(n_bins + 1) / 2 * sizeof(uint32_t);
    err = cudaFuncSetAttribute(hist_max_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    hist_max_packed_kernel<<<(unsigned)sms, kBigThreads, smem, s>>>(i, v, n, n_bins, o);
    return (int)cudaGetLastError();
  }
  HistKernel kernel = branch == 1 ? shared_kernel : global_kernel;
  const size_t smem = branch == 1 ? (size_t)n_bins * sizeof(int32_t) : 0;
  unsigned grid = 0;
  err = plan((const void*)kernel, branch == 1, n, n_bins, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, s>>>(i, v, n, n_bins, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int scatter_uses_shared(long long cells) { return uses_shared(cells); }

// The branch hist_add (op 0) or hist_max (op 1) takes for n samples into
// n_bins slots: 0 global, 1 shared, 2 packed; a negative CUDA error code.
int scatter_hist_branch(long long n, long long n_bins, int op) { return hist_branch(n, n_bins, op); }

// idx, val: n int32 on the device; out: n_bins int32, a copy of bins; stream:
// a cudaStream_t. The caller guarantees 1 <= n < 2^31 and 1 <= n_bins < 2^31.
int hist_add_launch(const void* idx, const void* val, long long n, int n_bins, void* out, void* stream) {
  return hist_launch(kAdd, hist_add_shared_kernel, hist_add_global_kernel, idx, val, n, n_bins, out, stream);
}

int hist_max_launch(const void* idx, const void* val, long long n, int n_bins, void* out, void* stream) {
  return hist_launch(kMax, hist_max_shared_kernel, hist_max_global_kernel, idx, val, n, n_bins, out, stream);
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
  const size_t smem = shared ? (size_t)cells * sizeof(int32_t) : 0;
  unsigned grid = 0;
  int threads = 0;
  cudaError_t err = cms_plan(kernel, shared, n, cells, smem, &grid, &threads);
  if (err != cudaSuccess) return (int)err;
  const int32_t* c = static_cast<const int32_t*>(cols);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    cms_rows_add_shared_kernel<<<grid, threads, smem, s>>>(c, v, n, depth, width, o);
  } else {
    cms_rows_add_global_kernel<<<grid, threads, smem, s>>>(c, v, n, depth, width, o);
  }
  return (int)cudaGetLastError();
}

// 1 when the ids route keeps the table in a block's shared memory (the table
// and the depth row seeds fit), 0 when it keeps it in global memory, a
// negative CUDA error code when the device cannot be queried.
int scatter_cms_ids_shared(int depth, int width) { return uses_shared((long long)depth * width + depth); }

// ids: n int32 on the device; out: depth * width int32, a copy of counts. The
// caller guarantees 1 <= n < 2^31, 1 <= depth <= 4096, width >= 1 and
// depth * width < 2^31. Ids below 0 count nowhere.
int cms_ids_add_launch(const void* ids, long long n, int depth, int width, void* out, void* stream) {
  const int shared = scatter_cms_ids_shared(depth, width);
  if (shared < 0) return -shared;
  const bool pow2 = (width & (width - 1)) == 0;
  typedef void (*IdsKernel)(const int32_t*, long long, int, int, int32_t*);
  const IdsKernel kernel = shared ? (pow2 ? cms_rows_add_ids_shared_pow2_kernel : cms_rows_add_ids_shared_kernel)
                                  : (pow2 ? cms_rows_add_ids_global_pow2_kernel : cms_rows_add_ids_global_kernel);
  const long long cells = (long long)depth * width;
  const size_t smem = (size_t)(depth + (shared ? cells : 0)) * sizeof(int32_t);
  unsigned grid = 0;
  int threads = 0;
  cudaError_t err = cms_plan((const void*)kernel, shared, n, cells, smem, &grid, &threads);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(static_cast<const int32_t*>(ids), n, depth,
                                                                     width, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

const char* scatter_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
