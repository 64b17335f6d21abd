// The heavy-hitter ledger walk of the sketch plane on Hopper: one launch per
// batch, bit-identical to the sequential walk. For each id x of the batch, in
// order (valid: x >= 0):
//   counts[j, column(x, j)] += valid for every depth row j (cm_hash.cuh);
//   est = min over j of counts[j, column(x, j)], after the add;
//   every ledger slot whose key is x raises its count to max(count, est);
//   if no slot holds x, x is valid and est is above the smallest count, the
//   first slot with the smallest count (argmin's lowest index) becomes (x, est).
// The ledger is (k, 2) int32 rows [key, count]; an empty slot is [-1, 0].
//
// Replaces: metrics_tpu/sketch/kernels.py::cms_update (:296-334), a lax.scan
// over the batch with no Pallas body, which the port first ran as a Python
// loop of about 18 launches per item.
//
// What bounds it: the walk is one chain, and the least work for the same
// function is the table half alone, the count-min update of the same ids
// (scatter.cu's ids route; its bound is the walk's). What the design does:
//   - One block; warp 0 walks, the other warps only copy the table and the
//     ledger in and out. The table sits in shared memory when it fits beside
//     the row seeds (4 x 2048 is 32 KB), else it stays in the output in
//     global memory; the same code serves both through a generic pointer.
//   - Estimates 32 items at a time: lane i hashes item i. For each row,
//     __match_any_sync over the valid lanes gives the lanes that share a cell;
//     the lowest reads the cell and adds the group's popcount (one warp owns
//     the table: no atomics). Item i's estimate is min over rows of (cell
//     before the chunk + earlier lanes of its group + 1), which equals the
//     sequential estimate, because the table adds do not depend on the ledger.
//   - Decisions in order, but only for the items that can change the ledger:
//     those whose key the ledger held at the start of the chunk, and those
//     whose estimate is above the ledger's smallest count then. The smallest
//     count never falls, and a key inserted during the chunk has an estimate
//     above it that a later copy of the same id only raises, so every other
//     item is a no-op and is skipped after one ballot.
//   - The ledger: k <= 32 in registers, slot l in lane l (presence is a
//     ballot, the first minimum a ballot on count == min); larger k in shared
//     memory when 8k bytes fit, else in the output, lane l owning the slots
//     l, l + 32, ...; the smallest count is kept in a register and refreshed
//     (__reduce_min_sync) only after an eviction or a raise of a slot that
//     held it (skipping the refresh after other raises took 3-5% off the
//     walk at 4096 and 2^17 ids on the H100).
//   - The ids are loaded 4 chunks ahead of the chunk being walked.
//
// Interface: plain C functions, loaded with ctypes (no PyTorch headers). The
// launch runs on the given stream, does not synchronise, allocates nothing,
// and returns the CUDA error code of the launch (0 on success).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cm_hash.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // warp 0 walks; all copy the table and the ledger
constexpr int kAhead = 4;      // chunks of ids loaded ahead of the one being walked
constexpr unsigned kAll = 0xffffffffu;

// k <= 32: lane l holds slot l in registers.
struct RegLedger {
  int32_t key, cnt;
  bool mine;  // lane < k
  int k;

  __device__ RegLedger(const int32_t* led, int k_) : k(k_) {
    const int lane = threadIdx.x;
    mine = lane < k;
    key = mine ? led[2 * lane] : 0;
    cnt = mine ? led[2 * lane + 1] : INT_MAX;
  }

  __device__ int32_t min_count() const { return __reduce_min_sync(kAll, mine ? cnt : INT_MAX); }

  // Whether a slot holds this lane's x (every lane asks for its own).
  __device__ bool holds(int32_t x) const {
    bool hit = false;
    for (int s = 0; s < k; ++s) hit |= __shfl_sync(kAll, key, s) == x;
    return hit;
  }

  // One item (x, e), the same on every lane; curmin is the smallest count.
  __device__ void decide(int32_t x, int32_t e, int32_t& curmin) {
    const bool hit = mine && key == x;
    if (__any_sync(kAll, hit)) {
      const bool raise = hit && e > cnt;
      const bool at_min = __any_sync(kAll, raise && cnt == curmin);  // else the smallest count stays
      if (raise) cnt = e;
      if (at_min) curmin = min_count();
    } else if (e > curmin) {
      const int slot = __ffs(__ballot_sync(kAll, mine && cnt == curmin)) - 1;
      if ((int)threadIdx.x == slot) {
        key = x;
        cnt = e;
      }
      curmin = min_count();
    }
  }

  __device__ void store(int32_t* led) const {
    if (mine) {
      led[2 * threadIdx.x] = key;
      led[2 * threadIdx.x + 1] = cnt;
    }
  }
};

// Any k, in shared or global memory: lane l owns the slots l, l + 32, ...
struct MemLedger {
  int32_t* led;
  int k;

  __device__ int32_t min_count() const {
    int32_t m = INT_MAX;
    for (int s = threadIdx.x; s < k; s += kWarp) m = min(m, led[2 * s + 1]);
    return __reduce_min_sync(kAll, m);
  }

  __device__ bool holds(int32_t x) const {
    bool hit = false;
    for (int s = 0; s < k; ++s) hit |= led[2 * s] == x;
    return hit;
  }

  __device__ void decide(int32_t x, int32_t e, int32_t& curmin) {
    bool hit = false, at_min = false;
    for (int s = threadIdx.x; s < k; s += kWarp) {
      if (led[2 * s] == x) {
        hit = true;
        const int32_t c = led[2 * s + 1];
        if (e > c) {
          at_min |= c == curmin;
          led[2 * s + 1] = e;
        }
      }
    }
    if (__any_sync(kAll, hit)) {
      if (__any_sync(kAll, at_min)) curmin = min_count();  // else the smallest count stays
    } else if (e > curmin) {
      int first = INT_MAX;
      for (int s = threadIdx.x; s < k; s += kWarp) {
        if (led[2 * s + 1] == curmin) {
          first = s;
          break;
        }
      }
      const int slot = __reduce_min_sync(kAll, first);
      if ((int)threadIdx.x == slot % kWarp) {
        led[2 * slot] = x;
        led[2 * slot + 1] = e;
      }
      __syncwarp();
      curmin = min_count();
    }
  }
};

// The walk of ids[0, n) by warp 0. Returns the number of items that reached
// the sequential decision.
template <bool kPow2, class Ledger>
__device__ __forceinline__ long long walk(const int32_t* __restrict__ ids, long long n, int depth, int width,
                                          const uint32_t* seeds, int32_t* table, Ledger& ledger) {
  const int lane = threadIdx.x;
  int32_t curmin = ledger.min_count();
  long long walked = 0;
  int32_t ahead[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const long long e = (long long)u * kWarp + lane;
    ahead[u] = e < n ? __ldg(ids + e) : -1;
  }
  for (long long base = 0; base < n; base += kAhead * kWarp) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long at = base + (long long)u * kWarp;
      if (at >= n) break;
      const int32_t id = ahead[u];
      const long long next = at + kAhead * kWarp + lane;
      ahead[u] = next < n ? __ldg(ids + next) : -1;
      const bool valid = at + lane < n && id >= 0;

      // the chunk's estimates: the cell before the chunk + the earlier lanes of its group + 1
      int32_t est = INT_MAX;
      for (int j = 0; j < depth; ++j) {
        const int cell = j * width + cm_hash::column<kPow2>(id, seeds[j], (uint32_t)width);
        const unsigned peers = __match_any_sync(kAll, valid ? cell : -1 - lane);
        const int first = __ffs(peers) - 1;
        const bool leads = valid && lane == first;
        const int32_t before = __shfl_sync(kAll, leads ? table[cell] : 0, first);
        if (leads) table[cell] = (int32_t)((uint32_t)before + __popc(peers));
        est = min(est, (int32_t)((uint32_t)before + __popc(peers & ((1u << lane) - 1)) + 1u));
      }
      __syncwarp();  // the chunk's adds and the last chunk's ledger writes are seen by every lane

      const bool held = ledger.holds(id);
      unsigned todo = __ballot_sync(kAll, valid && (held || est > curmin));
      walked += __popc(todo);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        ledger.decide(__shfl_sync(kAll, id, src), __shfl_sync(kAll, est, src), curmin);
      }
    }
  }
  return walked;
}

// Shared memory: the depth row seeds, then the ledger (2k int32, when it is
// there), then the table (when it is there), 16-byte aligned.
template <bool kPow2, bool kRegs>
__global__ void __launch_bounds__(kThreads)
cms_walk_kernel(const int32_t* __restrict__ ids, long long n, int depth, int width, int k, int ledger_in_smem,
                int table_in_smem, int32_t* counts, int32_t* ledger, unsigned long long* walked) {
  extern __shared__ __align__(16) int32_t smem[];
  uint32_t* seeds = reinterpret_cast<uint32_t*>(smem);
  int32_t* led = ledger_in_smem ? smem + depth : ledger;
  const int table_at = (depth + (ledger_in_smem ? 2 * k : 0) + 3) / 4 * 4;
  int32_t* table = table_in_smem ? smem + table_at : counts;
  const int cells = depth * width;
  for (int j = threadIdx.x; j < depth; j += blockDim.x) seeds[j] = cm_hash::row_seed(j);
  if (ledger_in_smem) {
    for (int i = threadIdx.x; i < 2 * k; i += blockDim.x) led[i] = ledger[i];
  }
  if (table_in_smem) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) table[i] = counts[i];
  }
  __syncthreads();

  if (threadIdx.x < kWarp) {
    long long w = 0;
    if constexpr (kRegs) {
      RegLedger l(led, k);
      w = walk<kPow2>(ids, n, depth, width, seeds, table, l);
      l.store(ledger);
    } else {
      MemLedger l{led, k};
      w = walk<kPow2>(ids, n, depth, width, seeds, table, l);
    }
    if (walked != nullptr && threadIdx.x == 0) *walked += (unsigned long long)w;
  }
  __syncthreads();

  if (ledger_in_smem) {
    for (int i = threadIdx.x; i < 2 * k; i += blockDim.x) ledger[i] = led[i];
  }
  if (table_in_smem) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) counts[i] = table[i];
  }
}

// Where the walk keeps the ledger and the table for this shape on the current
// device: bit 0 the table in shared memory, bit 1 the ledger in shared
// memory, bit 2 the ledger in registers; *smem the bytes of shared memory.
// A negative CUDA error code when the device cannot be queried.
int placement(int depth, int width, int k, size_t* smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  const bool regs = k <= kWarp;
  long long words = depth;
  int bits = regs ? 4 : 0;
  if (!regs && (words + 2LL * k) * (long long)sizeof(int32_t) <= optin) {
    words += 2LL * k;
    bits |= 2;
  }
  words = (words + 3) / 4 * 4;
  const long long cells = (long long)depth * width;
  if ((words + cells) * (long long)sizeof(int32_t) <= optin) {
    words += cells;
    bits |= 1;
  }
  *smem = (size_t)words * sizeof(int32_t);
  return bits;
}

typedef void (*WalkKernel)(const int32_t*, long long, int, int, int, int, int, int32_t*, int32_t*,
                           unsigned long long*);

}  // namespace

extern "C" {

// Bits of where the walk keeps its state for this shape (see placement).
int cms_walk_placement(int depth, int width, int k) {
  size_t smem = 0;
  return placement(depth, width, k, &smem);
}

// ids: n int32 on the device; counts: depth * width int32, a copy of the
// table, walked in place; ledger: k * 2 int32, a copy of the ledger, walked
// in place; walked: NULL, or one uint64 on the device to which the launch adds
// the number of items that reached the sequential decision. The caller
// guarantees 1 <= n < 2^31, 1 <= depth <= 4096, width >= 1, depth * width <
// 2^31 and 1 <= k < 2^30.
int cms_walk_launch(const void* ids, long long n, int depth, int width, int k, void* counts, void* ledger,
                    void* walked, void* stream) {
  size_t smem = 0;
  const int bits = placement(depth, width, k, &smem);
  if (bits < 0) return -bits;
  const bool pow2 = (width & (width - 1)) == 0;
  const bool regs = (bits & 4) != 0;
  const WalkKernel kernel = pow2 ? (regs ? cms_walk_kernel<true, true> : cms_walk_kernel<true, false>)
                                 : (regs ? cms_walk_kernel<false, true> : cms_walk_kernel<false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), n, depth, width, k, (bits & 2) != 0, (bits & 1) != 0,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(ledger), static_cast<unsigned long long*>(walked));
  return (int)cudaGetLastError();
}

const char* cms_walk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
