// The heavy-hitter ledger walk of the sketch plane on Hopper, bit-identical to
// the sequential walk. For each id x of the batch, in order (valid: x >= 0):
//   counts[j, column(x, j)] += valid for every depth row j (cm_hash.cuh);
//   est = min over j of counts[j, column(x, j)], after the add;
//   every ledger slot whose key is x raises its count to max(count, est);
//   if no slot holds x, x is valid and est is above the smallest count, the
//   first slot with the smallest count (argmin's lowest index) becomes (x, est).
// The ledger is (k, 2) int32 rows [key, count]; an empty slot is [-1, 0].
//
// Replaces: metrics_tpu/sketch/kernels.py::cms_update (:296-334), a lax.scan
// over the batch with no Pallas body.
//
// What bounds it: the evictions, the one chain that every order of work
// shares (each one reads the ledger the one before it wrote), plus the table
// half, the count-min update of the same ids (scatter.cu's ids route). What
// the design does, in four kernels on one stream:
//   1. cms_walk_hist_kernel: the batch is cut into segments of consecutive
//      ids, one block each; a block counts its segment's valid ids per cell.
//   2. cms_walk_scan_kernel: one thread a cell scans the histograms over the
//      segments: segment s's row becomes the cell's count before the batch
//      plus the counts of the segments before s, and the new table is the
//      count before the batch plus them all (uint32 adds: the int32 wrap of
//      the sequential adds, in another order, with the same result).
//   3. cms_walk_est_kernel: one warp a segment takes its ids in order, 32 at
//      a time, with its row as a running table: per row, __match_any_sync
//      gives the lanes on one cell, the lowest reads the cell and adds the
//      group's size, and lane i's estimate is the cell plus the earlier lanes
//      of its group plus one. An estimate depends on the ids alone, not on the
//      ledger, so this equals the sequential estimate.
//   4. The walk of (id, est), which applies raises in any order between
//      evictions (below). k <= 32, cms_walk_step_kernel: 16 warps take a
//      step of 512 items together; presence is a lookup in a 128-entry hash table
//      of the keys in shared memory, beside the counts. k > 32,
//      cms_walk_kernel: one warp takes chunks of 32, the ledger in shared
//      memory, or in the output when 8k bytes do not fit.
//
// Why raises may go in any order (the walk's safety argument):
//   (a) curmin, the ledger's smallest count, never falls: a raise only lifts a
//       count, and an eviction replaces the smallest count with a larger one.
//   (b) For one id, the estimate never falls within a batch as long as no
//       cell wraps (each later copy adds one to each of its cells). The walk
//       does not rely on (b), which int32 wrap breaks near 2^31: the keys are
//       brought up to date after every eviction, inside a chunk too.
//   (c) The keys change only at an eviction. So an item that the ledger did
//       not hold at a snapshot taken with no eviction between it and the
//       item, and whose estimate is at most the snapshot's curmin, is a no-op
//       at its own time: it is still not held, and by (a) its estimate is not
//       above curmin then.
//   (d) So an item can evict only if it is a candidate: not held at the
//       snapshot and with an estimate above the snapshot's curmin. Until the
//       first candidate the keys stay fixed, every held item sets
//       count = max(count, est) on fixed slots, and those max-raises commute.
// Per step (or chunk) the walk therefore applies the raises before the first
// candidate at once (atomicMax; curmin is refreshed by one __reduce_min_sync
// only when a raised slot held it), decides the candidate exactly (its raises
// are applied, so the first minimum is argmin's), brings the held flags of the
// later items up to date if it evicted, and goes on with the rest of the step
// the same way. A step with no candidate costs the loads, a table lookup, a
// few ballots, its atomics and two barriers.
//
// Interface: plain C functions, loaded with ctypes (no PyTorch headers). The
// launch runs on the given stream, does not synchronise, allocates nothing,
// and returns the CUDA error code of the first launch that failed (0 on
// success).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cm_hash.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kHistThreads = 256;  // one block a segment
constexpr int kScanThreads = 256;  // one thread a cell
constexpr int kScanBatch = 8;      // segments whose counts one scan thread loads together
constexpr int kRows = 4;           // depth rows whose cells an estimate warp reads together
constexpr int kWalkThreads = 256;  // k > 32: warp 0 walks; all copy the ledger in and out
constexpr int kAhead = 4;          // k > 32: chunks of (id, estimate) loaded ahead of the one being walked
constexpr int kStepWarps = 16;     // k <= 32: warps that walk a step together
constexpr int kStep = kStepWarps * kWarp;  // items of a step
constexpr int kAheadSteps = 2;     // steps of (id, estimate) loaded ahead of the one being walked
constexpr int kTable = 128;        // k <= 32: entries of the presence table, at least 4 per slot

__host__ __device__ __forceinline__ long long round4(long long x) { return (x + 3) / 4 * 4; }

// ------------------------------------------------------------------ the estimates

// Segment blockIdx.x's count of valid ids per cell, written whole into its row
// of hist (kShared: counted in shared memory after the row seeds; else
// counted straight into the row, which the launch zeroed).
template <bool kPow2, bool kShared>
__global__ void __launch_bounds__(kHistThreads)
cms_walk_hist_kernel(const int32_t* __restrict__ ids, long long n, long long per, int depth, int width,
                     int32_t* __restrict__ hist) {
  extern __shared__ __align__(16) int32_t smem[];
  uint32_t* seeds = reinterpret_cast<uint32_t*>(smem);
  const long long cells = (long long)depth * width;
  int32_t* row = hist + (long long)blockIdx.x * cells;
  int32_t* h = kShared ? smem + round4(depth) : row;
  for (int j = threadIdx.x; j < depth; j += blockDim.x) seeds[j] = cm_hash::row_seed(j);
  if constexpr (kShared) {
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) h[c] = 0;
  }
  __syncthreads();
  const long long lo = (long long)blockIdx.x * per, hi = min(n, lo + per);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int32_t id = __ldg(ids + i);
    if (id < 0) continue;
    for (int j = 0; j < depth; ++j) atomicAdd(h + j * width + cm_hash::column<kPow2>(id, seeds[j], (uint32_t)width), 1);
  }
  if constexpr (kShared) {
    __syncthreads();
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) row[c] = h[c];
  }
}

// One thread a cell: row s of hist becomes counts_in + the counts of the
// segments before s, and counts_out = counts_in + every segment's count.
__global__ void __launch_bounds__(kScanThreads)
cms_walk_scan_kernel(const int32_t* __restrict__ counts_in, long long cells, int segments, int32_t* hist,
                     int32_t* __restrict__ counts_out) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  int32_t* col = hist + c;
  uint32_t acc = (uint32_t)counts_in[c];
  for (int s0 = 0; s0 < segments; s0 += kScanBatch) {
    uint32_t v[kScanBatch];
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) v[u] = s0 + u < segments ? (uint32_t)col[(long long)(s0 + u) * cells] : 0u;
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      if (s0 + u < segments) {
        col[(long long)(s0 + u) * cells] = (int32_t)acc;
        acc += v[u];
      }
    }
  }
  counts_out[c] = (int32_t)acc;
}

// One warp (block) a segment: est[i] for every id of segment blockIdx.x, in
// order, from its row of hist as the running table.
template <bool kPow2>
__global__ void __launch_bounds__(kWarp)
cms_walk_est_kernel(const int32_t* __restrict__ ids, long long n, long long per, int depth, int width,
                    int32_t* hist, int32_t* __restrict__ est) {
  extern __shared__ __align__(16) int32_t smem[];
  uint32_t* seeds = reinterpret_cast<uint32_t*>(smem);
  const int lane = threadIdx.x;
  for (int j = lane; j < depth; j += kWarp) seeds[j] = cm_hash::row_seed(j);
  __syncwarp();
  int32_t* table = hist + (long long)blockIdx.x * depth * width;
  const unsigned below = (1u << lane) - 1u;
  const long long lo = (long long)blockIdx.x * per, hi = min(n, lo + per);
  for (long long base = lo; base < hi; base += kWarp) {
    const long long i = base + lane;
    const int32_t id = i < hi ? __ldg(ids + i) : -1;
    const bool valid = id >= 0;
    int32_t m = INT_MAX;
    // the cells of different rows differ, so kRows rows' cells are read before any is written
    for (int j0 = 0; j0 < depth; j0 += kRows) {
      int cell[kRows], first[kRows];
      unsigned peers[kRows];
      uint32_t before[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int j = j0 + u;
        const bool on = valid && j < depth;
        cell[u] = on ? j * width + cm_hash::column<kPow2>(id, seeds[j], (uint32_t)width) : 0;
        peers[u] = __match_any_sync(kAll, on ? cell[u] : -1 - lane);
        first[u] = __ffs(peers[u]) - 1;
        before[u] = on && lane == first[u] ? (uint32_t)table[cell[u]] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const uint32_t b = __shfl_sync(kAll, before[u], first[u]);
        if (valid && j0 + u < depth) {
          if (lane == first[u]) table[cell[u]] = (int32_t)(b + __popc(peers[u]));
          m = min(m, (int32_t)(b + __popc(peers[u] & below) + 1u));
        }
      }
    }
    if (i < hi) est[i] = m;  // an invalid id's estimate is never read
    __syncwarp();            // this chunk's writes are seen by every lane of the next
  }
}

// ------------------------------------------------------------------ the ledger

// Any k, rows [key, count] in shared memory or (kGlobal) in the output, read
// past L1 there. A lane's place in the ledger is the first slot holding its
// id, or k.
template <bool kGlobal>
struct MemLedger {
  int32_t* led;
  int k;

  __device__ int32_t ld(const int32_t* p) const {
    if constexpr (kGlobal) return __ldcg(p);
    else return *p;
  }

  static constexpr int kNone = INT_MAX;
  // the first slot above `after` holding x, or kNone; no early exit, so the loads pipeline
  __device__ int first_from(int32_t x, int after) const {
    int first = kNone;
    for (int s = k - 1; s > after; --s) first = ld(led + 2 * s) == x ? s : first;
    return first;
  }
  __device__ int where(int32_t x) const { return first_from(x, -1); }
  __device__ bool held(int w) const { return w != kNone; }

  // count = max(count, e) on every slot from w on that holds x; whether one of them held curmin and rose
  __device__ bool raise(int32_t x, int32_t e, int32_t curmin, int w) const {
    bool moved = false;
    for (int s = w; s < k; ++s) {
      if (ld(led + 2 * s) == x) {
        const int32_t old = atomicMax(led + 2 * s + 1, e);
        moved |= old == curmin && e > old;
      }
    }
    return moved;
  }

  __device__ int32_t min_count() const {
    __syncwarp();
    int32_t m = INT_MAX;
    for (int s = threadIdx.x; s < k; s += kWarp) m = min(m, ld(led + 2 * s + 1));
    return __reduce_min_sync(kAll, m);
  }

  __device__ int evict(int32_t x, int32_t e, int32_t curmin) {
    __syncwarp();
    int first = INT_MAX;
    for (int s = threadIdx.x; s < k; s += kWarp) {
      if (ld(led + 2 * s + 1) == curmin) {
        first = s;
        break;
      }
    }
    const int slot = __reduce_min_sync(kAll, first);
    if ((int)threadIdx.x == slot % kWarp) {
      led[2 * slot] = x;
      led[2 * slot + 1] = e;
    }
    return slot;
  }

  __device__ int after_evict(int w, int32_t x, int32_t xc, int slot) const {
    if (x == xc) return slot;  // xc was held nowhere: slot is its only place
    return w == slot ? first_from(x, slot) : w;
  }
};

// k > 32: the walk of (ids, est)[0, n) by one warp, a chunk of 32 at a time;
// counters gain (raises, evictions, chunks that held an exact decision).
template <bool kGlobal>
__device__ __forceinline__ void walk(const int32_t* __restrict__ ids, const int32_t* __restrict__ est, long long n,
                                     MemLedger<kGlobal>& ledger, unsigned long long* counters) {
  const int lane = threadIdx.x;
  int32_t curmin = ledger.min_count();
  unsigned long long raises = 0, evictions = 0, sequential = 0;
  int32_t ahead_x[kAhead], ahead_e[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const long long i = (long long)u * kWarp + lane;
    ahead_x[u] = i < n ? __ldg(ids + i) : -1;
    ahead_e[u] = i < n ? __ldg(est + i) : 0;
  }
  for (long long base = 0; base < n; base += kAhead * kWarp) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long at = base + (long long)u * kWarp;
      if (at >= n) break;
      const int32_t x = ahead_x[u], e = ahead_e[u];
      const long long next = at + kAhead * kWarp + lane;
      ahead_x[u] = next < n ? __ldg(ids + next) : -1;
      ahead_e[u] = next < n ? __ldg(est + next) : 0;
      const bool valid = x >= 0;  // lanes past n hold -1

      int w = valid ? ledger.where(x) : ledger.kNone;  // the snapshot of the keys
      unsigned todo = __ballot_sync(kAll, valid);
      bool reached = false;
      while (todo) {
        const bool mine = (todo >> lane) & 1u;
        const unsigned cand = __ballot_sync(kAll, mine && !ledger.held(w) && e > curmin);
        const unsigned upto = cand ? (1u << (__ffs(cand) - 1)) - 1u : kAll;  // the lanes before it
        const bool up = mine && ledger.held(w) && ((upto >> lane) & 1u);
        const unsigned raising = __ballot_sync(kAll, up);
        if (raising) {
          raises += __popc(raising);
          const bool moved = up && ledger.raise(x, e, curmin, w);
          if (__any_sync(kAll, moved)) curmin = ledger.min_count();
        }
        if (!cand) break;
        reached = true;
        const int c = __ffs(cand) - 1;
        todo &= ~((2u << c) - 1u);  // the lanes after it (none when c = 31)
        const int32_t xc = __shfl_sync(kAll, x, c), ec = __shfl_sync(kAll, e, c);
        if (ec > curmin) {  // curmin is exact here: the raises before c are in
          const int slot = ledger.evict(xc, ec, curmin);
          ++evictions;
          curmin = ledger.min_count();
          w = valid ? ledger.after_evict(w, x, xc, slot) : ledger.kNone;
        }
      }
      sequential += reached;
    }
  }
  if (counters != nullptr && lane == 0) {
    atomicAdd(counters, raises);
    atomicAdd(counters + 1, evictions);
    atomicAdd(counters + 2, sequential);
  }
}

// k <= 32: the presence table, open addressing in shared memory: tkey[h] is
// a key (-1: empty) and tmask[h] the slots holding it; a key's first place is
// the top bits of its hash. Only keys >= 0 enter (no valid id is negative).
__device__ __forceinline__ unsigned table_place(int32_t x) { return cm_hash::mix32((uint32_t)x) >> 25; }

// The slots holding x (x >= 0), 0 when none.
__device__ __forceinline__ unsigned table_find(const int32_t* tkey, const unsigned* tmask, int32_t x) {
  for (unsigned h = table_place(x);; h = (h + 1) % kTable) {
    const int32_t t = tkey[h];
    if (t == x) return tmask[h];
    if (t == -1) return 0u;
  }
}

// The table of key_at[0, k), built by one warp.
__device__ __forceinline__ void table_build(const int32_t* key_at, int k, int32_t* tkey, unsigned* tmask) {
  const int lane = threadIdx.x % kWarp;
  for (int h = lane; h < kTable; h += kWarp) {
    tkey[h] = -1;
    tmask[h] = 0u;
  }
  __syncwarp();
  const int32_t key = lane < k ? key_at[lane] : -1;
  if (key >= 0) {
    for (unsigned h = table_place(key);; h = (h + 1) % kTable) {
      const int32_t was = atomicCAS(tkey + h, -1, key);
      if (was == -1 || was == key) {
        atomicOr(tmask + h, 1u << lane);
        break;
      }
    }
  }
  __syncwarp();
}

// k <= 32: the walk of (ids, est)[0, n) by kStepWarps warps, a step of kStep
// consecutive items at a time, warp w on items [32w, 32w + 32) of the step.
// A lane's place in the ledger is the mask of the slots holding its id, from
// the presence table (the snapshot of the keys, rebuilt at each eviction);
// the counts sit in shared memory. A step goes in rounds: each warp finds
// its first candidate against the snapshot (barrier), every held item before
// the step's first candidate raises its slots with atomicMax, and the block
// ORs whether a raise may have lifted a slot that held curmin (barrier). With
// no candidate the step ends there, every warp taking the new curmin if it
// may have moved. Otherwise warp 0 takes curmin, decides the candidate
// exactly and evicts (barrier), every warp takes the new key into its
// snapshot, and the next round takes the items after the candidate. counters
// gain (raises, evictions, chunks of 32 that held an exact decision).
__global__ void __launch_bounds__(kStep)
cms_walk_step_kernel(const int32_t* __restrict__ ids, const int32_t* __restrict__ est, long long n, int k,
                     const int32_t* __restrict__ ledger_in, int32_t* __restrict__ ledger_out,
                     unsigned long long* counters) {
  __shared__ int32_t cnt[kWarp], key_at[kWarp], tkey[kTable];
  __shared__ unsigned tmask[kTable];
  __shared__ int cand_lane[kStepWarps];
  __shared__ int32_t cand_x[kStepWarps], cand_e[kStepWarps];
  __shared__ int32_t curmin_at;
  __shared__ int evicted_at;  // 1 + the slot a round's eviction took, or 0
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (threadIdx.x < k) {
    key_at[threadIdx.x] = ledger_in[2 * threadIdx.x];
    cnt[threadIdx.x] = ledger_in[2 * threadIdx.x + 1];
  }
  __syncthreads();
  if (warp == 0) table_build(key_at, k, tkey, tmask);
  __syncthreads();
  int32_t curmin = __reduce_min_sync(kAll, lane < k ? cnt[lane] : INT_MAX);
  unsigned long long raises = 0, evictions = 0, chunks = 0;
  long long last_chunk = -1;
  int32_t ahead_x[kAheadSteps], ahead_e[kAheadSteps];
#pragma unroll
  for (int u = 0; u < kAheadSteps; ++u) {
    const long long i = (long long)u * kStep + threadIdx.x;
    ahead_x[u] = i < n ? __ldg(ids + i) : -1;
    ahead_e[u] = i < n ? __ldg(est + i) : 0;
  }
  for (long long base = 0; base < n; base += kAheadSteps * kStep) {
#pragma unroll
    for (int u = 0; u < kAheadSteps; ++u) {
      const long long at = base + (long long)u * kStep;
      if (at >= n) break;
      const int32_t x = ahead_x[u], e = ahead_e[u];
      const long long next = at + kAheadSteps * kStep + threadIdx.x;
      ahead_x[u] = next < n ? __ldg(ids + next) : -1;
      ahead_e[u] = next < n ? __ldg(est + next) : 0;
      const bool valid = x >= 0;  // items past n hold -1
      unsigned m = valid ? table_find(tkey, tmask, x) : 0u;  // the snapshot: the slots that hold x
      bool todo = valid;
      while (true) {  // rounds; every condition below is the same on every thread
        const unsigned cand = __ballot_sync(kAll, todo && m == 0 && e > curmin);
        const int c = cand ? __ffs(cand) - 1 : kWarp;
        const int32_t xc = __shfl_sync(kAll, x, c % kWarp), ec = __shfl_sync(kAll, e, c % kWarp);
        if (lane == 0) {
          cand_lane[warp] = c;
          cand_x[warp] = xc;
          cand_e[warp] = ec;
        }
        __syncthreads();
        int wc = kStepWarps, cc = kWarp;  // the step's first candidate
#pragma unroll
        for (int v = kStepWarps - 1; v >= 0; --v) {
          const int l = cand_lane[v];
          if (l < kWarp) {
            wc = v;
            cc = l;
          }
        }
        const bool found = wc < kStepWarps;
        // read before the round's last barrier: the next round writes them after it
        const int32_t xw = found ? cand_x[wc] : 0, ew = found ? cand_e[wc] : 0;
        const bool up = todo && m != 0 && (warp < wc || (warp == wc && lane < cc));
        bool moved = false;  // whether a raise may lift a slot that holds curmin
        if (up) {
          for (unsigned left = m; left; left &= left - 1) {
            const int s = __ffs(left) - 1;
            // counts only rise, so a slot that holds curmin when raised holds it when read first
            moved |= cnt[s] == curmin && e > curmin;
            atomicMax(cnt + s, e);
          }
        }
        raises += __popc(__ballot_sync(kAll, up));
        const bool any_moved = __syncthreads_or(moved);
        if (!found) {
          // the counts stay as they are until the next round's first barrier
          if (any_moved) curmin = __reduce_min_sync(kAll, lane < k ? cnt[lane] : INT_MAX);
          break;
        }
        if (warp == 0) {
          curmin = __reduce_min_sync(kAll, lane < k ? cnt[lane] : INT_MAX);
          int slot = -1;
          if (ew > curmin) {  // curmin is exact here: the raises before the candidate are in
            slot = __ffs(__ballot_sync(kAll, lane < k && cnt[lane] == curmin)) - 1;
            if (lane == slot) {
              cnt[slot] = ew;
              key_at[slot] = xw;
            }
            __syncwarp();
            curmin = __reduce_min_sync(kAll, lane < k ? cnt[lane] : INT_MAX);
            table_build(key_at, k, tkey, tmask);
            ++evictions;
          }
          const long long chunk = (at + wc * kWarp + cc) / kWarp;
          chunks += chunk != last_chunk;
          last_chunk = chunk;
          if (lane == 0) {
            curmin_at = curmin;
            evicted_at = slot + 1;
          }
        }
        __syncthreads();
        curmin = curmin_at;
        if (evicted_at) {  // the new key enters the snapshot of the step's later items
          const int slot = evicted_at - 1;
          m = (m & ~(1u << slot)) | ((valid && x == xw ? 1u : 0u) << slot);
        }
        todo = todo && (warp > wc || (warp == wc && lane > cc));
      }
    }
  }
  if (counters != nullptr) {
    if (lane == 0) atomicAdd(counters, raises);
    if (threadIdx.x == 0) {
      atomicAdd(counters + 1, evictions);
      atomicAdd(counters + 2, chunks);
    }
  }
  __syncthreads();
  if (threadIdx.x < k) {
    ledger_out[2 * threadIdx.x] = key_at[threadIdx.x];
    ledger_out[2 * threadIdx.x + 1] = cnt[threadIdx.x];
  }
}

// k > 32: one warp walks, the ledger in shared memory (kGlobal false) or in
// the output, walked in place after a copy of the input.
template <bool kGlobal>
__global__ void __launch_bounds__(kWalkThreads)
cms_walk_kernel(const int32_t* __restrict__ ids, const int32_t* __restrict__ est, long long n, int k,
                const int32_t* __restrict__ ledger_in, int32_t* ledger_out, unsigned long long* counters) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* led = kGlobal ? ledger_out : smem;
  for (int i = threadIdx.x; i < 2 * k; i += blockDim.x) led[i] = ledger_in[i];
  __syncthreads();
  if (threadIdx.x < kWarp) {
    MemLedger<kGlobal> l{led, k};
    walk(ids, est, n, l, counters);
  }
  if constexpr (!kGlobal) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * k; i += blockDim.x) ledger_out[i] = led[i];
  }
}

// Where the launch keeps its state for this shape on the current device: bit
// 0 the segment histograms counted in shared memory, bit 1 the ledger in
// shared memory for the one-warp walk, bit 2 the step walk (k <= 32). A negative CUDA error code
// when the device cannot be queried. *optin: the device's shared memory a
// block may take.
int placement(int depth, int width, int k, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  int bits = 0;
  if ((round4(depth) + (long long)depth * width) * (long long)sizeof(int32_t) <= *optin) bits |= 1;
  if (k <= kWarp) bits |= 4;
  else if (2LL * k * (long long)sizeof(int32_t) <= *optin) bits |= 2;
  return bits;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

#define CMS_WALK_TRY(expr)                  \
  do {                                      \
    const cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

template <bool kPow2>
int launch(const int32_t* ids, long long n, int depth, int width, const int32_t* counts_in, const int32_t* ledger_in,
           int k, int segments, int32_t* scratch, int32_t* counts_out, int32_t* ledger_out,
           unsigned long long* counters, cudaStream_t s) {
  int optin = 0;
  const int bits = placement(depth, width, k, &optin);
  if (bits < 0) return -bits;
  const long long cells = (long long)depth * width;
  const long long per = (n + segments - 1) / segments;
  int32_t* est = scratch;
  int32_t* hist = scratch + round4(n);
  const size_t seeds = (size_t)round4(depth) * sizeof(int32_t);

  if (bits & 1) {
    const size_t smem = seeds + (size_t)cells * sizeof(int32_t);
    CMS_WALK_TRY(allow_smem(cms_walk_hist_kernel<kPow2, true>, smem));
    cms_walk_hist_kernel<kPow2, true><<<segments, kHistThreads, smem, s>>>(ids, n, per, depth, width, hist);
  } else {
    CMS_WALK_TRY(cudaMemsetAsync(hist, 0, (size_t)segments * cells * sizeof(int32_t), s));
    cms_walk_hist_kernel<kPow2, false><<<segments, kHistThreads, seeds, s>>>(ids, n, per, depth, width, hist);
  }
  CMS_WALK_TRY(cudaGetLastError());
  cms_walk_scan_kernel<<<(unsigned)((cells + kScanThreads - 1) / kScanThreads), kScanThreads, 0, s>>>(
      counts_in, cells, segments, hist, counts_out);
  CMS_WALK_TRY(cudaGetLastError());
  cms_walk_est_kernel<kPow2><<<segments, kWarp, seeds, s>>>(ids, n, per, depth, width, hist, est);
  CMS_WALK_TRY(cudaGetLastError());

  if (bits & 4) {
    cms_walk_step_kernel<<<1, kStep, 0, s>>>(ids, est, n, k, ledger_in, ledger_out, counters);
  } else if (bits & 2) {
    const size_t smem = 2 * (size_t)k * sizeof(int32_t);
    CMS_WALK_TRY(allow_smem(cms_walk_kernel<false>, smem));
    cms_walk_kernel<false><<<1, kWalkThreads, smem, s>>>(ids, est, n, k, ledger_in, ledger_out, counters);
  } else {
    cms_walk_kernel<true><<<1, kWalkThreads, 0, s>>>(ids, est, n, k, ledger_in, ledger_out, counters);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bits of where the launch keeps its state for this shape (see placement).
int cms_walk_placement(int depth, int width, int k) {
  int optin = 0;
  return placement(depth, width, k, &optin);
}

// ids: n int32 on the device; counts_in: the depth * width int32 table;
// ledger_in: the k * 2 int32 ledger; segments: how many segments the batch is
// cut into for the estimates; scratch: round4(n) + segments * depth * width
// int32 of working memory; counts_out, ledger_out: the new table and ledger
// (every word written); counters: NULL, or three uint64 on the device that
// gain (raises, evictions, chunks that reached a candidate). The caller
// guarantees 1 <= n < 2^31, 1 <= depth <= 4096, width >= 1, depth * width <
// 2^31, 1 <= k < 2^30 and 1 <= segments <= n.
int cms_walk_launch(const void* ids, long long n, int depth, int width, const void* counts_in,
                    const void* ledger_in, int k, int segments, void* scratch, void* counts_out, void* ledger_out,
                    void* counters, void* stream) {
  const bool pow2 = (width & (width - 1)) == 0;
  auto* i = static_cast<const int32_t*>(ids);
  auto* c_in = static_cast<const int32_t*>(counts_in);
  auto* l_in = static_cast<const int32_t*>(ledger_in);
  auto* work = static_cast<int32_t*>(scratch);
  auto* c_out = static_cast<int32_t*>(counts_out);
  auto* l_out = static_cast<int32_t*>(ledger_out);
  auto* cnt = static_cast<unsigned long long*>(counters);
  auto s = static_cast<cudaStream_t>(stream);
  return pow2 ? launch<true>(i, n, depth, width, c_in, l_in, k, segments, work, c_out, l_out, cnt, s)
              : launch<false>(i, n, depth, width, c_in, l_in, k, segments, work, c_out, l_out, cnt, s);
}

const char* cms_walk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
