"""Smoke run of metrics_tpu_torch on one NVIDIA GPU (H100): build, check, time.

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

It builds every CUDA kernel of the port's main path from the sources in the
checkout, and then:

- Phase A holds each kernel against its plain PyTorch version on the card
  (``torch.equal`` on int32 counts). Both routes of ``csrc/pair_count.cu``:
  the table route (the confusion matrix) and the stat-score route (int32
  tp/fp/tn/fn without the table), each at the training step's shape and at
  the six-metric collection's (Phase J2), on int64 and int32 labels, mixed
  label types, ``ignore_index`` None, in range, -1 and at or above C,
  out-of-range and negative labels, int64 labels at and above 2^31 (they
  count by their low 32 bits), C = 2, N = 1, N = 0, views at a storage
  offset (no 16-byte loads), the table route's two branches (shared memory
  in clusters of two blocks, up to the largest table a block holds, and
  global atomics) with and without a mask, and the stat-score route's two
  (counters in shared memory, up to the largest C a block holds, and in the
  output for C = 20000); tables and counters above 48 KB of dynamic shared
  memory included.
- Phase B drives the main path through the user's entry point
  (``metrics_tpu_torch.entry.entry``): the fused Accuracy + F1 +
  ConfusionMatrix training step at batch 1024, hidden 4096, 1000 classes,
  8 layers. Kernel launch counts are zeroed just before and read just after;
  each step must launch the stat-score route twice (accuracy, F1) and the
  table route once (the confusion matrix). The card's
  metric states are held bit for bit against a CPU recomputation from the
  same predictions. The stateful ``update``/``forward``/``compute``/``reset``
  path runs once on the card too.
- Phase C times the bare and the fused step, and both routes at the two
  shapes on int64 labels against their plain versions, ``torch.bincount``
  of the pair keys (the library call), and their memory bounds. ``ms`` is
  the wrapper's call time by CUDA events over back-to-back calls;
  ``device_ms`` is the kernel's own device time from ``torch.profiler``.
- Phase D profiles the bare step, the fused step and the fused step's metric
  updates alone: device busy time and idle share per step, and device time
  by kernel; the metric updates must run no int64 reduction.
- Phase A also holds each scatter kernel of the sketch plane (``hist_add``,
  ``hist_max``, ``cms_rows_add`` of ``csrc/scatter.cu``) against its plain
  version: every branch (a shared-memory table, one above 48 KB of dynamic
  shared memory, hist_max's packed int16 table for tables beyond one block,
  and global atomics),
  ragged and tiny N, N = 0, out-of-range indices, zero weights, int32
  extremes, Zipf-skewed keys, and inputs that are views at a storage offset
  with N % 4 != 0 (idx and val at one offset and at two); the ids route of
  ``cms_rows_add`` (columns hashed in the kernel, ``csrc/cm_hash.cuh``) on the
  same count-min shapes, negative ids with the int32 extremes, widths that
  are no power of two, depth 7 x width 1 and a view at a storage offset; and
  the heavy-hitter ledger walk (``csrc/cms_walk.cu``, four kernels: segment
  histograms, their scan, the estimates, the walk) against the plain walk,
  ``torch.equal`` on the table and the ledger, at up to 2^14 items: Zipf,
  uniform, one id, negative ids, ties at the ledger's minimum, non-empty
  starting ledgers (held keys, a duplicate, a negative key), k = 1, 8, 32,
  33, 100 and 40000 (the step walk, the one-warp walk with the ledger in
  shared and in global memory), a
  table beyond shared memory (histograms counted in global memory), widths
  2047 and 65536, a candidate at lane 0 and at lane 31 of a chunk, a raise of
  the slot at the minimum before a candidate in the same chunk, held keys
  above every estimate, duplicate and negative keys, counts that wrap near
  2^31, and a seeded sweep over k and width; the kernel's counters (raises,
  evictions, chunks that reached a candidate) equal to the numpy mirror's
  (``cms_walk.walk_in_chunks``) on every case.
- Phase E drives the sketch plane at the JAX classes' default sizes through
  the functional API and once through the stateful one: QuantileSketch
  (alpha 0.01, 2048 buckets), CardinalitySketch (p = 12 and 16) and the
  4 x 2048 count-min table on 8 batches of 2^22 values, HeavyHittersSketch
  (k 32, 4 x 2048) on 4 batches of HH_BATCH ids. Launch counts are zeroed just
  before and read just after: 2 hist_add per quantile update, 1 hist_max per
  cardinality update, 1 cms_rows_add (its ids route, past the registry) per
  table update, 4 cms_walk kernels per heavy-hitter update, and no reference
  dispatch on a CUDA tensor. The int32 states are held against a CPU
  recomputation (the heavy hitters through the plain walk) and the merge of
  two half-streams against the single stream.
- Phase F times each scatter kernel at the Phase E shapes (call, device,
  plain version, one PyTorch library call, bound; the ids route's bound is
  the larger of its bytes and its hash's integer instructions over the
  card's issue rate, 128 lanes a SM at ``clocks.max.sm``), the ledger walk at
  4096, HH_BATCH and 2^22 ids (µs per item, device time by kernel, the
  counters, equal to the mirror's; bound: the evictions times the fewest
  dependent cycles of one decision over ``clocks.max.sm``, plus the ids
  route's bound at the same N; beside it ``snapshot_bound_ms``, the same
  cycles for every item held at the start of its chunk of 32 or above the
  smallest count then, the bound of a walk that decides each of those), each
  sketch's update and values/s, and profiles a quantile, a count-min table
  and a heavy-hitter update.
- Phase G holds the threshold-count kernel of the binned curves
  (``csrc/binned_curve.cu``) against its plain version: ``torch.equal`` on
  0/1 weights at N = 10^6 with T = 100, 200, 400 and 1024 and with 10
  columns, and on the edge cases of the CPU tests (NaN, +-inf, -0.0, scores
  on a threshold, unsorted, descending and duplicate thresholds, NaN and
  +-inf thresholds, -0.0 against +0.0 scores, T = 1, T above one block's
  1024, N = 1, ragged N, N = 0 without a launch, views at a storage offset),
  on both sides of the crossover between the sorted-threshold and the
  comparison route; float weights within ``rtol=1e-5, atol=1e-3``, two
  launches on one input bit-identical.
- Phase H drives the binned curves at full width: 8 updates of 10^6 scores
  at T = 200 through BinaryPrecisionRecallCurve, BinaryROC, BinaryAUROC
  (max_fpr None and 0.5) and BinaryAveragePrecision, functional API and
  stateful; MulticlassAUROC and MultilabelAveragePrecision at C = 10 on 10^6
  rows; one exact-mode BinaryAUROC on 2^20 scores. Launch counts are zeroed
  just before and read just after: one binned_curve launch per binned update
  and no reference dispatch. The int32 states are held against a CPU
  recomputation (the plain version) and the merge of two half-streams
  against the single stream; values against the CPU.
- Phase I times the kernel at the Phase H shape, at T = 1024 and at C = 10
  (device time under the profiler, summed over every kernel one wrapper call
  launches and divided by the calls, call time, plain version, bound: the larger of the
  bytes and the operations of the sorted-threshold route, O(N log T), the
  least work that computes the function; no single PyTorch call
  computes the function, so the three-call bucketize + bincount + cumsum
  route is timed beside it) and the five binary updates per batch.
- Phase J drives the metric core. J1: the flagship step at full width with
  its three metrics in a ``MetricCollection`` (one eager ``update`` forms
  the groups the JAX package forms, {accuracy, f1} and {confmat}; then
  ``init_state`` / ``update_state`` / ``compute_from``): 20 chained steps of
  ``sgd_step`` + ``argmax`` + ``update_state``, 1 stat-score and 1 table
  launch per step against 2 and 1 for the same metrics as a dict on the
  same predictions, no reference dispatch,
  states and values equal to the dict path's (``torch.equal``), and the
  step timed beside the bare and the dict step as Phase C times it. J2: the
  six-metric collection of ``benchmarks/collections_vs_reference.py``
  (accuracy micro; precision, recall, F1, specificity macro; a confusion
  matrix) at N = 10^6, C = 100, with compute groups on and off: the groups
  at construction and after the first update as the JAX package forms them,
  1 stat-score and 1 table launch per update against 5 and 1 (3 and 1 in
  the update that forms the groups, one per group seeded at construction),
  no reference dispatch, int32 states equal in both modes
  and to a CPU recomputation, ``compute()`` equal, and 8 updates timed by
  CUDA events (groups on and off interleaved, minimum of 5). J3: Sum, Mean,
  Max, Min and Cat on 2^22 float32 values with NaN under "warn", "ignore"
  and a float imputation (Max, Min and Cat exact, Sum and Mean within rtol
  1e-5 of a float64 CPU sum), every state on the card, and
  ``MulticlassPrecision + MulticlassRecall`` and ``2 * MeanMetric`` equal to
  the operator on their children's values.

- Phase K drives the port's ``StreamingEngine`` on the card, each micro-batch
  one CUDA-graph replay (``metrics_tpu_torch/engine/runtime.py``). Each
  sub-phase warms up over its bucket ladder (one capture a bucket; compiles
  must equal the bucket count after the traffic too), serves from client
  threads, and holds every tenant's state to a per-tenant sequential fold of
  the same requests through ``update_state`` on the card (``torch.equal``
  leaf for leaf; ``_update_count`` counts rows). K1: ``QuantileSketch()``
  at ``benchmarks/engine_throughput.py --sketch``'s configuration (buckets
  (64, 256), max_queue 2048, capacity 8; 8000 batch-1 lognormal requests
  over 8 tenants from 4 threads), beside 300 naive per-call updates. K2: the
  flagship metrics (accuracy micro, F1 macro, a confusion matrix at 1000
  classes) in a ``MetricCollection``, 4000 requests of 1-16 int64 label
  pairs plus one 600-row request a tenant (split into chunks), states also
  against the plain versions on the CPU, ``compute()`` equal, and the
  collection's ``jitted_update_state`` against ``update_state``. K3:
  ``HeavyHittersSketch`` (k 32, 4 x 2048) on 1000 Zipf(1.1) ids over 4
  tenants from one thread. K4: ``BinaryAUROC(thresholds=200)`` on 1000
  requests of 1-8 scores. K1 and K2 then profile a window of replays: the
  hand kernels' launches in the profile must equal the launches captured x
  replays; the device's idle share and µs per row. Every graph's nodes
  (``cudaGraphGetNodes``), capture and warm-up ms and pool growth are
  printed. K5: an update that reads a value on the host cannot be captured:
  one demotion (``fused_fallbacks == 1``), every request answered, then
  eager updates on the card with ``hist_add`` launched, states equal to
  the fold, and random numbers still drawn after the failed capture. K6:
  ``BinaryAccuracy()`` with its value checks on, at
  ``benchmarks/engine_throughput.py``'s headline configuration (the K1
  engine settings; 8000 batch-1 int64 requests, seed 0), beside 300 naive
  per-call forwards: no fallback, states equal to the fold, then
  ``evict_tenant("tenant-0")`` returns True, the tenant leaves
  ``compute_all()``, and its resubmitted requests give a fresh tenant's
  state with no new capture.
- Phase L drives the binary and multilabel stat-score families and
  ``MeanSquaredError`` at the JAX benchmarks' sizes: 10^6 float32 scores
  with int32 targets (``benchmarks/classification_vs_reference.py``, seed
  0), as 10^6 binary scores and as 10^4 samples x 100 labels, through
  each of stat scores, confusion matrix, accuracy, F1, precision, recall
  and specificity by its class, its task façade, its functional and its
  functional façade (int32 states bit-identical to the port's plain code
  on the CPU, values within rtol 1e-6); 10^6 float32 pairs through
  ``MeanSquaredError`` (``benchmarks/regression_vs_reference.py``; the sum
  within rtol 1e-5 of a float64 sum and of the CPU's). These updates are
  plain torch code (no hand kernel): each class update is timed by CUDA
  events, with and without its value checks, and profiled (device time,
  idle share, device kernels a update).
- Phase M drives the durable state plane (``metrics_tpu_torch/ckpt/``, the
  engine's ``checkpoint=``). M1: the checkpoint overhead at K6's
  configuration by ``benchmarks/engine_throughput.py``'s procedure (6 pairs
  of passes, plain and with ``CheckpointConfig(interval_s=0.25, retain=3)``
  in a temporary directory, alternating which goes first; the median of the
  per-pair ratios, less one; the JAX benchmark's 5% gate is printed as a
  record, not checked), each pass's states held to the fold, with the best
  req/s of each side, the snapshots, WAL records and bytes a pass, the write
  ms a snapshot and the temporary directory's filesystem. M2: the flagship
  collection at 1000 classes and ``QuantileSketch`` served, snapshotted
  half way, served on and crashed (``close(checkpoint=False)``); a new engine
  on the card recovers: every leaf ``torch.equal`` to the crashed engine's
  and to the fold, the graph replays equal to the chunk records replayed,
  the wrappers' counters advanced twice what the graphs captured (warm-up
  and capture) and the profiled launches equal captured x (replays + 1), and
  a new tenant gets a fresh slot; recovery ms, records and rows replayed,
  rows/s, the snapshot's bytes and write ms. M3: the card's final snapshot
  restores into a CPU engine, the CPU engine's snapshot and the ``T``
  record of an eviction after it restore on the card (leaves equal, the
  tenant gone), and ``MetricCollection.save``/``restore`` of the flagship
  collection gives equal states on the card and the CPU and an equal
  ``compute()`` on the card (the CPU's within rtol 1e-6). No new kernel: the
  ``kernels`` line keeps its rows.

The second-to-last line of output is a JSON object with one record per
kernel (``shapes`` lists every shape or route a kernel was timed at); the
last is ``{"ok": true, "device": {...}}``. Any failure raises, and the script
exits non-zero without those lines. Without a GPU it exits
non-zero at once. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores, taken for int32 ALU work
FLAGSHIP_STEPS = 20
TIMING_REPS = 5
SKETCH_BATCH = 2**22  # values per sketch update in Phases E and F
SKETCH_BATCHES = 8
HH_BATCH = 2**17  # ids per heavy-hitter update: the CPU recomputation walks them one at a time (plain version)
HH_BATCHES = 4  # fewer than SKETCH_BATCHES: the CPU recomputation walks 6 batches, about 45 us an item
WALK_SHAPES = (4096, HH_BATCH, SKETCH_BATCH)  # ids per ledger walk timed in Phase F
WALK_FIELDS = ("us_per_item", "device_ms_by_kernel", "raises", "evictions", "sequential_chunks", "chunks",
               "snapshot_items", "eviction_bound_ms", "snapshot_bound_ms", "table_bound_ms")
# Integer instructions per (id, row) of the count-min hash from ids (csrc/cm_hash.cuh) at a
# power-of-two width: the xor with the row seed, three shift-xor steps (2 each), two
# multiplies, the modulo (a mask) and the add into the table.
CM_HASH_OPS = 1 + 3 * 2 + 2 + 1 + 1
# The fewest dependent cycles one eviction of the ledger walk needs (csrc/cms_walk.cu): an
# eviction reads the ledger the one before it wrote, so the count compare
# (ISETP), the warp vote that finds the first slot at the minimum (VOTE) and the select that
# writes the slot follow one another: 3 dependent instructions, at least 4 cycles each (the
# shortest time from one instruction to a dependent one on the SM's pipes).
WALK_DECISION_CYCLES = 3 * 4
CURVE_N = 10**6  # scores per curve update in Phases G to I
CURVE_T = 200
CURVE_UPDATES = 8
CURVE_COLS = 10
EXACT_N = 2**20
ZIPF_IDS = 10**7
ZIPF_S = 1.1
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
SIX_N = 10**6  # labels per update of the six-metric collection (benchmarks/collections_vs_reference.py)
SIX_C = 100
SIX_UPDATES = 8  # timed updates after the one that forms the groups
AGG_N = 2**22  # values per aggregator update in Phase J3
# the compute groups the JAX package forms for the same collections on the CPU
FLAGSHIP_GROUPS = {0: ["accuracy", "f1"], 1: ["confmat"]}
SIX_GROUPS_BUILT = {0: ["acc"], 1: ["cm"], 2: ["f1"], 3: ["prec", "rec", "spec"]}
SIX_GROUPS = {0: ["acc", "f1", "prec", "rec", "spec"], 1: ["cm"]}
ROUTES = ("stat_scores", "pair_count")  # the two routes of csrc/pair_count.cu, as launch counts name them


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _pair_count_cases():
    """(name, N, rows, cols, label range, row / col dtype, ignore_index, masked, storage offset,
    high) of the Phase A table-route cases; ``high`` adds multiples of 2^31 to int64 labels."""
    i32, i64 = "int32", "int64"
    return [
        ("train_step", 1024, 1000, 1000, (0, 1000), i64, i64, None, False, 0, False),  # main path, global
        ("train_step_int32", 1024, 1000, 1000, (0, 1000), i32, i32, None, False, 0, False),
        ("six_metric_update", SIX_N, SIX_C, SIX_C, (0, SIX_C), i64, i64, None, False, 0, False),  # J2, shared
        ("six_metric_update_int32", SIX_N, SIX_C, SIX_C, (0, SIX_C), i32, i32, None, False, 0, False),
        ("shared_1M_ignore", 2**20, 100, 100, (-5, 105), i64, i64, 7, False, 0, False),
        ("ragged", 4097, 7, 23, (0, 23), i32, i32, None, False, 0, False),
        ("classes_2", 100003, 2, 2, (0, 2), i64, i64, None, False, 0, False),
        ("mixed_types", 65541, 50, 50, (-2, 52), i32, i64, 3, False, 0, False),
        ("masked", 65539, 50, 50, (0, 50), i32, i32, None, True, 0, False),
        ("masked_ignore_global", 9999, 1000, 1000, (-7, 1007), i64, i64, 5, True, 0, False),
        ("out_of_range", 10000, 20, 20, (-5, 25), i32, i32, None, False, 0, False),
        ("ignore_minus_one", 30001, 7, 7, (-3, 10), i64, i64, -1, False, 0, False),
        ("ignore_above", 30001, 7, 7, (-3, 10), i64, i64, 9, False, 0, False),
        ("int64_high_shared", 70001, 100, 100, (0, 100), i64, i64, 3, False, 0, True),
        ("int64_high_global", 70001, 1000, 1000, (0, 1000), i64, i64, 3, False, 0, True),
        ("offset_shared", 2**20 + 3, 100, 100, (0, 100), i64, i64, None, False, 1, False),
        ("offset_global", 4099, 1000, 1000, (0, 1000), i64, i32, 11, False, 3, False),
        # shared tables above 48 KB (opt-in dynamic shared memory): 200 x 200 is 160 KB,
        # 241 x 241 the largest square table a block holds on an H100 (227 KB)
        ("shared_200", 2**20, 200, 200, (-3, 203), i64, i64, 17, False, 0, False),
        ("shared_200_int32_masked", 400003, 200, 200, (0, 200), i32, i32, None, True, 0, False),
        ("shared_241_offset", 2**19 + 1, 241, 241, (0, 241), i64, i64, 5, False, 1, False),
        ("n_1", 1, 7, 7, (0, 7), i64, i64, None, False, 0, False),
        ("empty", 0, 5, 5, (0, 5), i32, i32, None, False, 0, False),
    ]


def _stat_score_cases():
    """(name, N, classes, label range, target / preds dtype, ignore_index, storage offset, high)
    of the Phase A stat-score cases."""
    i32, i64 = "int32", "int64"
    return [
        ("train_step", 1024, 1000, (0, 1000), i64, i64, None, 0, False),  # main path: argmax + target
        ("train_step_int32", 1024, 1000, (0, 1000), i32, i32, None, 0, False),
        ("six_metric_update", SIX_N, SIX_C, (0, SIX_C), i64, i64, None, 0, False),  # J2
        ("six_metric_update_int32", SIX_N, SIX_C, (0, SIX_C), i32, i32, None, 0, False),
        ("classes_2", 100003, 2, (0, 2), i64, i64, None, 0, False),
        ("classes_7_ignore", 4097, 7, (-2, 9), i64, i64, 3, 0, False),
        ("classes_100_ignore_minus_one", 70001, 100, (-3, 103), i64, i64, -1, 0, False),
        ("classes_100_ignore_above", 70001, 100, (-3, 103), i64, i64, 100, 0, False),
        ("mixed_types", 65541, 50, (0, 50), i32, i64, 7, 0, False),
        ("int64_high", 70001, 7, (0, 7), i64, i64, 3, 0, True),
        ("offset", 2**20 + 3, 100, (0, 100), i64, i64, 5, 1, False),
        ("offset_int32", 4099, 1000, (0, 1000), i32, i32, None, 3, False),
        # shared counters above 48 KB (opt-in dynamic shared memory): 96 KB at C = 8000, and the
        # largest C whose 3 * C counters a block holds on an H100 (227 KB)
        ("shared_8000", 2**20, 8000, (-2, 8002), i64, i64, 17, 0, False),
        ("shared_8000_int32_offset", 300001, 8000, (0, 8000), i32, i32, None, 3, False),
        ("shared_19370", 2**20, 19370, (0, 19370), i64, i64, None, 0, False),
        ("global_counters", 2**20, 20000, (0, 20000), i64, i64, 17, 0, False),  # 3 * C * 4 B > shared memory
        ("n_1", 1, 7, (0, 7), i64, i64, None, 0, False),
        ("empty", 0, 5, (0, 5), i64, i64, None, 0, False),
    ]


def _labels(torch, gen, n: int, lo: int, hi: int, dtype: str, offset: int = 0, high: bool = False, like=None):
    """n labels in [lo, hi) on the card, a view at ``offset`` into its storage; ``high`` adds
    0, 1, 2 or 3 times 2^31 (int64); ``like``: copy that many of them (a diagonal share)."""
    x = torch.randint(lo, hi, (n + offset,), generator=gen)
    if like is not None:
        x[offset:] = torch.where(torch.rand(n, generator=gen) < 0.3, like, x[offset:])
    if high:
        x = x + torch.randint(0, 4, (n + offset,), generator=gen) * 2**31
    return x.to(getattr(torch, dtype)).cuda()[offset:]


def phase_a(torch, confmat) -> dict:
    """Every case of both routes of csrc/pair_count.cu: kernel vs plain version on the same CUDA inputs."""
    gen = torch.Generator().manual_seed(1234)
    worst = {"pair_count": 0, "stat_scores": 0}

    def err(got, want) -> int:
        return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0

    for name, n, rows, cols, (lo, hi), rt, ct, ignore, masked, offset, high in _pair_count_cases():
        r = _labels(torch, gen, n, lo, hi, rt, offset, high)
        c = _labels(torch, gen, n, lo, hi, ct, offset, high)
        m = torch.randint(0, 2, (n,), generator=gen).bool().cuda() if masked else None
        shared = confmat.uses_shared_branch(rows, cols)
        want = confmat.pair_count_bincount(r, c, rows, cols, m, ignore)
        before = confmat.launches
        got = confmat.pair_count_cuda(r, c, rows, cols, m, ignore)
        torch.cuda.synchronize()
        _check(got.dtype == torch.int32 and got.shape == (rows, cols), f"{name}: {got.dtype} {tuple(got.shape)}")
        worst["pair_count"] = max(worst["pair_count"], err(got, want))
        _check(torch.equal(got, want), f"{name}: kernel differs from pair_count_bincount")
        _check(confmat.launches == before + (1 if n else 0), f"{name}: launch count")
        branch = "none (N = 0)" if n == 0 else ("shared" if shared else "global")
        aligned = r.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0
        print(f"phase A pair_count {name}: N={n} R={rows} C={cols} {rt}/{ct} ignore_index={ignore} mask={masked} "
              f"offset={offset} 16-byte loads={aligned} branch={branch} equal=True total={int(want.sum())}")
    _check(not confmat.uses_shared_branch(1000, 1000), "1000x1000 must take the global-atomic branch")
    _check(confmat.uses_shared_branch(100, 100), "100x100 must take the shared-memory branch")
    _check(confmat.uses_shared_branch(241, 241), "241x241 must take the shared-memory branch")

    for name, n, classes, (lo, hi), tt, pt, ignore, offset, high in _stat_score_cases():
        t = _labels(torch, gen, n, lo, hi, tt, offset, high)
        p = _labels(torch, gen, n, lo, hi, pt, offset, high, like=t.cpu().to(torch.int64))
        want = confmat.stat_scores_bincount(t, p, classes, ignore)
        before = confmat.stat_score_launches
        got = confmat.stat_scores_cuda(t, p, classes, ignore)
        torch.cuda.synchronize()
        for what, g, w in zip(("tp", "fp", "tn", "fn"), got, want):
            _check(g.dtype == torch.int32 and g.shape == (classes,), f"{name}.{what}: {g.dtype} {tuple(g.shape)}")
            worst["stat_scores"] = max(worst["stat_scores"], err(g, w))
            _check(torch.equal(g, w), f"{name}.{what}: kernel differs from stat_scores_bincount")
        _check(confmat.stat_score_launches == before + (1 if n else 0), f"{name}: launch count")
        branch = "none (N = 0)" if n == 0 else ("shared" if confmat.stat_scores_uses_shared(classes) else "global")
        n_valid = int(sum(x[0] for x in want))  # tp + fp + tn + fn of any class
        print(f"phase A stat_scores {name}: N={n} C={classes} {tt}/{pt} ignore_index={ignore} offset={offset} "
              f"branch={branch} equal=True tp={int(want[0].sum())} valid={n_valid}")
    _check(confmat.stat_scores_uses_shared(1000) and confmat.stat_scores_uses_shared(19370)
           and not confmat.stat_scores_uses_shared(20000), "stat-score branches")
    return worst


_ZIPF_CDF = {}


def _zipf(torch, n: int, gen, n_ids: int = ZIPF_IDS, s: float = ZIPF_S):
    """``n`` int32 ids in ``[0, n_ids)`` with P(id = k) proportional to (k + 1)^-s,
    drawn on the card by inverse CDF from the seeded generator ``gen``."""
    key = (n_ids, s)
    if key not in _ZIPF_CDF:
        cdf = torch.cumsum(torch.arange(1, n_ids + 1, device="cuda", dtype=torch.float64).pow(-s), 0)
        _ZIPF_CDF[key] = cdf / cdf[-1]
    u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    return torch.searchsorted(_ZIPF_CDF[key], u).clamp_(max=n_ids - 1).to(torch.int32)


def _scatter_values(torch, kind: str, n: int, gen):
    if kind == "01":
        return torch.randint(0, 2, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if kind == "rank":
        return torch.randint(1, 22, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if kind == "signed":
        return torch.randint(-3, 4, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if kind == "zero":
        return torch.zeros(n, dtype=torch.int32, device="cuda")
    choices = torch.tensor([INT32_MIN, INT32_MAX, -7, 0, 9], dtype=torch.int32, device="cuda")  # "extremes"
    return choices[torch.randint(0, 5, (n,), generator=gen, device="cuda")]


def _scatter_hist_cases():
    """(name, op, N, bins, index range or "zipf", values) of the Phase A scatter cases."""
    return [
        ("ddsketch_2048", "add", SKETCH_BATCH, 2048, (-3, 2051), "01"),  # Phase E's quantile shape, shared
        ("hll_p12", "max", SKETCH_BATCH, 2**12, (0, 2**12), "rank"),  # Phase E's p = 12, shared
        ("hll_p14_ragged", "max", 2**20 + 7, 2**14, (0, 2**14), "rank"),  # 64 KB: dynamic shared memory
        ("hll_p16", "max", SKETCH_BATCH, 2**16, (0, 2**16), "rank"),  # 256 KB: the packed branch
        ("add_ragged_global", "add", 4097, 2**16, (-5, 2**16 + 5), "01"),
        ("add_ragged_dynamic_shared", "add", 65537, 2**14, (-5, 2**14 + 5), "signed"),
        ("add_tiny", "add", 5, 2048, (0, 2048), "01"),
        ("max_tiny", "max", 5, 2**16, (0, 2**16), "rank"),
        ("add_empty", "add", 0, 2048, (0, 2048), "01"),
        ("max_empty", "max", 0, 2**16, (0, 2**16), "rank"),
        ("max_out_of_range_extremes", "max", 100000, 100, (-50, 150), "extremes"),
        ("max_extremes_global", "max", 2**20, 2**16, (-9, 2**16 + 9), "extremes"),
        ("add_zero_weights", "add", 2**20, 2**14, (0, 2**14), "zero"),
        ("add_signed_wraparound", "add", 2**20, 64, (0, 64), "signed"),
        ("add_zipf_shared", "add", SKETCH_BATCH, 2048, "zipf", "01"),
        ("max_zipf_global", "max", SKETCH_BATCH, 2**16, "zipf", "rank"),
        # views with a storage offset on the global branch, N % 4 != 0: idx and val at one
        # offset (16-byte loads after a scalar head) and at two (single loads)
        ("max_global_view_offset_1_1", "max", 2**20 + 3, 2**16, (-3, 2**16 + 3), "rank", (1, 1)),
        ("max_global_view_offset_1_2", "max", 2**20 + 5, 2**16, (0, 2**16), "extremes", (1, 2)),
        ("add_global_view_offset_3_3", "add", 2**20 + 1, 2**16, (-3, 2**16 + 3), "signed", (3, 3)),
        ("add_global_view_offset_0_1", "add", 2**20 + 2, 2**16, (0, 2**16), "01", (0, 1)),
        ("max_global_view_offset_tiny", "max", 3, 2**16, (0, 2**16), "rank", (2, 2)),
        ("max_global_view_offset_small_1_1", "max", 40003, 2**16, (-3, 2**16 + 3), "rank", (1, 1)),
        ("add_global_view_offset_small_1_2", "add", 40005, 2**16, (-3, 2**16 + 3), "signed", (1, 2)),
        # 2^17 slots, beyond one block's shared memory and hist_max's packed table: global atomics
        ("max_global_2p17_extremes", "max", 2**20 + 7, 2**17, (-5, 2**17 + 5), "extremes"),
        ("add_global_2p17_zipf", "add", 2**20, 2**17, "zipf", "signed"),
        # packed int16 slots of hist_max: values past int16 go straight to the output
        ("max_packed_extremes", "max", 2**20 + 1, 2**16, (-5, 2**16 + 5), "extremes"),
        # 2^19 slots, beyond 8 blocks' shared memory: global atomics
        ("max_global_2p19", "max", 2**20 + 1, 2**19, (-5, 2**19 + 5), "rank"),
        ("add_global_2p19", "add", 2**20 + 3, 2**19, (-5, 2**19 + 5), "signed"),
    ]


def _cms_cases():
    """(name, N, depth, width, columns) of the Phase A count-min cases."""
    return [
        ("cms_4x2048", SKETCH_BATCH, 4, 2048, "in"),  # Phase E's table, shared
        ("cms_4x65536_ragged", 2**20 + 3, 4, 65536, "in"),  # 1 MB: global atomics
        ("cms_out_of_range_ragged", 4097, 4, 2048, "out"),
        ("cms_tiny", 5, 4, 2048, "in"),
        ("cms_empty", 0, 4, 2048, "in"),
        ("cms_zipf_shared", SKETCH_BATCH, 4, 2048, "zipf"),
        ("cms_zipf_global", 2**20, 4, 65536, "zipf"),
    ]


def _cms_ids_cases():
    """(name, N, depth, width, ids, storage offset) of the Phase A cases of the ids route of
    cms_rows_add: the count-min shapes of ``_cms_cases``, then negative ids with the int32
    extremes, widths that are no power of two (the modulo, shared and global) and a view at a
    storage offset (a scalar head before the 16-byte loads)."""
    kinds = {"in": "uniform", "out": "negative", "zipf": "zipf"}
    cases = [(f"ids_{name[4:]}", n, depth, width, kinds[cols], 0) for name, n, depth, width, cols in _cms_cases()]
    return cases + [
        ("ids_negative_extremes", 2**20 + 1, 4, 2048, "negative", 0),
        ("ids_width_2047_zipf", SKETCH_BATCH, 4, 2047, "zipf", 0),
        ("ids_width_100003_global", 2**20 + 3, 4, 100003, "zipf", 0),
        ("ids_depth_7_width_1", 4099, 7, 1, "uniform", 0),
        ("ids_view_offset_3", 2**20 + 5, 4, 2048, "zipf", 3),
    ]


def _ids(torch, kind: str, n: int, gen):
    """``n`` int32 ids on the card: Zipf over ZIPF_IDS, uniform over ZIPF_IDS, uniform over 64
    (``few``), one id (``one``), or uniform with 30% negative and the int32 extremes mixed in
    (``negative``)."""
    if kind == "zipf":
        return _zipf(torch, n, gen)
    if kind == "one":
        return torch.full((n,), 12345, dtype=torch.int32, device="cuda")
    ids = torch.randint(0, 64 if kind == "few" else ZIPF_IDS, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if kind == "negative":
        ids = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.3, -ids - 1, ids)
        ids[::1009] = INT32_MIN
        ids[1::1009] = INT32_MAX
    return ids


def phase_a_cms_ids(torch, scatter) -> int:
    """The ids route of cms_rows_add against its plain version on the same CUDA inputs."""
    gen = torch.Generator(device="cuda").manual_seed(8642)
    worst = 0
    for name, n, depth, width, kind, offset in _cms_ids_cases():
        ids = _ids(torch, kind, n + offset, gen)[offset:]
        _check(ids.storage_offset() == offset, f"{name}: view")
        counts = torch.randint(0, 9, (depth, width), generator=gen, device="cuda", dtype=torch.int32)
        before = counts.clone()
        launched = scatter.launches["cms_rows_add"]
        got = scatter.cms_ids_add_cuda(counts, ids)
        torch.cuda.synchronize()
        want = scatter.cms_ids_add_reference(counts, ids)
        _check(got.dtype == torch.int32 and got.shape == want.shape, f"{name}: {got.dtype} {tuple(got.shape)}")
        _check(torch.equal(got, want), f"{name}: the ids route of cms_rows_add differs from its plain version")
        _check(torch.equal(counts, before), f"{name}: the input table was written")
        _check(scatter.launches["cms_rows_add"] == launched + (1 if n else 0), f"{name}: launch count")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, err)
        branch = "none (N = 0)" if n == 0 else scatter.cms_ids_branch(depth, width)
        print(f"phase A {name}: kernel=cms_rows_add (ids route) N={n} table=({depth}, {width}) ids={kind} "
              f"offset={offset} branch={branch} equal=True max_abs_err={err} added={int((got - before).sum())}")
    return worst


def _walk_cases():
    """(name, N, depth, width, k, ids, starting ledger) of the Phase A cases of the ledger walk;
    ids "crafted" and "sweep" are built by ``_crafted_walk`` and ``_sweep_walk``."""
    return [
        ("walk_zipf_2p14", 2**14, 4, 2048, 32, "zipf", "empty"),  # the heavy-hitter sketch's defaults
        ("walk_uniform", 4096, 4, 2048, 32, "uniform", "empty"),
        ("walk_all_one_id", 4096, 4, 2048, 32, "one", "empty"),
        ("walk_negative_ids", 4096, 4, 2048, 32, "negative", "empty"),
        ("walk_ties_at_the_minimum", 4096, 4, 2048, 8, "few", "ties"),
        ("walk_nonempty_ledger", 4096, 4, 2048, 32, "few", "held"),
        ("walk_k1", 4096, 4, 2048, 1, "zipf", "empty"),
        ("walk_k8", 4096, 4, 2048, 8, "zipf", "empty"),
        ("walk_k33_shared_ledger", 4096, 4, 2048, 33, "zipf", "empty"),
        ("walk_k100_shared_ledger", 4096, 4, 2048, 100, "zipf", "held"),
        ("walk_global_table", 4096, 4, 65536, 32, "zipf", "empty"),  # 1 MB: histograms in global memory
        ("walk_width_2047", 4096, 4, 2047, 32, "few", "held"),
        ("walk_global_ledger", 1024, 4, 2048, 40000, "zipf", "held"),  # 320 KB of ledger: global memory
        ("walk_ragged_small_table", 1001, 3, 64, 32, "zipf", "empty"),
        *((f"walk_{name}", 4096, 4, 2048, 32, "crafted", name) for name in WALK_CRAFTED),
        *((f"walk_sweep_k{k}_w{w}_s{s}", 4096, 3 + s, w, k, "sweep", "sweep")
          for k in (1, 8, 32, 33) for w in (7, 2048) for s in (0, 1)),
    ]


WALK_CRAFTED = ("candidate_at_lane_0", "candidate_at_lane_31", "raise_at_the_minimum_before_a_candidate",
                "held_no_ops", "duplicate_and_negative_keys", "wrap_near_2p31")


def _crafted_walk(torch, scatter, name: str, n: int):
    """(counts, ledger, ids) as numpy arrays, built around chunks of 32 on a 4 x 2048 table and a
    k = 32 ledger: a candidate (an id not held, its estimate above every count) at lane 0 or 31
    of chunks 2 and 5 among raises that lift counts; a raise of the slot at the minimum (slot 3)
    at lane 4 of chunk 1 before a candidate at lane 9, which must take slot 7; held keys above
    every estimate; duplicate and negative keys; a table and counts that wrap near 2^31."""
    import numpy as np

    rng = np.random.default_rng(sum(map(ord, name)))
    held = np.arange(5000, 5032, dtype=np.int32)
    new, new2 = 777777, 888888

    def set_cells(counts, ids, value):
        cols = scatter.ids_route_columns(torch.from_numpy(np.asarray(ids, np.int32)), 4, 2048).numpy()
        counts[np.arange(4)[None, :], cols] = value

    counts = np.full((4, 2048), 3, np.int32)
    ledger = np.stack([held, 40 + np.arange(32, dtype=np.int32)], axis=1)
    set_cells(counts, held, 25)
    ids = rng.integers(10**6, 10**6 + 10**5, n).astype(np.int32)  # estimates ~4: no-ops
    if name.startswith("candidate_at_lane"):
        set_cells(counts, [new, new2], 100)
        set_cells(counts, held[:8], 60)
        ids = rng.choice(held[:12], n).astype(np.int32)
        lane = 0 if name.endswith("_0") else 31
        ids[2 * 32 + lane], ids[5 * 32 + lane] = new, new2
    elif name == "raise_at_the_minimum_before_a_candidate":
        ledger[3, 1], ledger[7, 1] = 10, 20
        set_cells(counts, held[3:4], 29)
        set_cells(counts, [new], 100)
        ids[32 + 4], ids[32 + 9] = held[3], new
    elif name == "held_no_ops":
        ledger[:, 1] = 10**6
        ids = rng.choice(np.r_[held, ids[:32]], n).astype(np.int32)
    elif name == "duplicate_and_negative_keys":
        ledger = np.stack([np.full(32, -1, np.int32), np.zeros(32, np.int32)], axis=1)
        ledger[:9] = np.array([[5, 4], [5, 9], [-1, 0], [-7, 3], [9, 1], [5, 2], [INT32_MIN, 5], [12, 0], [9, 7]])
        counts = rng.integers(0, 3, (4, 2048)).astype(np.int32)
        ids = rng.choice(np.array([5, 9, 12, -1, -7, INT32_MIN, 40, 41, 42, 43], np.int32), n)
    elif name == "wrap_near_2p31":
        counts = np.full((4, 2048), INT32_MAX - 40, np.int32)
        ledger = np.stack([np.full(32, -1, np.int32), np.zeros(32, np.int32)], axis=1)
        ledger[:2] = np.array([[3, INT32_MAX], [4, INT32_MAX - 30]])
        ids = (rng.zipf(1.3, n) % 50).astype(np.int32)
    return counts, ledger, ids


def _sweep_walk(name: str, n: int, depth: int, width: int, k: int):
    """(counts, ledger, ids) as numpy arrays: a random start ledger (stream keys, duplicates,
    counts 0-20), a random table, Zipf ids with 10% negative."""
    import numpy as np

    rng = np.random.default_rng(sum(map(ord, name)))
    ids = (rng.zipf(1.2, n) % 200).astype(np.int32)
    ids[rng.random(n) < 0.1] = -2
    m = int(rng.integers(0, k + 1))
    ledger = np.stack([np.full(k, -1, np.int32), np.zeros(k, np.int32)], axis=1)
    ledger[:m, 0], ledger[:m, 1] = rng.choice(ids, m), rng.integers(0, 21, m)
    return rng.integers(0, 6, (depth, width)).astype(np.int32), ledger, ids


def _start_ledger(torch, kind: str, k: int, ids, gen):
    """A (k, 2) int32 ledger on the card: empty, every count 3 (``ties``), or (``held``) some of
    the stream's ids with counts from 0 to 49, one of them twice, and a negative key."""
    keys = torch.full((k,), -1, dtype=torch.int32, device="cuda")
    cnts = torch.zeros(k, dtype=torch.int32, device="cuda")
    if kind == "ties":
        keys = torch.arange(10**6, 10**6 + k, dtype=torch.int32, device="cuda")
        cnts.fill_(3)
    elif kind == "held":
        m = max(1, min(k // 2, ids.numel()))
        keys[:m] = ids[:m]
        cnts[:m] = torch.randint(0, 50, (m,), generator=gen, device="cuda", dtype=torch.int32)
        if k > 2:
            keys[m] = keys[0]
            keys[-1] = -7
            cnts[-1] = 2
    return torch.stack([keys, cnts], dim=1)


def _walk_inputs(torch, scatter, case, gen):
    name, n, depth, width, k, kind, start = case
    if kind in ("crafted", "sweep"):
        arrays = _crafted_walk(torch, scatter, start, n) if kind == "crafted" else _sweep_walk(name, n, depth, width, k)
        return tuple(torch.from_numpy(a).cuda() for a in arrays)
    ids = _ids(torch, kind, n, gen)
    counts = torch.randint(0, 3, (depth, width), generator=gen, device="cuda", dtype=torch.int32)
    return counts, _start_ledger(torch, start, k, ids, gen), ids


def phase_a_walk(torch, scatter, cms_walk) -> int:
    """The ledger walk's kernels against the plain walk on the same CUDA inputs, and their
    counters against the numpy mirror's."""
    gen = torch.Generator(device="cuda").manual_seed(5150)
    worst = 0
    for case in _walk_cases():
        name, n, depth, width, k, kind, start = case
        counts, ledger, ids = _walk_inputs(torch, scatter, case, gen)
        before_counts, before_ledger = counts.clone(), ledger.clone()
        counters = torch.zeros(3, dtype=torch.int64, device="cuda")
        launched = cms_walk.launches
        got = cms_walk.cms_walk_cuda(counts, ledger, ids, counters)
        torch.cuda.synchronize()
        _check(cms_walk.launches == launched + cms_walk.KERNELS, f"{name}: launch count")
        want = cms_walk.cms_walk_reference(counts, ledger, ids)
        for g, w, what in zip(got, want, ("table", "ledger")):
            _check(g.dtype == torch.int32 and g.shape == w.shape, f"{name} {what}: {g.dtype} {tuple(g.shape)}")
            _check(torch.equal(g, w), f"{name}: the walk kernel's {what} differs from the plain walk")
        _check(torch.equal(counts, before_counts) and torch.equal(ledger, before_ledger), f"{name}: inputs written")
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in zip(got, want))
        worst = max(worst, err)
        m_counts, m_ledger, mirror = cms_walk.walk_in_chunks(counts.cpu(), ledger.cpu(), ids.cpu())
        _check(torch.equal(m_counts, want[0].cpu()) and torch.equal(m_ledger, want[1].cpu()), f"{name}: mirror")
        if start == "raise_at_the_minimum_before_a_candidate":  # the raise lifted slot 3 first
            _check(int(want[1][7, 0]) == 777777 and int(want[1][3, 0]) == 5003, f"{name}: not the case it names")
        kernel = tuple(counters.tolist())
        _check(kernel == tuple(mirror[:3]), f"{name}: kernel counters {kernel}, mirror {tuple(mirror[:3])}")
        print(f"phase A {name}: kernel=cms_walk N={n} table=({depth}, {width}) k={k} ids={kind} ledger={start} "
              f"placement=({cms_walk.placement(depth, width, k)}) equal=True max_abs_err={err} "
              f"raises={kernel[0]} evictions={kernel[1]} (mirror {mirror.evictions}) sequential_chunks={kernel[2]} "
              f"of {-(-n // cms_walk.CHUNK)}; top ledger count {int(got[1][:, 1].max())}")
    return worst


def phase_a_scatter(torch, scatter) -> dict:
    """Every scatter case: kernel vs plain version on the same CUDA inputs."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    worst = {"hist_add": 0, "hist_max": 0, "cms_rows_add": 0}

    def held(kernel, name, got, want, before, table, n, branch, launched):
        torch.cuda.synchronize()
        _check(got.dtype == torch.int32 and got.shape == want.shape, f"{name}: {got.dtype} {tuple(got.shape)}")
        _check(torch.equal(got, want), f"{name}: {kernel} kernel differs from its plain version")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst[kernel] = max(worst[kernel], err)
        _check(torch.equal(table, before), f"{name}: the input table was written")
        _check(scatter.launches[kernel] == launched + (1 if n else 0), f"{name}: launch count")
        branch = "none (N = 0)" if n == 0 else branch
        print(f"phase A {name}: kernel={kernel} N={n} table={tuple(table.shape)} branch={branch} "
              f"equal=True max_abs_err={err}")

    for name, op, n, n_bins, index, values, *offsets in _scatter_hist_cases():
        kernel = f"hist_{op}"
        off_i, off_v = offsets[0] if offsets else (0, 0)
        if index == "zipf":
            idx = _zipf(torch, n + off_i, gen, n_ids=n_bins)[off_i:]
        else:
            idx = torch.randint(index[0], index[1], (n + off_i,), generator=gen, device="cuda", dtype=torch.int32)
            idx = idx[off_i:]
        vals = _scatter_values(torch, values, n + off_v, gen)[off_v:]
        _check(idx.storage_offset() == off_i and vals.storage_offset() == off_v, f"{name}: views")
        if name == "add_signed_wraparound":
            bins = torch.full((n_bins,), INT32_MAX - 2, dtype=torch.int32, device="cuda")
        elif op == "add":
            bins = torch.randint(0, 50, (n_bins,), generator=gen, device="cuda", dtype=torch.int32)
        else:
            bins = torch.randint(0, 8, (n_bins,), generator=gen, device="cuda", dtype=torch.int32)
            bins[:2] = torch.tensor([INT32_MIN, INT32_MAX], dtype=torch.int32)
        before = bins.clone()
        launched = scatter.launches[kernel]
        wrapper, plain = ((scatter.hist_add_cuda, scatter.hist_add_reference) if op == "add"
                          else (scatter.hist_max_cuda, scatter.hist_max_reference))
        got = wrapper(bins, idx, vals)
        want = plain(bins, idx, vals)
        branch = scatter.hist_branch(kernel, n, n_bins)
        if off_i or off_v:
            branch += f" (views at storage offsets {off_i}, {off_v})"
        held(kernel, name, got, want, before, bins, n, branch, launched)

    for name, n, depth, width, columns in _cms_cases():
        if columns == "zipf":
            cols = _zipf(torch, n * depth, gen, n_ids=width).reshape(n, depth)
        else:
            lo, hi = (0, width) if columns == "in" else (-3, width + 3)
            cols = torch.randint(lo, hi, (n, depth), generator=gen, device="cuda", dtype=torch.int32)
        valid = torch.randint(0, 2, (n,), generator=gen, device="cuda").bool()
        counts = torch.randint(0, 9, (depth, width), generator=gen, device="cuda", dtype=torch.int32)
        before = counts.clone()
        launched = scatter.launches["cms_rows_add"]
        got = scatter.cms_rows_add_cuda(counts, cols, valid)
        want = scatter.cms_rows_add_reference(counts, cols, valid)
        branch = "shared" if scatter.uses_shared_branch(depth * width) else "global"
        held("cms_rows_add", name, got, want, before, counts, n, branch, launched)

    for cells, shared in ((2048, True), (2**12, True), (2**14, True), (2**16, False), (4 * 2048, True),
                          (4 * 65536, False)):
        _check(scatter.uses_shared_branch(cells) == shared, f"a table of {cells} int32 must take the "
               f"{'shared-memory' if shared else 'global-atomic'} branch")
    return worst


def phase_b(torch, confmat, entry_mod):
    """The main path: the fused step at full width, counted and verified."""
    step, (params, states, x, y) = entry_mod.entry(device="cuda", seed=0)
    metrics = step.metrics
    cfg = entry_mod.FULL_CONFIG
    print(f"phase B config: {json.dumps(cfg)} steps={FLAGSHIP_STEPS} (+1 warm-up)")

    # Record the predictions each step hands its metrics, to recompute the
    # states on the CPU afterwards. All three metrics get the same preds.
    seen = []
    spied = metrics["accuracy"]
    update_state = spied.update_state

    def recording_update_state(state, preds, target):
        seen.append((preds.cpu(), target.cpu()))
        return update_state(state, preds, target)

    spied.update_state = recording_update_state

    confmat.launches = confmat.stat_score_launches = 0  # the main path's run starts here
    t0 = time.perf_counter()
    losses = []
    for _ in range(FLAGSHIP_STEPS + 1):
        loss, params, states = step(params, states, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"stat_scores": confmat.stat_score_launches, "pair_count": confmat.launches}  # ... and ends here
    del spied.update_state
    n_steps = FLAGSHIP_STEPS + 1
    print(f"phase B ran {n_steps} steps in {wall:.3f} s; launches {launches}")
    # accuracy and F1 take the stat-score route, the confusion matrix the table route
    _check(launches == {"stat_scores": 2 * n_steps, "pair_count": n_steps},
           f"expected {2 * n_steps} stat-score and {n_steps} table launches, got {launches}")
    losses = torch.stack(losses).cpu()
    _check(bool(torch.isfinite(losses).all()), f"non-finite loss {losses.tolist()}")
    _check(len(seen) == n_steps, "recorded predictions")

    # CPU recomputation through the plain path (bincount pair count)
    cpu_metrics = entry_mod.make_metrics(cfg["classes"], "cpu")
    cpu_states = {name: m.init_state() for name, m in cpu_metrics.items()}
    for preds, target in seen:
        cpu_states = {name: m.update_state(cpu_states[name], preds, target) for name, m in cpu_metrics.items()}
    values = {}
    for name, m in metrics.items():
        for key, want in cpu_states[name].items():
            got = states[name][key].cpu()
            _check(got.dtype == want.dtype == torch.int32, f"{name}.{key} dtype {got.dtype} vs {want.dtype}")
            _check(torch.equal(got, want), f"{name}.{key} differs from the CPU recomputation")
        got_v = m.compute_from(states[name]).cpu()
        want_v = cpu_metrics[name].compute_from(cpu_states[name])
        _check(bool(torch.isfinite(got_v.float()).all()), f"{name} value not finite")
        if name == "f1":  # a float mean over 1000 classes: the card sums in another order
            _check(torch.allclose(got_v, want_v, rtol=1e-6, atol=0), f"f1 {got_v} vs {want_v}")
        else:
            _check(torch.equal(got_v, want_v), f"{name} value {got_v} vs {want_v}")
        values[name] = float(got_v) if got_v.numel() == 1 else int(got_v.sum())
    print(f"phase B states bit-identical to the CPU recomputation; loss first/last "
          f"{float(losses[0]):.6f}/{float(losses[-1]):.6f}; accuracy={values['accuracy']:.6f} "
          f"f1={values['f1']:.6f} confmat total={values['confmat']}")

    # the stateful path, once, on the card and on the CPU
    preds, target = seen[-1]
    for name in metrics:
        results = []
        for device in ("cuda", "cpu"):
            metric = entry_mod.make_metrics(cfg["classes"], device)[name]
            p, t = preds.to(device), target.to(device)
            metric.update(p, t)
            batch_value = metric.forward(p, t)
            total = metric.compute()
            metric.reset()
            _check(metric.update_count == 0 and not metric.update_called, f"reset of {name} on {device}")
            results.append((batch_value.cpu().float(), total.cpu().float()))
        (card_batch, card_total), (host_batch, host_total) = results
        _check(torch.allclose(card_batch, host_batch, rtol=1e-6, atol=0), f"stateful forward of {name}")
        _check(torch.allclose(card_total, host_total, rtol=1e-6, atol=0), f"stateful compute of {name}")
    print("phase B stateful update/forward/compute/reset on the card agree with the CPU")
    return launches, (params, states, x, y), step


def phase_c_steps(torch, entry_mod, step, args):
    """Bare vs fused step time, interleaved repetitions, minimum of each."""
    params, states, x, y = args
    bare, fused = [], []

    def run_bare():
        nonlocal params
        params, _, _ = entry_mod.sgd_step(params, x, y)

    def run_fused():
        nonlocal params, states
        _, params, states = step(params, states, x, y)

    for _ in range(TIMING_REPS):
        bare.append(_time_ms(run_bare, FLAGSHIP_STEPS, warmup=1))
        fused.append(_time_ms(run_fused, FLAGSHIP_STEPS, warmup=1))
    t_bare, t_fused = min(bare), min(fused)
    overhead = (t_fused - t_bare) / t_bare * 100.0
    print(f"phase C step: bare_ms={t_bare} fused_ms={t_fused} overhead_pct={overhead} "
          f"(min of {TIMING_REPS} reps x {FLAGSHIP_STEPS} steps; bare reps {bare}; fused reps {fused})")
    return {"bare_ms": t_bare, "fused_ms": t_fused, "overhead_pct": overhead}


def _bound(nbytes: int, ops: int, ops_per_s: float = CUDA_CORE_OPS_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes over the memory rate and the operations
    over ``ops_per_s``."""
    return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), (ops / ops_per_s * 1e3, "operations"))


def phase_c_kernel(torch, confmat, n: int, classes: int) -> dict:
    """Both routes of csrc/pair_count.cu at one shape, on int64 labels as the main path hands
    them over: call time, device time, plain version, torch.bincount of the pair keys (the
    library call), bound."""
    gen = torch.Generator().manual_seed(99)
    t = torch.randint(0, classes, (n,), generator=gen).cuda()
    p = torch.randint(0, classes, (n,), generator=gen).cuda()
    key = t * classes + p
    iters = 200
    library_ms = _time_ms(lambda: torch.bincount(key, minlength=classes * classes + 1), iters)
    recs = {}
    routes = {
        # two int64 label streams read, the int32 table written; per pair two range compares, a key, an add
        "pair_count": (lambda: confmat.pair_count_cuda(t, p, classes, classes),
                       lambda: confmat.pair_count_bincount(t, p, classes, classes),
                       "pair_count_", 16 * n + 4 * classes * classes, 4 * n),
        # two int64 label streams read, four int32 (C,) counts written; per pair two range compares,
        # the hit compare, one or two adds
        "stat_scores": (lambda: confmat.stat_scores_cuda(t, p, classes),
                        lambda: confmat.stat_scores_bincount(t, p, classes),
                        "stat_scores_kernel", 16 * n + 16 * classes, 4 * n),
    }
    for route, (run, plain, match, nbytes, ops) in routes.items():
        bound_ms, bound_by = _bound(nbytes, ops)
        recs[route] = rec = {
            "n": n, "rows": classes, "cols": classes, "label_dtype": "int64", "ms": _time_ms(run, iters),
            "device_ms": _per_call_ms(_call_kernels(torch, run, match, 1)),
            "plain_ms": _time_ms(plain, iters), "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops}
        print(f"phase C {route} {json.dumps(rec)}")
    return recs


def _per_call_ms(kernels: dict):
    """Device ms of one wrapper call from ``{kernel name: [µs of each recorded
    launch]}``: every kernel a call launches runs once per call, and the
    profiler may miss the first launches of a window, so each kernel counts
    its mean over the launches it recorded."""
    return sum(sum(v) / len(v) for v in kernels.values()) / 1e3 if kernels else None


def _call_kernels(torch, run, match: str, per_call: int, calls: int = 20, tries: int = 3) -> dict:
    """``{kernel name: [µs of each recorded launch]}`` of the ``per_call`` kernels
    (names holding ``match``) that one call of ``run`` launches, over ``calls``
    calls under the profiler. The profiler sometimes records few or none of a
    window's launches, so a window that lacks a kernel or holds fewer than half
    of its launches is profiled again, up to ``tries`` times; ``{}`` (not
    measured) if none is whole."""
    for _ in range(tries):
        kernels, _ = _profile_steps(torch, run, calls)
        mine = {name: v for name, v in kernels.items() if match in name}
        if len(mine) == per_call and all(2 * len(v) >= calls for v in mine.values()):
            return mine
    return {}


def _kernel_times(prof, torch):
    """``{kernel name: [device µs of each launch]}`` from a profile."""
    out = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out.setdefault(evt.name, []).append(evt.time_range.elapsed_us())
    return out


def _profile_steps(torch, run, iters: int):
    """``(kernel times, wall µs)`` of ``iters`` calls of ``run`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _kernel_times(prof, torch), wall_us


def phase_d_profile(torch, entry_mod, step, args, iters: int = 5):
    """Device time by kernel: the bare step, the fused step, then its metric updates alone."""
    params, states, x, y = args

    def run_bare():
        nonlocal params
        params, _, _ = entry_mod.sgd_step(params, x, y)

    def run_fused():
        nonlocal params, states
        _, params, states = step(params, states, x, y)

    bare_kernels, bare_wall_us = _profile_steps(torch, run_bare, iters)
    step_kernels, wall_us = _profile_steps(torch, run_fused, iters)
    if not step_kernels:
        print("phase D: the profiler recorded no device time: not measured")
        return None
    bare_busy_us = sum(sum(v) for v in bare_kernels.values())
    busy_us = sum(sum(v) for v in step_kernels.values())

    logits = entry_mod.forward(params, x, y)[1]

    def run_metrics():
        nonlocal states
        preds = torch.argmax(logits, dim=-1)
        states = {name: m.update_state(states[name], preds, y) for name, m in step.metrics.items()}

    metric_kernels, _ = _profile_steps(torch, run_metrics, iters)
    pair = [us for name, v in metric_kernels.items() if "pair_count_" in name for us in v]
    stat = [us for name, v in metric_kernels.items() if "stat_scores_kernel" in name for us in v]
    top = sorted(metric_kernels.items(), key=lambda kv: -sum(kv[1]))[:12]
    # the stat-score route replaced the int64 sums of the (C, C) table and the casts around them
    long_sums = [name for name in metric_kernels if "ReduceOp<long" in name]
    _check(not long_sums, f"int64 reductions left in the metric updates: {long_sums}")
    rec = {
        "bare_step_device_busy_us": bare_busy_us / iters,
        "bare_step_wall_us_under_profiler": bare_wall_us / iters,
        "bare_step_idle_share": 1.0 - bare_busy_us / bare_wall_us,
        "step_device_busy_us": busy_us / iters,
        "step_wall_us_under_profiler": wall_us / iters,
        "step_idle_share": 1.0 - busy_us / wall_us,
        "metric_device_us_per_step": sum(sum(v) for v in metric_kernels.values()) / iters,
        "metric_kernel_launches_per_step": sum(len(v) for v in metric_kernels.values()) / iters,
        "pair_count_device_us_per_launch": sum(pair) / len(pair) if pair else None,
        "pair_count_launches_profiled": len(pair),
        "stat_scores_device_us_per_launch": sum(stat) / len(stat) if stat else None,
        "stat_scores_launches_profiled": len(stat),
        "metric_top_kernels": [
            {"name": name[:90], "launches_per_step": len(v) / iters, "us_per_step": sum(v) / iters} for name, v in top
        ],
        "step_top_kernels": [
            {"name": name[:90], "launches_per_step": len(v) / iters, "us_per_step": sum(v) / iters}
            for name, v in sorted(step_kernels.items(), key=lambda kv: -sum(kv[1]))[:8]
        ],
    }
    print(f"phase D profile {json.dumps(rec)}")
    return rec


ENTRY_OF = {"hist_add": "ddsketch_hist_add", "hist_max": "hll_scatter_max", "cms_rows_add": "cms_row_scatter"}


def _zero_launches(scatter, cms_walk) -> None:
    for k in scatter.launches:
        scatter.launches[k] = 0
    cms_walk.launches = 0


def _launch_counts(scatter, cms_walk) -> dict:
    return {**scatter.launches, "cms_walk": cms_walk.launches}


def _latencies(torch, gen, n: int):
    """Lognormal latencies with 1% exact zeros, 2% negated, and NaN, +inf and
    -inf every million values."""
    v = torch.empty(n, device="cuda").log_normal_(1.0, 1.5, generator=gen)
    u = torch.rand(n, device="cuda", generator=gen)
    v = torch.where(u < 0.01, 0.0, torch.where(u < 0.03, -v, v))
    v[::1_000_003] = math.nan
    v[1::1_000_003] = math.inf
    v[2::1_000_003] = -math.inf
    return v


def _equal_states(torch, a: dict, b: dict, what: str) -> None:
    for key in a:
        x, y = torch.as_tensor(a[key]).cpu(), torch.as_tensor(b[key]).cpu()
        _check(x.dtype == y.dtype and torch.equal(x, y), f"{what}: state {key!r} differs")


def _fold(init, update, batches):
    state = init()
    for b in batches:
        state = update(state, b)
    return state


def phase_e(torch, scatter, cms_walk, obs, instrument):
    """The sketch plane at the JAX classes' default sizes, counted and verified."""
    from metrics_tpu_torch.sketch import CardinalitySketch, HeavyHittersSketch, QuantileSketch
    from metrics_tpu_torch.sketch import kernels as sk

    gen = torch.Generator(device="cuda").manual_seed(2024)
    lat = [_latencies(torch, gen, SKETCH_BATCH) for _ in range(SKETCH_BATCHES)]
    ids = [_zipf(torch, SKETCH_BATCH, gen) for _ in range(SKETCH_BATCHES)]
    hh_ids = [_zipf(torch, HH_BATCH, gen) for _ in range(HH_BATCHES)]
    torch.cuda.synchronize()
    print(f"phase E data: {SKETCH_BATCHES} batches of {SKETCH_BATCH} lognormal latencies (1% zeros, 2% negative, "
          f"NaN/+inf/-inf) and of Zipf({ZIPF_S}) int32 ids over {ZIPF_IDS}; heavy hitters {HH_BATCHES} x {HH_BATCH} ids")

    def table_zeros():
        return torch.zeros((4, 2048), dtype=torch.int32, device="cuda")

    q = QuantileSketch(alpha=0.01, n_buckets=2048, device="cuda")
    c12, c16 = CardinalitySketch(p=12, device="cuda"), CardinalitySketch(p=16, device="cuda")
    hh = HeavyHittersSketch(k=32, depth=4, width=2048, device="cuda")
    # name: (init, update, merge, batches, launches per update, registry dispatches per update);
    # the count-min table takes the ids route of cms_rows_add and the heavy hitters the walk
    # kernel, neither through the registry
    paths = {
        "quantile": (q.init_state, q.update_state, q.merge_states, lat, {"hist_add": 2}, {"ddsketch_hist_add": 2}),
        "cardinality_p12": (c12.init_state, c12.update_state, c12.merge_states, ids, {"hist_max": 1},
                            {"hll_scatter_max": 1}),
        "cardinality_p16": (c16.init_state, c16.update_state, c16.merge_states, ids, {"hist_max": 1},
                            {"hll_scatter_max": 1}),
        "count_min_4x2048": (table_zeros, sk.cms_table_update, lambda a, b: a + b, ids, {"cms_rows_add": 1}, {}),
        "heavy_hitters": (hh.init_state, hh.update_state, hh.merge_states, hh_ids, {"cms_walk": cms_walk.KERNELS},
                          {}),
    }
    states, launches, walls = {}, {k: 0 for k in _launch_counts(scatter, cms_walk)}, {}
    obs.enable()
    try:
        for name, (init, update, merge, batches, per_update, per_dispatch) in paths.items():
            instrument.KERNEL_DISPATCHES.clear()
            _zero_launches(scatter, cms_walk)  # the main path's run starts here ...
            half = len(batches) // 2
            t0 = time.perf_counter()
            first = _fold(init, update, batches[:half])
            single = first
            for b in batches[half:]:
                single = update(single, b)
            second = _fold(init, update, batches[half:])
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            counted = _launch_counts(scatter, cms_walk)  # ... and ends here
            n_updates = len(batches) + half
            want = {k: per_update.get(k, 0) * n_updates for k in counted}
            _check(counted == want, f"{name}: launches {counted}, expected {want}")
            for entry in ENTRY_OF.values():
                ref = instrument.KERNEL_DISPATCHES.value(kernel=entry, impl="reference")
                opt = instrument.KERNEL_DISPATCHES.value(kernel=entry, impl="optimized")
                expected = per_dispatch.get(entry, 0) * n_updates
                _check(ref == 0, f"{name}: {ref} reference dispatches of {entry} on a CUDA tensor")
                _check(opt == expected, f"{name}: {opt} kernel dispatches of {entry}, expected {expected}")
            for k in launches:
                launches[k] += counted[k]
            states[name] = (first, second, single, merge(first, second))
            print(f"phase E {name}: {n_updates} updates in {walls[name]:.3f} s; launches {counted} "
                  f"({', '.join(f'{v // n_updates} {k}' for k, v in counted.items() if v) or 'no kernel'} per update); "
                  "no reference dispatch")
    finally:
        obs.disable()

    cpu = {"lat": [b.cpu() for b in lat], "ids": [b.cpu() for b in ids], "hh": [b.cpu() for b in hh_ids]}

    # --- quantile sketch
    first, second, single, merged = states["quantile"]
    _equal_states(torch, single, merged, "quantile merge of two half-streams")
    _, log_gamma, offset = sk.ddsketch_params(0.01)
    own = [torch.zeros(2048, dtype=torch.int32, device="cuda") for _ in range(2)]
    moved = 0
    for b, b_cpu in zip(lat, cpu["lat"]):
        idx = sk.ddsketch_buckets(b, 2048, log_gamma=log_gamma, offset=offset)
        own[0] = scatter.hist_add_reference(own[0], idx, (b > 0).to(torch.int32))
        own[1] = scatter.hist_add_reference(own[1], idx, (b < 0).to(torch.int32))
        idx_cpu = sk.ddsketch_buckets(b_cpu, 2048, log_gamma=log_gamma, offset=offset)
        moved += int(((idx.cpu() != idx_cpu) & (b_cpu != 0) & torch.isfinite(b_cpu)).sum())
    _check(torch.equal(single["pos_buckets"], own[0]) and torch.equal(single["neg_buckets"], own[1]),
           "quantile buckets differ from the plain scatter fed the card's own bucket indices")
    q_cpu = QuantileSketch(alpha=0.01, n_buckets=2048, device="cpu")
    s_cpu = _fold(q_cpu.init_state, q_cpu.update_state, cpu["lat"])
    for key in ("pos_buckets", "neg_buckets"):
        _check(int(single[key].sum()) == int(s_cpu[key].sum()), f"quantile {key} total differs from the CPU")
    for key in ("zero_count", "min_value", "max_value", "_update_count"):
        _check(torch.equal(single[key].cpu(), s_cpu[key]), f"quantile {key} differs from the CPU")
    cells_moved = int((single["pos_buckets"].cpu() != s_cpu["pos_buckets"]).sum()
                      + (single["neg_buckets"].cpu() != s_cpu["neg_buckets"]).sum())
    got_q, want_q = q.compute_from(single).cpu(), q_cpu.compute_from(s_cpu)
    _check(bool(torch.isfinite(got_q).all()) and got_q.shape == (3,), f"quantile value {got_q}")
    _check(bool(((got_q - want_q).abs() <= 2 * 0.01 * want_q.abs()).all()), f"quantiles {got_q} vs CPU {want_q}")
    every = torch.cat(lat)
    every = torch.sort(every[~torch.isnan(every)]).values
    exact = [float(every[int(math.floor(qq * (every.numel() - 1)))]) for qq in q.quantiles]
    rel = [abs(float(g) - e) / abs(e) for g, e in zip(got_q, exact)]
    _check(max(rel) <= 0.01, f"quantile relative errors {rel} above alpha 0.01")
    print(f"phase E quantile: buckets bit-identical to the plain scatter on the card's own bucket indices; "
          f"{moved} of {SKETCH_BATCHES * SKETCH_BATCH} values in another bucket than on the CPU "
          f"({cells_moved} bucket counts differ), totals, zero count and min/max equal; merge == single stream; "
          f"q{list(q.quantiles)} = {got_q.tolist()} (CPU {want_q.tolist()}, exact {exact}, rel err {rel})")

    # --- cardinality sketches
    true_distinct = int(torch.unique(torch.cat(ids)).numel())
    for name, p, metric in (("cardinality_p12", 12, c12), ("cardinality_p16", 16, c16)):
        first, second, single, merged = states[name]
        _equal_states(torch, single, merged, f"{name} merge of two half-streams")
        m_cpu = CardinalitySketch(p=p, device="cpu")
        s_cpu = _fold(m_cpu.init_state, m_cpu.update_state, cpu["ids"])
        _equal_states(torch, single, s_cpu, f"{name} against the CPU recomputation")
        est, est_cpu = float(metric.compute_from(single)), float(m_cpu.compute_from(s_cpu))
        _check(math.isclose(est, est_cpu, rel_tol=1e-6), f"{name} estimate {est} vs CPU {est_cpu}")
        rel = abs(est - true_distinct) / true_distinct
        _check(rel <= 3 * 1.04 / math.sqrt(1 << p), f"{name} estimate {est} vs {true_distinct} distinct")
        print(f"phase E {name}: registers bit-identical to the CPU; merge == single stream; estimate {est} "
              f"(CPU {est_cpu}) of {true_distinct} distinct, rel err {rel}")

    # --- count-min table
    first, second, single, merged = states["count_min_4x2048"]
    _check(torch.equal(single, merged), "count-min merge of two half-streams")
    t_cpu = _fold(lambda: torch.zeros((4, 2048), dtype=torch.int32), sk.cms_table_update, cpu["ids"])
    _check(torch.equal(single.cpu(), t_cpu), "count-min table differs from the CPU recomputation")
    keys = ids[0][:4096]
    true_counts = torch.bincount(torch.cat(ids).to(torch.int64), minlength=ZIPF_IDS)[keys.to(torch.int64)]
    est = sk.cms_query(single, keys)
    _check(bool((est.to(torch.int64) >= true_counts).all()), "count-min undercounts")
    print(f"phase E count_min_4x2048: table bit-identical to the CPU; merge == single stream; never undercounts "
          f"on 4096 keys (largest overcount {int((est.to(torch.int64) - true_counts).max())})")

    # --- heavy hitters
    first, second, single, merged = states["heavy_hitters"]
    half = HH_BATCHES // 2
    t0 = time.perf_counter()
    h_cpu = HeavyHittersSketch(k=32, depth=4, width=2048, device="cpu")
    first_cpu = _fold(h_cpu.init_state, h_cpu.update_state, cpu["hh"][:half])
    single_cpu = _fold(lambda: first_cpu, h_cpu.update_state, cpu["hh"][half:])
    second_cpu = _fold(h_cpu.init_state, h_cpu.update_state, cpu["hh"][half:])
    cpu_s = time.perf_counter() - t0
    for card, host, what in ((first, first_cpu, "first half"), (second, second_cpu, "second half"),
                             (single, single_cpu, "single stream")):
        _equal_states(torch, card, host, f"heavy hitters ({what}) against the CPU recomputation")
    _check(torch.equal(merged["counts"], single["counts"]), "heavy-hitter counts: merge != single stream")
    _check(torch.equal(merged["ledger"].cpu(), sk.topk_merge(torch.stack([first_cpu["ledger"], second_cpu["ledger"]]))),
           "heavy-hitter merged ledger differs from topk_merge on the CPU")
    top_keys, top_counts = hh.compute_from(single)
    cpu_keys, cpu_counts = h_cpu.compute_from(single_cpu)
    _check(torch.equal(top_keys.cpu(), cpu_keys) and torch.equal(top_counts.cpu(), cpu_counts), "hh_rank differs")
    print(f"phase E heavy_hitters: {HH_BATCHES} batches of {HH_BATCH} ids: counts and ledger bit-identical to the "
          f"CPU's plain walk ({cpu_s:.1f} s; both halves and the single stream); merged counts == single stream, "
          f"merged ledger == topk_merge on the CPU; top 5 {list(zip(top_keys[:5].tolist(), top_counts[:5].tolist()))}")

    # --- the stateful path, once per sketch
    for make, batch in ((lambda: QuantileSketch(device="cuda"), lat[0]), (lambda: CardinalitySketch(device="cuda"), ids[0]),
                        (lambda: HeavyHittersSketch(device="cuda"), hh_ids[0])):
        metric = make()
        metric.update(batch)
        value = metric.compute()
        want = metric.compute_from(metric.update_state(metric.init_state(), batch))
        for a, b in zip(value if isinstance(value, tuple) else (value,), want if isinstance(want, tuple) else (want,)):
            _check(torch.equal(a, b), f"stateful {type(metric).__name__}.compute differs from compute_from")
        metric.reset()
        for key, default in metric._defaults.items():
            _check(torch.equal(getattr(metric, key), default), f"reset of {type(metric).__name__}.{key}")
        _check(metric.update_count == 0 and not metric.update_called, "reset")
    print("phase E stateful update/compute/reset on the card agree with the functional path")
    return launches, {"lat": lat, "ids": ids, "hh_ids": hh_ids, "paths": paths, "states": states, "walls": walls}


def _kernel_record(torch, kernel: str, run, plain, library, nbytes: int, ops: int, extra: dict,
                   ops_per_s: float = CUDA_CORE_OPS_PER_S) -> dict:
    """Kernel, plain version, library call and bound at one shape."""
    iters = 50
    ms = _time_ms(run, iters)
    plain_ms = _time_ms(plain, 10, warmup=2)
    library_ms = _time_ms(library, iters)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    device_ms = _per_call_ms(_call_kernels(torch, run, f"{kernel}_", 1))
    rec = {**extra, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops}
    print(f"phase F {kernel} {json.dumps(rec)}")
    return rec


def _update_profile(torch, update, state, batch, kernel: str, iters: int = 20, tries: int = 3) -> dict:
    """Device time by kernel, idle share and launches of one sketch update, under the profiler.
    The profiler sometimes records few of a window's launches: a window that holds fewer than
    half of the launches of the update's ``kernel`` (one a call at least) is profiled again,
    up to ``tries`` times; ``complete`` says whether one held them."""
    for _ in range(tries):
        kernels, wall_us = _profile_steps(torch, lambda: update(state, batch), iters)
        recorded = sum(len(v) for name, v in kernels.items() if kernel in name)
        if 2 * recorded >= iters:
            break
    busy_us = sum(sum(v) for v in kernels.values())
    return {
        "complete": 2 * recorded >= iters,
        f"{kernel}_launches_recorded": recorded,
        "updates": iters,
        "device_busy_us_per_update": busy_us / iters,
        "wall_us_per_update_under_profiler": wall_us / iters,
        "idle_share": 1.0 - busy_us / wall_us if wall_us else None,
        "launches_per_update": sum(len(v) for v in kernels.values()) / iters,
        "top_kernels": [
            {"name": name[:90], "launches_per_update": len(v) / iters, "us_per_update": sum(v) / iters}
            for name, v in sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:10]
        ],
    }


def _walk_record(torch, cms_walk, ids, issue_ops_per_s: float, clock_hz: float, plain: bool) -> dict:
    """The ledger walk of ``ids`` into an empty 4 x 2048 table and k = 32 ledger: call time, device
    time (all four kernels, and by kernel), µs per item, the counters (held against the numpy
    mirror's), and the bound: the evictions times WALK_DECISION_CYCLES over the SM clock
    (``clocks.max.sm``), plus the table half's bound (the ids route of cms_rows_add at the same N);
    ``snapshot_bound_ms``: the same cycles for every item held at the start of its chunk of 32 or
    with an estimate above the smallest count then (``snapshot_items`` of the mirror in chunks of
    32), plus the table half's bound. The plain walk once if asked."""
    n = ids.numel()
    table = torch.zeros((4, 2048), dtype=torch.int32, device="cuda")
    ledger = torch.stack([torch.full((32,), -1, dtype=torch.int32, device="cuda"),
                          torch.zeros(32, dtype=torch.int32, device="cuda")], dim=1)
    run = lambda: cms_walk.cms_walk_cuda(table, ledger, ids)  # noqa: E731
    calls = max(2, min(20, 2**18 // n))
    ms = _time_ms(run, calls, warmup=1)
    by_kernel = {name[name.index("cms_walk_"):].split("<")[0].split("(")[0]: sum(v) / len(v) / 1e3
                 for name, v in _call_kernels(torch, run, "cms_walk_", cms_walk.KERNELS, calls).items()}
    device_ms = sum(by_kernel.values()) if by_kernel else None
    counters = torch.zeros(3, dtype=torch.int64, device="cuda")
    got = cms_walk.cms_walk_cuda(table, ledger, ids, counters)
    raises, evictions, sequential = counters.tolist()
    m_table, m_ledger, mirror = cms_walk.walk_in_chunks(table.cpu(), ledger.cpu(), ids.cpu())
    _check((raises, evictions, sequential) == tuple(mirror[:3]), f"walk at N={n}: counters {counters.tolist()}, "
           f"mirror {tuple(mirror[:3])}")
    _check(torch.equal(got[0].cpu(), m_table) and torch.equal(got[1].cpu(), m_ledger), f"walk at N={n}: mirror")
    snapshot = cms_walk.walk_in_chunks(table.cpu(), ledger.cpu(), ids.cpu(), step=cms_walk.CHUNK)[2].snapshot_items
    valid = int((ids >= 0).sum())
    nbytes, ops = 4 * n + 8 * 4 * 2048, CM_HASH_OPS * 4 * n
    table_ms, table_by = _bound(nbytes, ops, issue_ops_per_s)
    eviction_ms = evictions * WALK_DECISION_CYCLES / clock_hz * 1e3
    snapshot_ms = snapshot * WALK_DECISION_CYCLES / clock_hz * 1e3
    plain_ms = _time_ms(lambda: cms_walk.cms_walk_reference(table, ledger, ids), 1, warmup=0) if plain else None
    chunks = -(-n // cms_walk.CHUNK)
    return {"shape": f"N={n} Zipf ids, 4 x 2048 table, k=32", "ms": ms, "device_ms": device_ms,
            "device_ms_by_kernel": by_kernel, "us_per_item": device_ms * 1e3 / n if device_ms else None,
            "raises": raises, "evictions": evictions, "sequential_chunks": sequential, "chunks": chunks,
            "sequential_share": sequential / chunks, "valid": valid, "snapshot_items": snapshot,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": eviction_ms + table_ms, "bound_by": "operations",
            "eviction_bound_ms": eviction_ms, "snapshot_bound_ms": snapshot_ms + table_ms,
            "table_bound_ms": table_ms, "table_bound_by": table_by, "bytes": nbytes, "ops": ops,
            "placement": cms_walk.placement(4, 2048, 32), "segments": cms_walk.segments(n, 4 * 2048)}


def phase_f(torch, scatter, cms_walk, data, issue_ops_per_s: float, clock_hz: float) -> dict:
    """Each scatter kernel at the Phase E shapes; the ledger walk; each sketch's update; profiled updates."""
    from metrics_tpu_torch.sketch import kernels as sk

    lat0, ids0, hh0 = data["lat"][0], data["ids"][0], data["hh_ids"][0]
    n = SKETCH_BATCH
    _, log_gamma, offset = sk.ddsketch_params(0.01)
    recs = {}

    idx = sk.ddsketch_buckets(lat0, 2048, log_gamma=log_gamma, offset=offset)  # always in range
    w = (lat0 > 0).to(torch.int32)
    bins = torch.zeros(2048, dtype=torch.int32, device="cuda")
    lib_bins = bins.clone()
    recs["hist_add"] = _kernel_record(
        torch, "hist_add", lambda: scatter.hist_add_cuda(bins, idx, w), lambda: scatter.hist_add_reference(bins, idx, w),
        lambda: lib_bins.index_add_(0, idx, w), 8 * n + 8 * 2048, 3 * n,
        {"shape": f"N={n}, 2048 bins (the quantile sketch's positive store)",
         "branch": scatter.hist_branch("hist_add", n, 2048)})

    for p in (12, 16):
        reg_idx, rank = sk.hll_registers(ids0, p=p)
        regs = torch.zeros(1 << p, dtype=torch.int32, device="cuda")
        lib_regs, reg_idx64 = regs.clone(), reg_idx.to(torch.int64)
        recs[f"hist_max_p{p}"] = _kernel_record(
            torch, "hist_max", lambda: scatter.hist_max_cuda(regs, reg_idx, rank),
            lambda: scatter.hist_max_reference(regs, reg_idx, rank),
            lambda: lib_regs.scatter_reduce_(0, reg_idx64, rank, "amax", include_self=True),
            8 * n + 8 * (1 << p), 3 * n,
            {"shape": f"N={n}, 2^{p} registers", "branch": scatter.hist_branch("hist_max", n, 1 << p)})

    cols = sk._cm_columns(ids0, 4, 2048)
    valid = ids0 >= 0
    counts = torch.zeros((4, 2048), dtype=torch.int32, device="cuda")
    flat = counts.clone().reshape(-1)
    key = (torch.arange(4, device="cuda") * 2048 + cols.to(torch.int64)).reshape(-1)
    inc = valid.to(torch.int32)[:, None].expand(n, 4).reshape(-1).contiguous()
    # the ids route: the ids read once, the table read and written once; the hash's integer
    # instructions over the card's issue rate
    recs["cms_rows_add_ids"] = _kernel_record(
        torch, "cms_rows_add", lambda: scatter.cms_ids_add_cuda(counts, ids0),
        lambda: scatter.cms_ids_add_reference(counts, ids0), lambda: flat.index_add_(0, key, inc),
        4 * n + 8 * 4 * 2048, CM_HASH_OPS * 4 * n,
        {"shape": f"N={n}, 4 x 2048 table, ids route (columns hashed in the kernel)",
         "branch": scatter.cms_ids_branch(4, 2048)}, ops_per_s=issue_ops_per_s)
    recs["cms_rows_add"] = _kernel_record(
        torch, "cms_rows_add", lambda: scatter.cms_rows_add_cuda(counts, cols, valid),
        lambda: scatter.cms_rows_add_reference(counts, cols, valid), lambda: flat.index_add_(0, key, inc),
        4 * 4 * n + n + 8 * 4 * 2048, 3 * 4 * n, {"shape": f"N={n}, 4 x 2048 table, columns route (registry entry)"})

    # the ledger walk at 4096 ids, at HH_BATCH (Phase E's heavy-hitter batch) and at 2^22
    for n_ids in WALK_SHAPES:
        ids = {n: ids0, HH_BATCH: hh0}.get(n_ids)
        ids = _zipf(torch, n_ids, torch.Generator(device="cuda").manual_seed(n_ids)) if ids is None else ids
        recs[f"cms_walk_{n_ids}"] = rec = _walk_record(torch, cms_walk, ids, issue_ops_per_s, clock_hz,
                                                       plain=n_ids == HH_BATCH)
        print(f"phase F cms_walk {json.dumps(rec)}")

    # per-update time and values/s of each sketch on one batch
    updates = {}
    for name, (init, update, _, batches, *_) in data["paths"].items():
        state, batch = init(), batches[0]
        ms = _time_ms(lambda: update(state, batch), 10, warmup=1)
        updates[name] = {"values": batch.numel(), "ms_per_update": ms, "values_per_s": batch.numel() / ms * 1e3}
    init, update, _, batches, *_ = data["paths"]["heavy_hitters"]
    state, batch = init(), batches[0][:4096]
    ms = _time_ms(lambda: update(state, batch), 10, warmup=1)
    updates["heavy_hitters_4096"] = {"values": batch.numel(), "ms_per_update": ms,
                                     "values_per_s": batch.numel() / ms * 1e3}
    for name in ("heavy_hitters", "heavy_hitters_4096"):
        updates[name]["us_per_item"] = updates[name]["ms_per_update"] * 1e3 / updates[name]["values"]
    print(f"phase F sketch updates {json.dumps(updates)}")

    # a quantile, a count-min table and a heavy-hitter update under the profiler
    for name, kernel in (("quantile", "hist_add"), ("count_min_4x2048", "cms_rows_add"), ("heavy_hitters", "cms_walk")):
        init, update, _, batches, *_ = data["paths"][name]
        recs[f"{name}_profile"] = profile = _update_profile(torch, update, init(), batches[0], kernel)
        print(f"phase F {name} update profile {json.dumps(profile)}")
    return recs


def _at_offset(torch, x, offset: int):
    """``x`` as a contiguous view ``offset`` elements into a larger buffer (a storage offset)."""
    if not offset:
        return x
    buf = torch.full((x.numel() + offset,), 7.0, device=x.device, dtype=x.dtype)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def _curve_inputs(torch, gen, shape, thr, weights: str, per_row: bool = False, offset: int = 0,
                  zeros: bool = False):
    """(p, tw, w) on the card: uniform scores with the edge values and ties on
    ``thr`` mixed in (or, with ``zeros``, only -0.0, +0.0 and +-1e-30); 0/1 or
    float weights, per element or per row; views at a storage offset if asked."""
    p = torch.rand(shape, generator=gen, device="cuda")
    flat = p.view(-1)
    n = flat.numel()
    if zeros:
        choices = torch.tensor([-0.0, 0.0, 1e-30, -1e-30], device="cuda")
        flat.copy_(choices[torch.randint(0, 4, (n,), generator=gen, device="cuda")])
    elif n >= 16:
        flat[:6] = torch.tensor([math.nan, math.inf, -math.inf, -0.0, 0.0, 1.0], device="cuda")
        k = max(1, n // 100)
        at = torch.randint(0, n, (k,), generator=gen, device="cuda")
        flat[at] = thr[torch.randint(0, thr.numel(), (k,), generator=gen, device="cuda")]
    w_shape = shape[:1] if per_row else shape
    if weights == "float":
        w = torch.rand(w_shape, generator=gen, device="cuda") * 2
    else:
        w = torch.randint(0, 2, w_shape, generator=gen, device="cuda").to(torch.float32)
    y = torch.randint(0, 2, shape, generator=gen, device="cuda").to(torch.float32)
    tw = y * (w[:, None] if per_row and len(shape) == 2 else w)
    return tuple(_at_offset(torch, x, offset) for x in (p, tw, w))


def _sorted_route_max_thresholds(bc, n_cols: int) -> int:
    """The largest T that takes the kernel's sorted-threshold route for ``n_cols`` columns."""
    lo, hi = 0, 2**20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if bc.uses_sorted_route(n_cols, mid) else (lo, mid - 1)
    return lo


def _curve_cases(bc):
    """(name, N, C, T, thresholds, per-row w[, storage offset]) of the Phase G cases,
    with both sides of the route crossover (``uses_sorted_route``) at C = 1 and 16."""
    edge1, edge16 = _sorted_route_max_thresholds(bc, 1), _sorted_route_max_thresholds(bc, 16)
    return [
        ("main_T100", CURVE_N, 1, 100, "linspace", False),
        ("main_T200", CURVE_N, 1, 200, "linspace", False),  # the main path's shape
        ("main_T400", CURVE_N, 1, 400, "linspace", False),
        ("main_T1024", CURVE_N, 1, 1024, "linspace", False),
        ("multiclass_C10", CURVE_N, CURVE_COLS, 200, "linspace", True),  # the multiclass update: w per row
        ("multilabel_C10", CURVE_N, CURVE_COLS, 200, "linspace", False),
        ("T1", 5003, 1, 1, "linspace", False),
        ("T1500_two_chunks", 4097, 3, 1500, "unsorted", False),
        ("compare_T1500_two_chunks_C16", 4097, 16, 1500, "unsorted", False),
        ("unsorted_duplicates", 65537, 1, 37, "unsorted", False),
        ("N1", 1, 1, 5, "linspace", False),
        ("N1_C10", 1, CURVE_COLS, 7, "linspace", True),
        ("ragged", 1025, 2, 33, "linspace", False),
        ("empty", 0, 1, 10, "linspace", False),
        ("nan_inf_thresholds", 65537, 1, 40, "specials", False),
        ("nan_inf_thresholds_C10", 30011, CURVE_COLS, 40, "specials", True),
        ("all_nan_thresholds", 4099, 2, 3, "nan", False),
        ("signed_zero_scores", 65536, 1, 9, "zeros", False),
        ("descending", 65537, 1, 200, "descending", False),
        ("descending_C10", 20000, CURVE_COLS, 64, "descending", False),
        (f"sorted_edge_T{edge1}", 65537, 1, edge1, "specials", False),
        (f"compare_edge_T{edge1 + 1}", 65537, 1, edge1 + 1, "specials", False),
        (f"sorted_edge_C16_T{edge16}", 20001, 16, edge16, "unsorted", True),
        (f"compare_edge_C16_T{edge16 + 1}", 20001, 16, edge16 + 1, "unsorted", True),
        ("unsorted_T1024_in_block_sort", 65537, 1, 1024, "unsorted", False),
        ("C3_two_phases", 30001, 3, 50, "specials", False),
        ("C33_two_columns_per_warp", 20001, 33, 100, "unsorted", True),
        ("view_offset_main", CURVE_N, 1, CURVE_T, "linspace", False, 1),
        ("view_offset_C10", 99991, CURVE_COLS, 50, "unsorted", True, 3),
    ]


def _curve_thresholds(torch, kind: str, t: int, gen):
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg

    if kind == "linspace":
        return _adjust_threshold_arg(t, torch.device("cuda"))
    if kind == "nan":
        return torch.full((t,), math.nan, device="cuda")
    if kind == "zeros":  # -0.0 and +0.0, and their neighbours
        return torch.tensor([0.0, -0.0, 1e-30, -1e-30, -0.0, 0.0, 1e-31, -math.inf, math.inf], device="cuda")[:t]
    thr = torch.rand(t, generator=gen, device="cuda")
    if kind == "descending":
        return torch.sort(thr, descending=True).values
    if kind == "specials":  # NaN, +-inf, -0.0 beside +0.0 and a duplicate, at random places
        at = torch.randperm(t, generator=gen, device="cuda")[:6]
        thr[at] = torch.tensor([math.nan, math.inf, -math.inf, -0.0, 0.0, math.nan], device="cuda")[:at.numel()]
    if t > 2:
        thr[1] = thr[0]
    return thr


def phase_g(torch, bc) -> dict:
    """Every threshold-count case: kernel vs plain version on the same CUDA inputs."""
    gen = torch.Generator(device="cuda").manual_seed(77)
    worst = 0.0
    for name, n, c, t, kind, per_row, *offset in _curve_cases(bc):
        route = "sorted" if bc.uses_sorted_route(c, t) else "compare"
        if name.startswith(("sorted_", "compare_")):
            _check(name.startswith(route), f"{name}: takes the {route} route")
        thr = _curve_thresholds(torch, kind, t, gen)
        p, tw, w = _curve_inputs(torch, gen, (n,) if c == 1 else (n, c), thr, "01", per_row,
                                 offset=offset[0] if offset else 0, zeros=kind == "zeros")
        if offset:
            thr = _at_offset(torch, thr, offset[0])
            _check(all(x.storage_offset() == offset[0] and x.is_contiguous() for x in (p, tw, w, thr)), name)
        before = bc.launches
        got = bc.binned_curve_counts_cuda(p, tw, w, thr)
        torch.cuda.synchronize()
        _check(bc.launches == before + (1 if n else 0), f"{name}: launch count")
        want = bc.reference_counts(p, tw, w, thr)
        for g, wnt, what in zip(got, want, ("tp", "fp")):
            _check(g.dtype == torch.float32 and g.shape == wnt.shape, f"{name} {what}: {g.dtype} {tuple(g.shape)}")
            _check(torch.equal(g, wnt), f"{name} {what}: kernel differs from reference_counts")
        err = max(float((g - wnt).abs().max()) if g.numel() else 0.0 for g, wnt in zip(got, want))
        worst = max(worst, err)
        print(f"phase G {name}: N={n} C={c} T={t} route={route} thresholds={kind} "
              f"w={'per row' if per_row else 'per element'} offset={offset[0] if offset else 0} "
              f"equal=True max_abs_err={err} launches={bc.launches - before} tp[0]={got[0].reshape(-1)[0].item() if n else 0}")
    _check(not bc.uses_sorted_route(16, 1500), "float_compare_route: takes the compare route")

    float_err = 0.0
    for name, n, c, t in (("float_main", CURVE_N, 1, CURVE_T), ("float_C10", CURVE_N, CURVE_COLS, CURVE_T),
                          ("float_compare_route", 65537, 16, 1500)):
        thr = _curve_thresholds(torch, "linspace", t, gen)
        p, tw, w = _curve_inputs(torch, gen, (n,) if c == 1 else (n, c), thr, "float")
        first = bc.binned_curve_counts_cuda(p, tw, w, thr)
        second = bc.binned_curve_counts_cuda(p, tw, w, thr)
        want = bc.reference_counts(p, tw, w, thr)
        torch.cuda.synchronize()
        for a, b, wnt in zip(first, second, want):
            _check(torch.equal(a, b), f"{name}: two launches on one input differ")
            _check(torch.allclose(a, wnt, rtol=1e-5, atol=1e-3), f"{name}: kernel vs reference_counts")
        err = max(float((a - wnt).abs().max()) for a, wnt in zip(first, want))
        rel = max(float(((a - wnt).abs() / wnt.abs().clamp(min=1)).max()) for a, wnt in zip(first, want))
        float_err = max(float_err, err)
        print(f"phase G {name}: N={n} C={c} T={t} float weights: repeat launches bit-identical; "
              f"allclose(rtol=1e-5, atol=1e-3) max_abs_err={err} max_rel_err={rel}")
    return {"max_abs_err": worst, "float_max_abs_err": float_err}


def _classifier_scores(torch, gen, n: int, pos_rate: float = 0.3):
    """Probabilities of a fair binary classifier: labels ~ Bernoulli(pos_rate), logits ~ N(+-1, 1.5), 1% ignored (-1)."""
    y = (torch.rand(n, generator=gen, device="cuda") < pos_rate).to(torch.int32)
    logit = torch.randn(n, generator=gen, device="cuda") * 1.5 + (2 * y - 1).to(torch.float32)
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.01, -1, y)
    return torch.sigmoid(logit), y


def phase_h(torch, bc, obs, instrument):
    """The binned curves at full width, counted and verified."""
    from metrics_tpu_torch.classification import (
        BinaryAUROC, BinaryAveragePrecision, BinaryPrecisionRecallCurve, BinaryROC, MulticlassAUROC,
        MultilabelAveragePrecision,
    )

    gen = torch.Generator(device="cuda").manual_seed(4242)
    batches = [_classifier_scores(torch, gen, CURVE_N) for _ in range(CURVE_UPDATES)]
    mc_batches, ml_batches = [], []
    for _ in range(2):
        mc_target = torch.randint(0, CURVE_COLS, (CURVE_N,), generator=gen, device="cuda", dtype=torch.int32)
        logits = torch.randn(CURVE_N, CURVE_COLS, generator=gen, device="cuda")
        logits[torch.arange(CURVE_N, device="cuda"), mc_target.long()] += 1.5
        mc_batches.append((torch.softmax(logits, dim=1), mc_target))
        ml_target = (torch.rand(CURVE_N, CURVE_COLS, generator=gen, device="cuda") < 0.2).to(torch.int32)
        ml_scores = torch.sigmoid(torch.randn(CURVE_N, CURVE_COLS, generator=gen, device="cuda") + 1.5 * ml_target - 0.5)
        ml_batches.append((ml_scores, ml_target))
    torch.cuda.synchronize()
    print(f"phase H data: {CURVE_UPDATES} batches of {CURVE_N} binary scores (30% positive, 1% ignored), "
          f"2 batches of {CURVE_N} x {CURVE_COLS} multiclass and multilabel scores; T={CURVE_T}")

    kw = {"thresholds": CURVE_T, "ignore_index": -1, "device": "cuda"}
    binary = {
        "BinaryPrecisionRecallCurve": BinaryPrecisionRecallCurve(**kw),
        "BinaryROC": BinaryROC(**kw),
        "BinaryAUROC": BinaryAUROC(**kw),
        "BinaryAUROC(max_fpr=0.5)": BinaryAUROC(max_fpr=0.5, **kw),
        "BinaryAveragePrecision": BinaryAveragePrecision(**kw),
    }
    mc = MulticlassAUROC(num_classes=CURVE_COLS, thresholds=CURVE_T, device="cuda")
    ml = MultilabelAveragePrecision(num_labels=CURVE_COLS, thresholds=CURVE_T, device="cuda")
    paths = {name: (m, batches) for name, m in binary.items()}
    paths["MulticlassAUROC"] = (mc, mc_batches)
    paths["MultilabelAveragePrecision"] = (ml, ml_batches)

    states, launches, n_updates = {}, 0, 0
    obs.enable()
    try:
        instrument.KERNEL_DISPATCHES.clear()
        bc.launches = 0  # the main path's run starts here ...
        t0 = time.perf_counter()
        for name, (m, bs) in paths.items():
            half = len(bs) // 2
            first = _fold(m.init_state, lambda s, b: m.update_state(s, *b), bs[:half])
            single = _fold(lambda: first, lambda s, b: m.update_state(s, *b), bs[half:])
            second = _fold(m.init_state, lambda s, b: m.update_state(s, *b), bs[half:])
            states[name] = (first, second, single, m.merge_states(first, second))
            n_updates += len(bs) + len(bs[half:])
            m.update(*bs[0])  # the stateful path: one update, compute below
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = bc.launches  # ... and ends here
        ref = instrument.KERNEL_DISPATCHES.value(kernel="binned_curve_counts", impl="reference")
        opt = instrument.KERNEL_DISPATCHES.value(kernel="binned_curve_counts", impl="optimized")
    finally:
        obs.disable()
    n_updates += len(paths)  # the stateful updates
    print(f"phase H ran {n_updates} binned updates in {wall:.3f} s; binned_curve launches={launches}, "
          f"dispatches optimized={opt} reference={ref}")
    _check(launches == n_updates, f"expected {n_updates} binned_curve launches (one per update), got {launches}")
    _check(opt == n_updates and ref == 0, f"dispatches: {opt} optimized, {ref} reference on CUDA tensors")

    # CPU recomputation through the plain version; the five binary metrics share one state
    cpu_bin = BinaryPrecisionRecallCurve(thresholds=CURVE_T, ignore_index=-1, device="cpu")
    cpu_state = _fold(cpu_bin.init_state, lambda s, b: cpu_bin.update_state(s, b[0].cpu(), b[1].cpu()), batches)
    cpu_mc = MulticlassAUROC(num_classes=CURVE_COLS, thresholds=CURVE_T, device="cpu")
    cpu_mc_state = _fold(cpu_mc.init_state, lambda s, b: cpu_mc.update_state(s, b[0].cpu(), b[1].cpu()), mc_batches)
    cpu_ml = MultilabelAveragePrecision(num_labels=CURVE_COLS, thresholds=CURVE_T, device="cpu")
    cpu_ml_state = _fold(cpu_ml.init_state, lambda s, b: cpu_ml.update_state(s, b[0].cpu(), b[1].cpu()), ml_batches)
    cpu_states = {name: (cpu_bin, cpu_state) for name in binary}
    cpu_states["MulticlassAUROC"] = (cpu_mc, cpu_mc_state)
    cpu_states["MultilabelAveragePrecision"] = (cpu_ml, cpu_ml_state)
    for name, (m, bs) in paths.items():
        first, second, single, merged = states[name]
        _equal_states(torch, single, merged, f"{name}: merge of two half-streams")
        cpu_m, cpu_s = cpu_states[name]
        _check(single["confmat"].dtype == torch.int32, f"{name}: confmat dtype {single['confmat'].dtype}")
        _check(torch.equal(single["confmat"].cpu(), cpu_s["confmat"]), f"{name}: state differs from the CPU recomputation")
        got, want = m.compute_from(single), _twin(m, "cpu").compute_from(cpu_s)
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            _check(bool(torch.isfinite(g).all()), f"{name}: value not finite")
            _check(torch.allclose(g.cpu(), w, rtol=1e-5, atol=1e-6), f"{name}: card {g} vs CPU {w}")
        stateful, functional = m.compute(), m.compute_from(m.update_state(m.init_state(), *bs[0]))
        for g, w in zip(stateful if isinstance(stateful, tuple) else (stateful,),
                        functional if isinstance(functional, tuple) else (functional,)):
            _check(torch.equal(g, w), f"{name}: stateful compute differs from compute_from")
        m.reset()
        _check(not m.confmat.any() and m.update_count == 0, f"{name}: reset")
    auroc = float(binary["BinaryAUROC"].compute_from(states["BinaryAUROC"][2]))
    ap = float(binary["BinaryAveragePrecision"].compute_from(states["BinaryAveragePrecision"][2]))
    pauc = float(binary["BinaryAUROC(max_fpr=0.5)"].compute_from(states["BinaryAUROC(max_fpr=0.5)"][2]))
    mc_v = float(mc.compute_from(states["MulticlassAUROC"][2]))
    ml_v = float(ml.compute_from(states["MultilabelAveragePrecision"][2]))
    print(f"phase H binned states bit-identical to the CPU recomputation; merge == single stream; stateful == "
          f"functional; BinaryAUROC={auroc} (max_fpr=0.5: {pauc}) BinaryAveragePrecision={ap} "
          f"MulticlassAUROC={mc_v} MultilabelAveragePrecision={ml_v}")

    # exact mode: one BinaryAUROC on 2^20 scores, against the CPU and the binned value
    scores, target = _classifier_scores(torch, gen, EXACT_N)
    exact = BinaryAUROC(thresholds=None, ignore_index=-1, device="cuda")
    exact.update(scores, target)
    got = float(exact.compute())
    cpu_exact = BinaryAUROC(thresholds=None, ignore_index=-1, device="cpu")
    cpu_exact.update(scores.cpu(), target.cpu())
    want = float(cpu_exact.compute())
    binned = BinaryAUROC(thresholds=CURVE_T, ignore_index=-1, device="cuda")
    binned.update(scores, target)
    approx = float(binned.compute())
    _check(math.isfinite(got) and abs(got - want) <= 1e-5, f"exact AUROC card {got} vs CPU {want}")
    _check(abs(got - approx) <= 2e-3, f"exact AUROC {got} vs binned {approx}")
    print(f"phase H exact BinaryAUROC on {EXACT_N} scores: {got} (CPU {want}; binned T={CURVE_T}: {approx})")
    return launches, {"batches": batches, "binary": binary, "mc": (mc, mc_batches), "ml": (ml, ml_batches)}


def _twin(m, device: str, validate_args: bool = True):
    """The same curve metric class with the same arguments, on ``device``."""
    kw = {"thresholds": CURVE_T, "device": device, "validate_args": validate_args}
    for attr in ("ignore_index", "max_fpr", "average", "num_classes", "num_labels"):
        if hasattr(m, attr):
            kw[attr] = getattr(m, attr)
    return type(m)(**kw)


def _bucketize_counts(torch, p, tw, w, thr_sorted):
    """The three-call route for sorted thresholds: bucketize, bincount, cumsum (0/1 weights)."""
    b = torch.bucketize(p, thr_sorted, right=True)  # p >= thr[t]  <=>  b > t; NaN lands past the last bucket
    t = thr_sorted.numel()
    key = b * 2 + (tw > 0).to(torch.int64)
    hist = torch.bincount(key, weights=w, minlength=2 * (t + 1)).reshape(t + 1, 2)
    suffix = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))  # suffix[t] = counts with b >= t
    return suffix[1:, 1], suffix[1:, 0]


def phase_i(torch, bc, data) -> dict:
    """The kernel at the Phase H shape and at T = 1024; the binary updates per batch."""
    recs = {}
    gen = torch.Generator(device="cuda").manual_seed(99)
    for t, c in ((CURVE_T, 1), (1024, 1), (CURVE_T, CURVE_COLS)):
        n = CURVE_N
        thr = _curve_thresholds(torch, "linspace", t, gen)
        per_row = c > 1
        p, tw, w = _curve_inputs(torch, gen, (n,) if c == 1 else (n, c), thr, "01", per_row=per_row)
        iters = 50
        ms = _time_ms(lambda: bc.binned_curve_counts_cuda(p, tw, w, thr), iters)
        plain_ms = _time_ms(lambda: bc.reference_counts(p, tw, w, thr), 5, warmup=1)
        # p and tw read once, w once at its own shape (one weight per row for C > 1), thr once;
        # tp and fp written once
        nbytes = 8 * n * c + 4 * (n if per_row else n * c) + 4 * t + 8 * t * c
        # The least work that computes the function is the sorted-threshold route: sort the thresholds,
        # per sample a binary search and five flops (w·tw, w·w, a subtraction, two histogram adds),
        # then a suffix sum of both histograms.
        ops = t * math.ceil(math.log2(t)) + n * c * (math.ceil(math.log2(t + 1)) + 5) + 2 * t * c
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        calls = 20
        # both routes launch two kernels a call
        mine = _call_kernels(torch, lambda: bc.binned_curve_counts_cuda(p, tw, w, thr), "binned_curve_", 2, calls)
        device_ms = _per_call_ms(mine)
        rec = {"shape": f"N={n}, C={c}, T={t}", "route": "sorted" if bc.uses_sorted_route(c, t) else "compare",
               "ms": ms, "device_ms": device_ms,
               "device_ms_by_kernel": {
                   name[:60]: {"launches_recorded": len(v), "calls": calls, "ms_per_launch": sum(v) / len(v) / 1e3}
                   for name, v in mine.items()},
               "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes": nbytes, "ops": ops}
        if c == 1:  # the three-call route, for sorted thresholds and 0/1 weights
            finite = torch.isfinite(p)  # the route counts NaN above every threshold: compare on finite scores
            got_f = _bucketize_counts(torch, p[finite], tw[finite], w[finite], thr)
            want_f = bc.binned_curve_counts_cuda(p[finite].contiguous(), tw[finite].contiguous(), w[finite].contiguous(), thr)
            _check(all(torch.equal(a.to(torch.float32), b) for a, b in zip(got_f, want_f)),
                   "bucketize route differs from the kernel on finite scores")
            rec["bucketize_bincount_cumsum_ms"] = _time_ms(lambda: _bucketize_counts(torch, p, tw, w, thr), iters)
        recs[f"T{t}_C{c}"] = rec
        print(f"phase I binned_curve {json.dumps(rec)}")

    # the five binary updates per batch of 10^6 scores (default arguments, and without validation)
    batch = data["batches"][0]
    for validate in (True, False):
        metrics = [_twin(m, "cuda", validate) for m in data["binary"].values()]
        states = [m.init_state() for m in metrics]

        def run():
            for i, m in enumerate(metrics):
                states[i] = m.update_state(states[i], *batch)

        ms = _time_ms(run, 10, warmup=2)
        recs[f"binary_updates_validate_{validate}"] = {"ms_per_batch": ms, "updates": len(metrics),
                                                      "scores_per_s": CURVE_N * len(metrics) / ms * 1e3}
    one = data["binary"]["BinaryAUROC"]
    state = one.init_state()
    kernels, wall_us = _profile_steps(torch, lambda: one.update_state(state, *batch), 5)
    busy_us = sum(sum(v) for v in kernels.values())
    recs["auroc_update_profile"] = {
        "device_busy_us_per_update": busy_us / 5,
        "wall_us_per_update_under_profiler": wall_us / 5,
        "idle_share": 1.0 - busy_us / wall_us if wall_us else None,
        "launches_per_update": sum(len(v) for v in kernels.values()) / 5,
        "top_kernels": [{"name": name[:90], "launches_per_update": len(v) / 5, "us_per_update": sum(v) / 5}
                        for name, v in sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:8]],
    }
    print(f"phase I binary updates {json.dumps({k: v for k, v in recs.items() if not k.startswith('T')})}")
    return recs


def _route_launches(instrument) -> tuple:
    """(stat-score, table) launches of csrc/pair_count.cu counted so far."""
    return tuple(int(instrument.KERNEL_LAUNCHES.value(kernel=k)) for k in ("stat_scores", "pair_count"))


def _diff(after: tuple, before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(after, before))


def _no_reference_dispatch(instrument, what: str) -> None:
    for entry in ("stat_scores_cuda", "pair_count_cuda"):
        n = int(instrument.KERNEL_DISPATCHES.value(kernel=entry, impl="reference"))
        _check(n == 0, f"{what}: {n} reference dispatches of {entry} on a CUDA tensor")


def phase_j1(torch, entry_mod, obs, instrument, steps_c: dict, dev: str = "cuda", **config) -> dict:
    """The flagship step at full width with its three metrics in a MetricCollection,
    against the same three as a dict, counted, verified and timed."""
    from metrics_tpu_torch import MetricCollection

    cfg = {**entry_mod.FULL_CONFIG, **config}
    params, x, y = entry_mod.make_inputs(0, cfg["batch"], cfg["hidden"], cfg["classes"], cfg["layers"], dev)
    col = MetricCollection(entry_mod.make_metrics(cfg["classes"], dev))
    metrics = entry_mod.make_metrics(cfg["classes"], dev)
    built = {k: list(v) for k, v in col.compute_groups.items()}
    # one eager update forms the groups; the functional states start from init_state() after it
    col.update(torch.argmax(entry_mod.forward(params, x, y)[1], dim=-1), y)
    groups = {k: list(v) for k, v in col.compute_groups.items()}
    print(f"phase J1 compute groups: built {built}, after one update {groups}")
    _check(groups == FLAGSHIP_GROUPS, f"flagship groups {groups}, the JAX package forms {FLAGSHIP_GROUPS}")
    col_states = col.init_state()
    _check(sorted(col_states) == ["accuracy", "confmat"], f"collection states {sorted(col_states)}")
    dict_states = {name: m.init_state() for name, m in metrics.items()}

    # sgd_step + argmax + col.update_state, chained; the dict path's three update_state calls on the
    # same predictions; (stat-score, table) launches counted around each
    col_launches, dict_launches = [], []
    obs.enable()
    try:
        instrument.KERNEL_LAUNCHES.clear()  # the main path's run starts here ...
        instrument.KERNEL_DISPATCHES.clear()
        for _ in range(FLAGSHIP_STEPS):
            params, loss, logits = entry_mod.sgd_step(params, x, y)
            preds = torch.argmax(logits, dim=-1)
            before = _route_launches(instrument)
            col_states = col.update_state(col_states, preds, y)
            mid = _route_launches(instrument)
            dict_states = {name: m.update_state(dict_states[name], preds, y) for name, m in metrics.items()}
            col_launches.append(_diff(mid, before))
            dict_launches.append(_diff(_route_launches(instrument), mid))
        total = _route_launches(instrument)  # ... and ends here
        _no_reference_dispatch(instrument, "phase J1")
    finally:
        obs.disable()
    print(f"phase J1 {FLAGSHIP_STEPS} steps: (stat-score, table) launches per step {col_launches[0]} through the "
          f"collection, {dict_launches[0]} through the dict; {total} in all")
    _check(col_launches == [(1, 1)] * FLAGSHIP_STEPS, f"collection launches per step {col_launches}")
    _check(dict_launches == [(2, 1)] * FLAGSHIP_STEPS, f"dict launches per step {dict_launches}")
    _check(bool(torch.isfinite(loss)), f"non-finite loss {loss}")
    for name in metrics:
        got = col_states["accuracy" if name == "f1" else name]
        for key, want in dict_states[name].items():
            _check(got[key].dtype == want.dtype and got[key].device == want.device, f"{name}.{key} dtype/device")
            _check(torch.equal(got[key], want), f"{name}.{key}: collection state differs from the dict path's")
    values = col.compute_from(col_states)
    for name, m in metrics.items():
        want = m.compute_from(dict_states[name])
        _check(torch.equal(values[name], want), f"{name}: collection value {values[name]} vs dict {want}")
    print(f"phase J1 states and compute_from values equal the dict path's (torch.equal); accuracy="
          f"{float(values['accuracy'])} f1={float(values['f1'])} confmat total={int(values['confmat'].sum())}")

    # time: bare, dict and collection steps, interleaved repetitions, minimum of each
    col_step, dict_step = entry_mod.make_step(col), entry_mod.make_step(metrics)
    reps = {"bare": [], "dict": [], "collection": []}
    st = {"dict": dict_states, "collection": col_states}

    def run(kind):
        def go():
            nonlocal params
            if kind == "bare":
                params, _, _ = entry_mod.sgd_step(params, x, y)
            else:
                _, params, st[kind] = (dict_step if kind == "dict" else col_step)(params, st[kind], x, y)
        return go

    for _ in range(TIMING_REPS):
        for kind in reps:
            reps[kind].append(_time_ms(run(kind), FLAGSHIP_STEPS, warmup=1))
    t = {k: min(v) for k, v in reps.items()}
    rec = {"bare_ms": t["bare"], "dict_ms": t["dict"], "collection_ms": t["collection"],
           "dict_overhead_pct": (t["dict"] - t["bare"]) / t["bare"] * 100.0,
           "collection_overhead_pct": (t["collection"] - t["bare"]) / t["bare"] * 100.0,
           "phase_c_overhead_pct": steps_c["overhead_pct"],
           "launches_per_step": {"collection": dict(zip(ROUTES, col_launches[0])),
                                 "dict": dict(zip(ROUTES, dict_launches[0]))},
           "launches": dict(zip(ROUTES, total))}
    print(f"phase J1 step {json.dumps(rec)} (min of {TIMING_REPS} reps x {FLAGSHIP_STEPS} steps; reps {reps})")
    return rec


def _six_metrics(dev: str, num_classes: int) -> dict:
    """The six-metric set of benchmarks/collections_vs_reference.py, argument validation off."""
    from metrics_tpu_torch.classification import (
        MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score, MulticlassPrecision, MulticlassRecall,
        MulticlassSpecificity,
    )

    kw = {"validate_args": False, "device": dev}
    return {
        "acc": MulticlassAccuracy(num_classes, average="micro", **kw),
        "prec": MulticlassPrecision(num_classes, average="macro", **kw),
        "rec": MulticlassRecall(num_classes, average="macro", **kw),
        "f1": MulticlassF1Score(num_classes, average="macro", **kw),
        "spec": MulticlassSpecificity(num_classes, average="macro", **kw),
        "cm": MulticlassConfusionMatrix(num_classes, **kw),
    }


def phase_j2(torch, obs, instrument, dev: str = "cuda", n: int = SIX_N, num_classes: int = SIX_C) -> dict:
    """The six-metric collection with compute groups on and off: groups, launches, states, time."""
    import numpy as np
    from metrics_tpu_torch import MetricCollection

    rng = np.random.default_rng(7)
    batches = [tuple(torch.from_numpy(rng.integers(0, num_classes, n)).to(dev) for _ in range(2))
               for _ in range(1 + SIX_UPDATES)]
    print(f"phase J2 data: {len(batches)} batches of {n} int64 preds and targets in [0, {num_classes}) from seed 7")
    cols = {"groups": MetricCollection(_six_metrics(dev, num_classes)),
            "no_groups": MetricCollection(_six_metrics(dev, num_classes), compute_groups=False)}
    built = {k: list(v) for k, v in cols["groups"].compute_groups.items()}
    _check(built == SIX_GROUPS_BUILT, f"groups at construction {built}, the JAX package seeds {SIX_GROUPS_BUILT}")
    launches = {}
    obs.enable()
    try:
        for mode, col in cols.items():
            instrument.KERNEL_LAUNCHES.clear()  # the main path's run starts here ...
            instrument.KERNEL_DISPATCHES.clear()
            per_update = []
            for preds, target in batches:
                before = _route_launches(instrument)
                col.update(preds, target)
                per_update.append(_diff(_route_launches(instrument), before))
            launches[mode] = per_update  # ... and ends here
            _no_reference_dispatch(instrument, f"phase J2 {mode}")
    finally:
        obs.disable()
    groups = {k: list(v) for k, v in cols["groups"].compute_groups.items()}
    print(f"phase J2 compute groups: built {built}, after one update {groups}; (stat-score, table) launches per "
          f"update: {launches['groups'][1]} with groups (the first, which forms them, {launches['groups'][0]}: one "
          f"per group at construction), {launches['no_groups'][0]} without")
    _check(groups == SIX_GROUPS, f"six-metric groups {groups}, the JAX package forms {SIX_GROUPS}")
    # groups at construction: {acc}, {cm}, {f1}, {prec, rec, spec}: three stat-score updates and the table
    _check(launches["groups"] == [(3, 1)] + [(1, 1)] * SIX_UPDATES, f"launches with groups {launches['groups']}")
    _check(launches["no_groups"] == [(5, 1)] * len(batches), f"launches without groups {launches['no_groups']}")

    # int32 states: with groups == without == a CPU recomputation through the plain pair count
    cpu = MetricCollection(_six_metrics("cpu", num_classes), compute_groups=False)
    for preds, target in batches:
        cpu.update(preds.cpu(), target.cpu())
    on = dict(cols["groups"].items(keep_base=True))
    off = dict(cols["no_groups"].items(keep_base=True))
    host = dict(cpu.items(keep_base=True))
    for name in on:
        for key in on[name]._defaults:
            a, b, c = getattr(on[name], key), getattr(off[name], key), getattr(host[name], key)
            _check(a.dtype == b.dtype == c.dtype == torch.int32 and a.device.type == dev, f"{name}.{key} dtype/device")
            _check(torch.equal(a, b), f"{name}.{key}: groups on differs from groups off")
            _check(torch.equal(a.cpu(), c), f"{name}.{key}: differs from the CPU recomputation")
    val_on, val_off, val_cpu = cols["groups"].compute(), cols["no_groups"].compute(), cpu.compute()
    for name in val_on:
        _check(torch.equal(val_on[name], val_off[name]), f"{name}: compute() with groups {val_on[name]} vs without")
        _check(torch.allclose(val_on[name].cpu().double(), val_cpu[name].double(), rtol=1e-6, atol=0),
               f"{name}: card {val_on[name]} vs CPU {val_cpu[name]}")
    print(f"phase J2 int32 states equal with groups, without, and on the CPU; compute() equal with and without "
          f"groups; {json.dumps({k: float(v) for k, v in val_on.items() if v.numel() == 1})}")

    # time SIX_UPDATES updates of each collection with CUDA events, interleaved, minimum of TIMING_REPS
    rec = {"n": n, "classes": num_classes,
           "launches_per_update": {k: dict(zip(ROUTES, v[-1])) for k, v in launches.items()},
           "launches_forming_update": dict(zip(ROUTES, launches["groups"][0]))}
    times = {mode: [] for mode in cols}
    for _ in range(TIMING_REPS):
        for mode, col in cols.items():
            times[mode].append(_time_ms(lambda: col.update(*batches[0]), SIX_UPDATES, warmup=1))
    for mode in cols:
        rec[f"{mode}_ms_per_update"] = min(times[mode])
    rec["speedup"] = rec["no_groups_ms_per_update"] / rec["groups_ms_per_update"]
    print(f"phase J2 updates {json.dumps(rec)} (min of {TIMING_REPS} runs of {SIX_UPDATES} updates; runs {times})")
    return rec


def phase_j3(torch, dev: str = "cuda", n: int = AGG_N) -> None:
    """The aggregators and a composition on the card against the CPU."""
    import warnings
    from metrics_tpu_torch import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
    from metrics_tpu_torch.classification import MulticlassPrecision, MulticlassRecall

    gen = torch.Generator(device=dev).manual_seed(31)
    values = torch.rand(n, generator=gen, device=dev) * 10.0 - 2.0
    values[torch.rand(n, generator=gen, device=dev) < 0.01] = float("nan")
    weights = torch.rand(n, generator=gen, device=dev)
    host_v, host_w = values.cpu(), weights.cpu()
    nans = torch.isnan(host_v)
    rtol = 1e-5  # float32 sums of 2^22 values in the card's order against a float64 sum on the CPU
    for strategy in ("warn", "ignore", 0.5):
        kept = host_v[~nans] if strategy in ("warn", "ignore") else torch.where(nans, 0.5, host_v)
        kept_w = host_w[~nans] if strategy in ("warn", "ignore") else host_w
        aggs = {cls.__name__: cls(nan_strategy=strategy, device=dev)
                for cls in (SumMetric, MeanMetric, MaxMetric, MinMetric, CatMetric)}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name, m in aggs.items():
                if name == "MeanMetric":
                    m.update(values, weights)
                else:
                    m.update(values)
        if strategy == "warn":
            _check(sum("nan" in str(w.message) for w in caught) == len(aggs), f"warn: {len(caught)} warnings")
        got = {name: m.compute() for name, m in aggs.items()}
        for name, m in aggs.items():
            for key in m._defaults:
                state = getattr(m, key)
                on_card = all(s.device.type == dev for s in state) if isinstance(state, list) else state.device.type == dev
                _check(on_card, f"{name}({strategy}).{key} is not on {dev}")
        want_sum = kept.double().sum()
        want_mean = (kept.double() * kept_w.double()).sum() / kept_w.double().sum()
        _check(torch.allclose(got["SumMetric"].cpu().double(), want_sum, rtol=rtol, atol=0),
               f"Sum({strategy}) {got['SumMetric']} vs {want_sum}")
        _check(torch.allclose(got["MeanMetric"].cpu().double(), want_mean, rtol=rtol, atol=0),
               f"Mean({strategy}) {got['MeanMetric']} vs {want_mean}")
        _check(torch.equal(got["MaxMetric"].cpu(), kept.max()), f"Max({strategy}) {got['MaxMetric']}")
        _check(torch.equal(got["MinMetric"].cpu(), kept.min()), f"Min({strategy}) {got['MinMetric']}")
        _check(torch.equal(got["CatMetric"].cpu(), kept), f"Cat({strategy}) differs from the kept values")
        print(f"phase J3 aggregators nan_strategy={strategy!r} on {n} float32 values ({int(nans.sum())} NaN): "
              f"Sum {float(got['SumMetric'])} (float64 CPU {float(want_sum)}), Mean {float(got['MeanMetric'])} "
              f"(float64 CPU {float(want_mean)}), rtol {rtol}; Max, Min and Cat exact")

    prec, rec = (cls(SIX_C, average="macro", device=dev) for cls in (MulticlassPrecision, MulticlassRecall))
    mean = MeanMetric(device=dev)
    pr_sum, twice_mean = prec + rec, 2 * mean
    g = torch.Generator().manual_seed(11)
    preds, target = (torch.randint(0, SIX_C, (SIX_N,), generator=g).to(dev) for _ in range(2))
    pr_sum.update(preds, target)
    twice_mean.update(values[~torch.isnan(values)])
    for combo, children in ((pr_sum, (prec, rec)), (twice_mean, (twice_mean.metric_a, mean))):
        _check(combo.device.type == dev, f"{combo.op.__name__}: device {combo.device}")
        got = combo.compute()
        a, b = (c.compute() if hasattr(c, "compute") else c for c in children)
        want = combo.op(a, b)
        _check(got.device.type == dev and torch.equal(got, want), f"{combo.op.__name__}: {got} vs {want}")
    _check(twice_mean.metric_a.dtype == torch.int32 and twice_mean.metric_a.device.type == dev,
           f"constant 2: {twice_mean.metric_a.dtype} on {twice_mean.metric_a.device}")
    print(f"phase J3 compositions on {dev}: precision + recall = {float(pr_sum.compute())}, "
          f"2 * mean = {float(twice_mean.compute())} (int32 constant on {dev}); each equals the operator on its "
          f"children's values")


# --------------------------------------------------------------------------- Phase K: the streaming engine

K_BUCKETS = (64, 256)  # the bucket ladder of benchmarks/engine_throughput.py --sketch
K_QUEUE = 2048
K_TENANTS = 8
K_THREADS = 4
K1_REQUESTS = 8000
K_NAIVE = 300  # naive per-call updates timed, as the benchmark times them
K_PROFILED = 1000  # requests in the profiled window that follows the timed one
K2_REQUESTS = 4000
K2_ROWS = (1, 16)
K2_BIG_ROWS = 600  # one request per tenant above the top bucket: split_rows cuts it
K2_CLASSES = 1000  # bench.py's class count
K3_REQUESTS = 1000
K3_TENANTS = 4
K3_BUCKETS = (64,)
K4_REQUESTS = 1000
K4_ROWS = (1, 8)
K5_REQUESTS = 300
# kernel -> (name fragment of its device kernels in a profile, device kernels per counted launch)
K_PROFILE_NAMES = {"pair_count": ("pair_count_", 1), "stat_scores": ("stat_scores_kernel", 1),
                   "hist_add": ("hist_add_", 1), "hist_max": ("hist_max_", 1), "cms_rows_add": ("cms_rows_add_", 1),
                   "cms_walk": ("cms_walk_", 1), "binned_curve": ("binned_curve_", 2)}


def _graph_nodes(graph) -> int | None:
    """Nodes of a captured graph (``cudaGraphGetNodes`` on the graph the engine
    kept); None where the runtime library cannot be loaded."""
    import ctypes

    try:
        cudart = ctypes.CDLL("libcudart.so.12")
    except OSError:
        return None
    n = ctypes.c_size_t(0)
    code = cudart.cudaGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    return int(n.value) if code == 0 else None


def _k_submit(engine, reqs, threads: int) -> float:
    """Submit ``reqs`` from ``threads`` client threads (request i from thread
    i % threads), flush, check every receipt; the wall seconds of it all."""
    import gc
    import threading
    from concurrent.futures import wait

    futures, lock = [], threading.Lock()

    def client(tid: int) -> None:
        mine = [engine.submit(key, *args) for key, args in reqs[tid::threads]]
        with lock:
            futures.extend(mine)

    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        workers = [threading.Thread(target=client, args=(tid,)) for tid in range(threads)]
        for th in workers:
            th.start()
        for th in workers:
            th.join(300)
            _check(not th.is_alive(), "a client thread did not finish")
        engine.flush(timeout=300)
        seconds = time.perf_counter() - t0
    finally:
        gc.enable()
    done, not_done = wait(futures, timeout=60)
    _check(not not_done and len(done) == len(reqs), f"{len(not_done)} of {len(reqs)} futures unanswered")
    errors = [f.exception() for f in done if f.exception() is not None]
    _check(not errors, f"{len(errors)} requests failed, first: {errors[:1]!r}")
    return seconds


def _k_warm(engine, make_args, buckets, keys) -> int:
    """The benchmark's warm-up: every tenant allocated, one request a rung (each
    captures its bucket's graph), then a reset (in place: the graphs stay)."""
    for key in keys:
        engine._alloc_slot(key)
    for rows in buckets:
        engine.submit(keys[0], *make_args(rows)).result(timeout=300)
        engine.flush(timeout=300)
    engine.reset()
    return engine.telemetry_snapshot()["compiles"]


def _k_fold(torch, metric, reqs, dev: str):
    """Per-tenant sequential fold of whole requests through ``update_state`` on
    ``dev``, and each tenant's row count."""
    states, rows = {}, {}
    for key, args in reqs:
        state = states.get(key) or metric.init_state()
        states[key] = metric.update_state(state, *(torch.from_numpy(a).to(dev) for a in args))
        rows[key] = rows.get(key, 0) + args[0].shape[0]
    return states, rows


def _k_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _k_leaves(sub, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


def _k_check_states(torch, engine, folds, rows, what: str) -> int:
    """Every tenant's engine state equal to its fold, leaf for leaf with its dtype;
    ``_update_count`` counts rows (the engine updates a row at a time, the fold a
    request at a time). The number of leaves compared."""
    compared = 0
    for key, fold in folds.items():
        got, want = _k_leaves(engine._keyed.state_of(key)), _k_leaves(fold)
        _check(set(got) == set(want), f"{what} {key}: leaves {sorted(got)} vs {sorted(want)}")
        for path, x in got.items():
            y = want[path]
            if path.endswith("_update_count"):
                _check(int(x) == rows[key], f"{what} {key} {path}: {int(x)} updates for {rows[key]} rows")
                continue
            _check(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), f"{what} {key}: {path} differs")
            compared += 1
    return compared


def _k_profile(torch, engine, reqs, threads: int, kernels) -> dict:
    """Device busy share, and the hand kernels' launches in the profile against
    captured launches x replays, over one window of ``reqs``; the window is
    profiled again (up to 3 times) while the counts disagree."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        before = engine.graph_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_s = _k_submit(engine, reqs, threads)
        expected = {k: n - before.get(k, 0) for k, n in engine.graph_launches().items() if k in kernels}
        times = _kernel_times(prof, torch)
        seen = {k: sum(len(v) for name, v in times.items() if K_PROFILE_NAMES[k][0] in name) // K_PROFILE_NAMES[k][1]
                for k in kernels}
        if seen == expected or not times:
            break
    busy_us = sum(sum(v) for v in times.values())
    return {
        "wall_s": wall_s,
        "device_busy_us": busy_us,
        "idle_share": 1.0 - busy_us / (wall_s * 1e6) if times else None,
        "device_ops": sum(len(v) for v in times.values()),
        "launches_in_replays": expected,
        "launches_profiled": seen,
        "profile_attempts": attempt + 1,
        "top_kernels": [{"name": n[:80], "count": len(v), "us": sum(v)}
                        for n, v in sorted(times.items(), key=lambda kv: -sum(kv[1]))[:6]],
    }


def _k_graphs(engine) -> list:
    out = []
    for (sig, bucket, cap), kernel in engine._kernels.items():
        rec = next(r for r in engine.graph_stats() if (r["bucket"], r["capacity"]) == (bucket, cap)
                   and r["signature"] == sig)
        out.append({"bucket": bucket, "capacity": cap, "nodes": _graph_nodes(kernel.graph),
                    "warmup_ms": rec["warmup_ms"], "capture_ms": rec["capture_ms"], "pool_bytes": rec["pool_bytes"],
                    "captured_launches": rec["captured_launches"], "replays": rec["replays"]})
    return out


def _k_serve(torch, name: str, make, reqs, buckets, warm_args, kernels, threads: int = K_THREADS,
             profile_reqs=None, **engine_kw) -> tuple:
    """One engine on the card: warm-up over the ladder, the timed window, the
    state checks against a fold on the card, then a profiled window. Returns
    ``(record, engine, fold states, rows)``; the caller closes the engine."""
    from metrics_tpu_torch.engine import StreamingEngine

    keys = sorted({key for key, _ in reqs})
    engine = StreamingEngine(make(), buckets=buckets, max_queue=K_QUEUE, capacity=K_TENANTS, **engine_kw)
    warm = _k_warm(engine, warm_args, buckets, keys)
    _check(warm == len(buckets), f"{name}: {warm} captures in the warm-up for {len(buckets)} buckets")
    seconds = _k_submit(engine, reqs, threads)
    snap = engine.telemetry_snapshot()
    _check(snap["fused"] and snap["fused_fallbacks"] == 0, f"{name}: fused {snap['fused']}, "
           f"{snap['fused_fallbacks']} fallbacks")
    _check(snap["compiles"] == len(buckets), f"{name}: {snap['compiles']} captures for {len(buckets)} buckets")
    launched = engine.graph_launches()
    for k in kernels:
        _check(launched.get(k, 0) > 0, f"{name}: {k} was never launched inside a replay ({launched})")
    folds, rows = _k_fold(torch, make(), reqs, "cuda")
    compared = _k_check_states(torch, engine, folds, rows, name)
    n_rows = sum(args[0].shape[0] for _, args in reqs)
    rec = {
        "requests": len(reqs), "rows": n_rows, "tenants": len(keys), "threads": threads, "buckets": list(buckets),
        "req_per_s": len(reqs) / seconds, "rows_per_s": n_rows / seconds, "seconds": seconds,
        "latency_s": snap["latency_s"], "batches": snap["batches"], "mean_batch_occupancy": snap["mean_batch_occupancy"],
        "compiles": snap["compiles"], "fused_fallbacks": snap["fused_fallbacks"], "slab_bytes": snap["slab_bytes"],
        "state_leaves_equal": compared, "graph_launches": launched, "graphs": _k_graphs(engine),
    }
    # the least time a row could take: one tenant's state gathered (read once) and scattered back
    # (written once) over the card's memory rate
    rec["state_bytes_per_tenant"] = snap["slab_bytes"] // engine._keyed.capacity
    rec["state_bound_us_per_row"] = 2 * rec["state_bytes_per_tenant"] / HBM_BYTES_PER_S * 1e6
    if profile_reqs is not None:
        prof = _k_profile(torch, engine, profile_reqs, threads, kernels)
        _check(prof["launches_profiled"] == prof["launches_in_replays"] or prof["device_ops"] == 0,
               f"{name}: profiled launches {prof['launches_profiled']} vs replays {prof['launches_in_replays']}")
        prof_rows = sum(args[0].shape[0] for _, args in profile_reqs)
        prof["device_us_per_row"] = prof["device_busy_us"] / prof_rows
        prof["wall_us_per_row"] = prof["wall_s"] * 1e6 / prof_rows
        rec["profiled_window"] = prof
    return rec, engine, folds, rows


def _k_quantile_reqs(np, seed: int, n: int, tenants: int):
    rng = np.random.default_rng(seed)
    return [(f"tenant-{int(rng.integers(0, tenants))}", (rng.lognormal(0.0, 1.0, 1).astype(np.float32),))
            for _ in range(n)]


def phase_k1(torch, np) -> dict:
    """The quantile engine at benchmarks/engine_throughput.py --sketch's configuration."""
    from metrics_tpu_torch import QuantileSketch

    reqs = _k_quantile_reqs(np, 2, K1_REQUESTS, K_TENANTS)
    naive = QuantileSketch()
    stream = [torch.from_numpy(v).to("cuda") for _, (v,) in reqs[:K_NAIVE]]
    naive.update(stream[0])  # warm the eager update path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for v in stream:
        naive.update(v)
    torch.cuda.synchronize()
    naive_rps = K_NAIVE / (time.perf_counter() - t0)
    rng = np.random.default_rng(3)
    rec, engine, _, _ = _k_serve(
        torch, "K1", QuantileSketch, reqs, K_BUCKETS,
        lambda rows: (rng.lognormal(0.0, 1.0, rows).astype(np.float32),), ("hist_add",),
        profile_reqs=_k_quantile_reqs(np, 4, K_PROFILED, K_TENANTS),
    )
    engine.close()
    rec["naive_req_per_s"] = naive_rps
    rec["speedup_vs_naive"] = rec["req_per_s"] / naive_rps
    print(f"phase K1 {json.dumps(rec)}")
    return rec


def _k2_metric(dev: str = "cuda"):
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score

    return MetricCollection({
        "accuracy": MulticlassAccuracy(K2_CLASSES, average="micro", device=dev),
        "f1": MulticlassF1Score(K2_CLASSES, average="macro", device=dev),
        "confmat": MulticlassConfusionMatrix(K2_CLASSES, device=dev),
    })


def phase_k2(torch, np) -> dict:
    """The flagship metrics served: int64 label pairs, 8 tenants, 4 client threads."""
    rng = np.random.default_rng(5)

    def labels(rows):
        return rng.integers(0, K2_CLASSES, rows).astype(np.int64), rng.integers(0, K2_CLASSES, rows).astype(np.int64)

    reqs = [(f"tenant-{int(rng.integers(0, K_TENANTS))}", labels(int(rng.integers(K2_ROWS[0], K2_ROWS[1] + 1))))
            for _ in range(K2_REQUESTS)]
    reqs += [(f"tenant-{t}", labels(K2_BIG_ROWS)) for t in range(K_TENANTS)]
    profile_reqs = [(f"tenant-{int(rng.integers(0, K_TENANTS))}", labels(int(rng.integers(K2_ROWS[0], K2_ROWS[1] + 1))))
                    for _ in range(K_PROFILED // 4)]
    rec, engine, folds, rows = _k_serve(torch, "K2", _k2_metric, reqs, K_BUCKETS, labels,
                                        ("stat_scores", "pair_count"), profile_reqs=None)
    try:
        # the plain versions on the CPU: one update of each tenant's rows, concatenated
        cpu_metric = _k2_metric("cpu")
        for key in folds:
            mine = [args for k, args in reqs if k == key]
            cpu = cpu_metric.update_state(cpu_metric.init_state(),
                                          *(torch.from_numpy(np.concatenate(col)) for col in zip(*mine)))
            got = _k_leaves(engine._keyed.state_of(key))
            for path, want in _k_leaves(cpu).items():
                if not path.endswith("_update_count"):
                    _check(want.dtype == torch.int32 and torch.equal(got[path].cpu(), want),
                           f"K2 {key}: {path} differs from the CPU's plain versions")
        metric = _k2_metric()
        for key, fold in folds.items():
            got, want = engine.compute(key), metric.compute_from(fold)
            for name in want:
                _check(torch.equal(got[name], want[name]), f"K2 {key}: compute()[{name!r}] differs from the fold's")
        # the engine hook: the collection's update captured as one graph per shape
        updater, state, fold = metric.jitted_update_state(), metric.init_state(), metric.init_state()
        for _ in range(5):
            batch = [torch.from_numpy(a).to("cuda") for a in labels(64)]
            state, fold = updater(state, *batch), metric.update_state(fold, *batch)
        for path, want in _k_leaves(fold).items():
            _check(torch.equal(_k_leaves(state)[path], want), f"K2 jitted_update_state: {path} differs")
        rec["profiled_window"] = _k_profile(torch, engine, profile_reqs, K_THREADS, ("stat_scores", "pair_count"))
        prof = rec["profiled_window"]
        _check(prof["launches_profiled"] == prof["launches_in_replays"] or prof["device_ops"] == 0,
               f"K2: profiled launches {prof['launches_profiled']} vs replays {prof['launches_in_replays']}")
        prof_rows = sum(args[0].shape[0] for _, args in profile_reqs)
        prof["device_us_per_row"] = prof["device_busy_us"] / prof_rows
        prof["wall_us_per_row"] = prof["wall_s"] * 1e6 / prof_rows
        prof["launches_per_row"] = {k: n / prof_rows for k, n in prof["launches_in_replays"].items()}
    finally:
        engine.close()
    rec["launches_per_row"] = {k: sum(g["captured_launches"].get(k, 0) for g in rec["graphs"]) /
                               sum(g["bucket"] for g in rec["graphs"]) for k in ("stat_scores", "pair_count")}
    print(f"phase K2 {json.dumps(rec)}")
    return rec


def phase_k3(torch, np) -> dict:
    """Heavy hitters: the four kernels of the ledger walk inside a graph; one client
    thread, so each tenant's (order-dependent) ledger follows its submission order."""
    from metrics_tpu_torch import HeavyHittersSketch

    rng = np.random.default_rng(7)

    def ids(rows):
        return (np.minimum(rng.zipf(ZIPF_S, rows), ZIPF_IDS).astype(np.int32),)

    reqs = [(f"tenant-{int(rng.integers(0, K3_TENANTS))}", ids(1)) for _ in range(K3_REQUESTS)]
    rec, engine, _, _ = _k_serve(torch, "K3", lambda: HeavyHittersSketch(k=32, depth=4, width=2048), reqs,
                                 K3_BUCKETS, ids, ("cms_walk",), threads=1)
    engine.close()
    print(f"phase K3 {json.dumps(rec)}")
    return rec


def phase_k4(torch, np) -> dict:
    """Binned AUROC: one binned_curve launch a row inside a graph."""
    from metrics_tpu_torch.classification import BinaryAUROC

    rng = np.random.default_rng(9)

    def scores(rows):
        return rng.random(rows).astype(np.float32), rng.integers(0, 2, rows).astype(np.int64)

    reqs = [(f"tenant-{int(rng.integers(0, K_TENANTS))}", scores(int(rng.integers(K4_ROWS[0], K4_ROWS[1] + 1))))
            for _ in range(K4_REQUESTS)]
    rec, engine, folds, _ = _k_serve(torch, "K4", lambda: BinaryAUROC(thresholds=CURVE_T), reqs, K_BUCKETS, scores,
                                     ("binned_curve",))
    try:
        metric = BinaryAUROC(thresholds=CURVE_T)
        for key, fold in folds.items():
            _check(torch.equal(engine.compute(key), metric.compute_from(fold)), f"K4 {key}: AUROC differs")
    finally:
        engine.close()
    print(f"phase K4 {json.dumps(rec)}")
    return rec


def phase_k5(torch, np, scatter) -> dict:
    """The ladder: an update that reads a value on the host cannot be captured;
    the engine demotes once and serves eagerly on the card, its kernels launched."""
    from metrics_tpu_torch import QuantileSketch
    from metrics_tpu_torch.engine import StreamingEngine

    class HostCheckedQuantiles(QuantileSketch):
        """Refuses non-finite values, read on the host (one sync an update)."""

        def update(self, value):
            if not bool(torch.isfinite(value).all()):
                raise ValueError("non-finite value")
            super().update(value)

    reqs = _k_quantile_reqs(np, 11, K5_REQUESTS, K_TENANTS)
    engine = StreamingEngine(HostCheckedQuantiles(), buckets=K3_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS)
    try:
        before = scatter.launches["hist_add"]
        seconds = _k_submit(engine, reqs, K_THREADS)
        snap = engine.telemetry_snapshot()
        _check(snap["fused_fallbacks"] == 1 and not snap["fused"] and not snap["degraded"],
               f"K5: fused {snap['fused']}, {snap['fused_fallbacks']} fallbacks, degraded {snap['degraded']}")
        _check(snap["processed"] == len(reqs) and snap["failed"] == 0, f"K5: {snap['processed']} processed")
        _check(engine.graph_launches() == {}, "K5: a graph survived the demotion")
        eager = scatter.launches["hist_add"] - before
        _check(eager >= 2 * len(reqs), f"K5: {eager} hist_add launches for {len(reqs)} eager updates")
        folds, rows = _k_fold(torch, HostCheckedQuantiles(), reqs, "cuda")
        compared = _k_check_states(torch, engine, folds, rows, "K5")
        _check(torch.randn(4, device="cuda").isfinite().all().item(), "K5: random numbers after a failed capture")
        rec = {"requests": len(reqs), "req_per_s": len(reqs) / seconds, "fused_fallbacks": snap["fused_fallbacks"],
               "compiles": snap["compiles"], "hist_add_launches_eager": eager, "state_leaves_equal": compared,
               "latency_s": snap["latency_s"]}
    finally:
        engine.close()
    print(f"phase K5 {json.dumps(rec)}")
    return rec


def _k6_reqs(np, n: int, tenants: int):
    """benchmarks/engine_throughput.py's stream: seed 0, per request a tenant, then
    int64 batch-1 preds and targets in {0, 1}, drawn in that order."""
    rng = np.random.default_rng(0)
    return [(f"tenant-{rng.integers(0, tenants)}", (rng.integers(0, 2, 1), rng.integers(0, 2, 1))) for _ in range(n)]


def phase_k6(torch, np) -> dict:
    """The JAX engine benchmark's headline configuration: ``BinaryAccuracy()`` with
    its value checks on, buckets (64, 256), max_queue 2048, capacity 8; 8000 batch-1
    requests over 8 tenants from 4 threads, beside 300 per-call forwards.
    Then ``evict_tenant`` on the served engine: the tenant's slot is reused and its
    replays start from a fresh state, with no new capture, while the other
    tenants keep their states."""
    from metrics_tpu_torch.classification import BinaryAccuracy

    reqs = _k6_reqs(np, K1_REQUESTS, K_TENANTS)
    naive = BinaryAccuracy(device="cuda")
    stream = [tuple(torch.from_numpy(a).to("cuda") for a in args) for _, args in reqs[:K_NAIVE]]
    naive(*stream[0])  # warm the eager forward
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, t in stream:
        naive(p, t)
    torch.cuda.synchronize()
    naive_rps = K_NAIVE / (time.perf_counter() - t0)
    rng = np.random.default_rng(13)
    rec, engine, folds, rows = _k_serve(
        torch, "K6", lambda: BinaryAccuracy(device="cuda"), reqs, K_BUCKETS,
        lambda rows: (rng.integers(0, 2, rows), rng.integers(0, 2, rows)), (),
        profile_reqs=_k6_reqs(np, K_PROFILED, K_TENANTS),
    )
    # the profiled window served the same tenants again: fold it too, so the
    # other tenants can be checked after the eviction
    fold = BinaryAccuracy(device="cuda")
    for key, args in _k6_reqs(np, K_PROFILED, K_TENANTS):
        folds[key] = fold.update_state(folds[key], *(torch.from_numpy(a).to("cuda") for a in args))
        rows[key] += args[0].shape[0]
    try:
        _check(engine.evict_tenant("tenant-0") is True, "K6: evict_tenant('tenant-0') did not return True")
        _check("tenant-0" not in engine.compute_all(), "K6: the evicted tenant is still read")
        _check(engine.evict_tenant("tenant-0") is False, "K6: a second eviction of the same tenant returned True")
        again = [("tenant-0", args) for _, args in _k6_reqs(np, 64, 1)]
        compiles = engine.telemetry_snapshot()["compiles"]
        _k_submit(engine, again, 1)
        snap = engine.telemetry_snapshot()
        _check(snap["compiles"] == compiles and snap["fused"] and snap["fused_fallbacks"] == 0,
               f"K6: {snap['compiles'] - compiles} captures, fused {snap['fused']} after the eviction")
        others = {key: fold for key, fold in folds.items() if key != "tenant-0"}
        kept = _k_check_states(torch, engine, others, rows, "K6 another tenant after the eviction")
        fresh, fresh_rows = _k_fold(torch, BinaryAccuracy(device="cuda"), again, "cuda")
        _k_check_states(torch, engine, fresh, fresh_rows, "K6 after the eviction")
        rec["eviction"] = {"evicted": "tenant-0", "resubmitted": len(again), "captures_after": snap["compiles"] - compiles,
                           "tier_evictions": snap["tier_evictions"], "state_equals_fresh_tenant": True,
                           "other_tenants_leaves_equal": kept}
    finally:
        engine.close()
    # C.4 on the graphed updater: a label above C is dropped (as under jax.jit), not refused,
    # on the call that captures the graph and on a replay alike
    from metrics_tpu_torch.classification import MulticlassConfusionMatrix

    cm = MulticlassConfusionMatrix(3, device="cuda")
    updater, state = cm.jitted_update_state(donate=False), cm.init_state()
    bad = [torch.tensor(v, dtype=torch.int32, device="cuda") for v in ([0, 1], [0, 3])]
    for _ in range(2):
        state = updater(state, *bad)
    _check(state["confmat"].tolist() == [[2, 0, 0], [0, 0, 0], [0, 0, 0]],
           f"K6 jitted_update_state on a label above C: {state['confmat'].tolist()}")
    rec["naive_req_per_s"] = naive_rps
    rec["speedup_vs_naive"] = rec["req_per_s"] / naive_rps
    rec["jax_gate"] = 10.0  # benchmarks/engine_throughput.py's speedup_ge_10x, a record here (ROADMAP B.2 item 8)
    for g in rec["graphs"]:
        g["nodes_per_row"] = g["nodes"] / g["bucket"] if g["nodes"] is not None else None
    print(f"phase K6 {json.dumps(rec)}")
    return rec


def phase_k(torch, scatter) -> dict:
    """The port's StreamingEngine on the card (K1 to K6)."""
    import numpy as np

    t0 = time.perf_counter()
    out = {"K1": phase_k1(torch, np), "K2": phase_k2(torch, np), "K3": phase_k3(torch, np),
           "K4": phase_k4(torch, np), "K5": phase_k5(torch, np, scatter), "K6": phase_k6(torch, np)}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase K: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------- Phase L: binary, multilabel, MSE

L_N = 10**6  # scores per update (benchmarks/classification_vs_reference.py's N)
L_C = 100  # that benchmark's C: the multilabel shape is L_N // L_C samples x L_C labels
L_FAMILY = {"StatScores": "stat_scores", "ConfusionMatrix": "confusion_matrix", "Accuracy": "accuracy",
            "F1Score": "f1_score", "Precision": "precision", "Recall": "recall", "Specificity": "specificity"}
L_TIMED = 10  # updates timed by CUDA events
L_PROFILED = 20  # updates under the profiler


def _l_batches(np):
    """benchmarks/classification_vs_reference.py's binary scores (seed 0, drawn after
    its two label arrays) and a second batch drawn after them."""
    rng = np.random.default_rng(0)
    rng.integers(0, L_C, L_N)
    rng.integers(0, L_C, L_N)
    return [(rng.random(L_N).astype(np.float32), rng.integers(0, 2, L_N).astype(np.int32)) for _ in range(2)]


def _l_equal(torch, got, want, what: str, rtol: float = 1e-6) -> None:
    """Integer results bit-identical with their dtype; float results within ``rtol``."""
    got = got.cpu()
    _check(got.dtype == want.dtype and got.shape == want.shape, f"{what}: {got.dtype}{tuple(got.shape)} vs "
           f"{want.dtype}{tuple(want.shape)}")
    ok = torch.equal(got, want) if not want.is_floating_point() else torch.allclose(got, want, rtol=rtol, atol=0)
    _check(ok, f"{what}: differs from the CPU recomputation")


def _l_profile(torch, run, iters: int = L_PROFILED) -> dict:
    """Device time, idle share and device kernels of one update, under the profiler (as Phase I)."""
    kernels, wall_us = _profile_steps(torch, run, iters)
    busy_us = sum(sum(v) for v in kernels.values())
    return {
        "device_busy_us_per_update": busy_us / iters,
        "wall_us_per_update_under_profiler": wall_us / iters,
        "idle_share": 1.0 - busy_us / wall_us if wall_us else None,
        "launches_per_update": sum(len(v) for v in kernels.values()) / iters,
        "top_kernels": [{"name": name[:70], "launches_per_update": len(v) / iters, "us_per_update": sum(v) / iters}
                        for name, v in sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:4]],
    }


def _l_task(torch, task: str, batches, **kw) -> dict:
    """The seven stat-score families of ``task`` through their class, their
    task façade (``StatScores(task=...)``), their functional and their functional
    façade on the card: int32 states and counts equal to the CPU's plain code,
    values within rtol 1e-6; each class update timed and profiled."""
    import metrics_tpu_torch.classification as cls
    import metrics_tpu_torch.functional.classification as fc

    dev_batches = [tuple(torch.from_numpy(a).to("cuda") for a in b) for b in batches]
    cpu_batches = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    out = {}
    for family, fn_name in L_FAMILY.items():
        name = f"{task.capitalize()}{family}"
        make = getattr(cls, name)
        # each route beside its CPU twin: the façades' defaults (average="micro") are not the classes'
        routes = {"class": lambda d: make(**kw, device=d),
                  "facade": lambda d: getattr(cls, family)(task=task, **kw, device=d)}
        compared = 0
        for route, build in routes.items():
            m, cpu = build("cuda"), build("cpu")
            _check(type(m) is make, f"{name} ({route}) built {type(m).__name__}")
            for b, c in zip(dev_batches, cpu_batches):
                m.update(*b)
                cpu.update(*c)
            for key in cpu._defaults:
                want = getattr(cpu, key)
                _check(want.dtype == torch.int32, f"{name}.{key} is {want.dtype} on the CPU")
                _l_equal(torch, getattr(m, key), want, f"{name} ({route}) state {key}")
                compared += 1
            _l_equal(torch, m.compute(), cpu.compute(), f"{name} ({route}) compute()")
        fn, facade = getattr(fc, f"{task}_{fn_name}"), getattr(fc, fn_name)
        _l_equal(torch, fn(*dev_batches[-1], **kw), fn(*cpu_batches[-1], **kw), f"{task}_{fn_name}")
        _l_equal(torch, facade(*dev_batches[-1], task=task, **kw), facade(*cpu_batches[-1], task=task, **kw),
                 f"{fn_name}(task={task!r})")
        rec = {"states_equal": compared, "routes": ["class", "facade", "functional", "functional_facade"]}
        m, unchecked = make(**kw, device="cuda"), make(**kw, device="cuda", validate_args=False)
        rec["ms_per_update"] = _time_ms(lambda: m.update(*dev_batches[0]), L_TIMED, warmup=2)
        rec["ms_per_update_unvalidated"] = _time_ms(lambda: unchecked.update(*dev_batches[0]), L_TIMED, warmup=2)
        rec.update(_l_profile(torch, lambda: m.update(*dev_batches[0])))
        out[name] = rec
        print(f"phase L {name} {json.dumps(rec)}")
    return out


def _l_mse(torch, np) -> dict:
    """benchmarks/regression_vs_reference.py's pairs through ``MeanSquaredError``:
    the float32 sum within rtol 1e-5 of a float64 sum on the CPU and of the
    port's plain code on the CPU, the count exact."""
    from metrics_tpu_torch.functional import mean_squared_error
    from metrics_tpu_torch.regression import MeanSquaredError

    rng = np.random.default_rng(0)
    p = rng.normal(size=L_N).astype(np.float32)
    t = (0.8 * p + 0.2 * rng.normal(size=L_N)).astype(np.float32)
    dp, dt = torch.from_numpy(p).to("cuda"), torch.from_numpy(t).to("cuda")
    rtol = 1e-5  # float32 sums of 10^6 squares in the card's order against float64 and the CPU's order
    m, cpu = MeanSquaredError(device="cuda"), MeanSquaredError(device="cpu")
    for _ in range(2):
        m.update(dp, dt)
        cpu.update(torch.from_numpy(p), torch.from_numpy(t))
    want64 = 2 * float(np.sum((p.astype(np.float64) - t.astype(np.float64)) ** 2))
    got = m.sum_squared_error.cpu()
    _check(got.dtype == torch.float32 and m.total.dtype == torch.float32, "MeanSquaredError states are not float32")
    _check(abs(float(got) - want64) <= rtol * want64, f"MSE sum {float(got)} vs float64 {want64}")
    _l_equal(torch, got, cpu.sum_squared_error, "MSE sum_squared_error", rtol)
    _check(float(m.total) == 2 * L_N, f"MSE total {float(m.total)}")
    _l_equal(torch, m.compute(), cpu.compute(), "MSE compute()", rtol)
    _l_equal(torch, mean_squared_error(dp, dt), mean_squared_error(torch.from_numpy(p), torch.from_numpy(t)),
             "mean_squared_error", rtol)
    rec = {"n": L_N, "sum_squared_error": float(got), "float64_sum": want64, "rtol": rtol}
    one = MeanSquaredError(device="cuda")
    rec["ms_per_update"] = _time_ms(lambda: one.update(dp, dt), L_TIMED, warmup=2)
    rec.update(_l_profile(torch, lambda: one.update(dp, dt)))
    print(f"phase L MeanSquaredError {json.dumps(rec)}")
    return rec


def phase_l(torch, np) -> dict:
    """The binary and multilabel stat-score families and MeanSquaredError at the JAX
    benchmarks' sizes: plain torch code, no hand kernel."""
    t0 = time.perf_counter()
    batches = _l_batches(np)
    out = {"binary": _l_task(torch, "binary", batches)}
    shaped = [tuple(a.reshape(L_N // L_C, L_C) for a in b) for b in batches]
    out["multilabel"] = _l_task(torch, "multilabel", shaped, num_labels=L_C)
    out["MeanSquaredError"] = _l_mse(torch, np)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase L: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------- Phase M: the durable state plane

M_PAIRS = 6  # plain/checkpointing pairs of benchmarks/engine_throughput.py's overhead gate (:442-476)
M_INTERVAL_S = 0.25  # that gate's CheckpointConfig(interval_s=0.25, retain=3)
M_RETAIN = 3
M_GATE_PCT = 5.0  # its ckpt_overhead_lt_5pct: a record here (the engine's rate moves between calls)
M2_QUANTILE_REQUESTS = 4000
M2_FLAGSHIP_REQUESTS = 2000
M3_CPU_REQUESTS = 40
M3_BATCH = 4096  # labels per update of the collection saved and restored on the card


def _m_filesystem(path: str) -> str:
    out = subprocess.run(["stat", "-f", "-c", "%T", path], capture_output=True, text=True)
    return out.stdout.strip() or "unknown"


def _m_states(engine) -> dict:
    """Copies of every tenant's live state (read under the dispatch lock)."""
    return {key: engine._keyed.state_of(key) for key in engine._keyed.keys}


def _m_equal(torch, got: dict, want: dict, what: str) -> int:
    """Every tenant's every leaf equal with its dtype (across devices too); the
    number of leaves compared."""
    _check(set(got) == set(want), f"{what}: tenants {sorted(got)} vs {sorted(want)}")
    compared = 0
    for key in want:
        a, b = _k_leaves(got[key]), _k_leaves(want[key])
        _check(set(a) == set(b), f"{what} {key}: leaves {sorted(a)} vs {sorted(b)}")
        for path, x in a.items():
            y = b[path]
            _check(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), f"{what} {key}: {path} differs")
            compared += 1
    return compared


def _m_timed(fn, spent: dict, key: str):
    """``fn`` adding its wall ms to ``spent[key]`` at each call."""

    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent[key] += (time.perf_counter() - t0) * 1e3

    return run


def _m1_pass(torch, np, reqs, folds, rows, ckpt_dir) -> dict:
    """One warmed, timed K6 pass (the benchmark's run_engine_pass), with
    checkpointing when ``ckpt_dir`` is given; states held to the fold. A
    checkpointing pass also sums the dispatcher's wall ms in the WAL (each
    chunk record's encode, append and flush) and in the snapshot views."""
    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.engine import CheckpointConfig, StreamingEngine

    cfg = None if ckpt_dir is None else CheckpointConfig(directory=ckpt_dir, interval_s=M_INTERVAL_S,
                                                          retain=M_RETAIN)
    engine = StreamingEngine(BinaryAccuracy(device="cuda"), buckets=K_BUCKETS, max_queue=K_QUEUE,
                             capacity=K_TENANTS, checkpoint=cfg)
    try:
        rng = np.random.default_rng(13)
        _k_warm(engine, lambda n: (rng.integers(0, 2, n), rng.integers(0, 2, n)), K_BUCKETS,
                sorted({key for key, _ in reqs}))
        before = engine.telemetry_snapshot()
        wal_bytes = engine._journal.appended_bytes if cfg is not None else 0
        spent = {"journal_ms": 0.0, "view_ms": 0.0}
        if cfg is not None:
            engine._journal_chunk = _m_timed(engine._journal_chunk, spent, "journal_ms")
            engine._checkpoint_view = _m_timed(engine._checkpoint_view, spent, "view_ms")
        seconds = _k_submit(engine, reqs, K_THREADS)
        spent = dict(spent)  # the timed window's: close() takes one more view
        after = engine.telemetry_snapshot()
        _k_check_states(torch, engine, folds, rows, "M1")
        rec = {"req_per_s": len(reqs) / seconds}
        if cfg is not None:
            health = engine.health()
            _check(after["checkpoint_failures"] == 0 and not health["wal_disabled"],
                   f"M1: {after['checkpoint_failures']} checkpoint failures, wal_disabled {health['wal_disabled']}")
            rec.update(snapshots=after["checkpoints"] - before["checkpoints"],
                       wal_records=after["wal_records"] - before["wal_records"],
                       wal_bytes=engine._journal.appended_bytes - wal_bytes, seconds=seconds, **spent)
        return rec
    finally:
        engine.close()


def phase_m1(torch, np, obs, instrument, root=None) -> dict:
    """Checkpoint overhead at K6's configuration, by the JAX benchmark's procedure:
    6 pairs of passes, plain and checkpointing (a snapshot every 0.25 s, 3 kept,
    the WAL on) in a temporary directory under ``root`` (None: the temporary
    directory's default), alternating which goes first; the median of the
    per-pair ratios, less one, is the overhead."""
    import statistics
    import tempfile

    reqs = _k6_reqs(np, K1_REQUESTS, K_TENANTS)
    from metrics_tpu_torch.classification import BinaryAccuracy

    folds, rows = _k_fold(torch, BinaryAccuracy(device="cuda"), reqs, "cuda")
    obs.enable()  # the write histogram; on for both sides of every pair
    try:
        writes0 = (instrument.CKPT_SECONDS.count(site="engine", op="write"),
                   instrument.CKPT_SECONDS.sum(site="engine", op="write"))
        plain, ckpt, ratios, fs = [], [], [], None
        for i in range(M_PAIRS):
            order = ("plain", "ckpt") if i % 2 == 0 else ("ckpt", "plain")
            got = {}
            for side in order:
                if side == "plain":
                    got[side] = _m1_pass(torch, np, reqs, folds, rows, None)
                else:
                    with tempfile.TemporaryDirectory(dir=root) as d:
                        fs = _m_filesystem(d)
                        got[side] = _m1_pass(torch, np, reqs, folds, rows, d)
            plain.append(got["plain"])
            ckpt.append(got["ckpt"])
            ratios.append(got["plain"]["req_per_s"] / got["ckpt"]["req_per_s"])
        writes = instrument.CKPT_SECONDS.count(site="engine", op="write") - writes0[0]
        write_s = instrument.CKPT_SECONDS.sum(site="engine", op="write") - writes0[1]
    finally:
        obs.disable()
    overhead_pct = (statistics.median(ratios) - 1.0) * 100.0
    rec = {
        "overhead_pct": overhead_pct, "gate_pct": M_GATE_PCT, "within_gate": overhead_pct < M_GATE_PCT,
        "pair_ratios": ratios, "plain_best_req_per_s": max(r["req_per_s"] for r in plain),
        "ckpt_best_req_per_s": max(r["req_per_s"] for r in ckpt),
        "plain_req_per_s": [r["req_per_s"] for r in plain], "ckpt_req_per_s": [r["req_per_s"] for r in ckpt],
        "snapshots_per_pass": [r["snapshots"] for r in ckpt], "wal_records_per_pass": [r["wal_records"] for r in ckpt],
        "wal_bytes_per_pass": [r["wal_bytes"] for r in ckpt],
        # the dispatcher's share of a checkpointing pass: WAL and snapshot views
        "dispatcher_journal_ms_per_pass": [r["journal_ms"] for r in ckpt],
        "dispatcher_view_ms_per_pass": [r["view_ms"] for r in ckpt],
        "dispatcher_share": [(r["journal_ms"] + r["view_ms"]) / (r["seconds"] * 1e3) for r in ckpt],
        "snapshot_writes": writes, "write_ms_per_snapshot": write_s * 1e3 / writes if writes else None,
        "filesystem": fs, "requests": len(reqs), "interval_s": M_INTERVAL_S, "retain": M_RETAIN,
    }
    # every checkpointing pass commits its final snapshot at close(), and those inside its
    # timed window as they fall due (``snapshots_per_pass``: a window shorter than the
    # interval may hold none)
    _check(writes >= M_PAIRS, f"M1: {writes} snapshot writes in {M_PAIRS} checkpointing passes")
    print(f"phase M1 ({fs}) {json.dumps(rec)}")
    return rec


def _m2_crash_and_recover(torch, np, name, make, reqs, kernels, directory) -> tuple:
    """Serve half, snapshot, serve the rest, crash (no final snapshot), recover on
    the card; hold the recovered states to the crashed engine's and to the fold,
    and the replay's hand-kernel launches to captured x replays. Returns
    ``(record, recovered engine, fold states, rows)``."""
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch.engine import CheckpointConfig, StreamingEngine
    from metrics_tpu_torch.kernels import launch_counts

    kw = dict(buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS,
              checkpoint=CheckpointConfig(directory=directory, interval_s=3600.0, retain=M_RETAIN))
    engine = StreamingEngine(make(), **kw)
    half = len(reqs) // 2
    _k_submit(engine, reqs[:half], K_THREADS)
    t0 = time.perf_counter()
    gen = engine.checkpoint_now()
    snapshot_write_ms = (time.perf_counter() - t0) * 1e3
    _check(gen is not None, f"{name}: checkpoint_now() failed: {engine._ckpt_writer.last_error!r}")
    snapshot_bytes = os.path.getsize(engine._ckpt_store.path(gen))
    _k_submit(engine, reqs[half:], K_THREADS)
    crashed = _m_states(engine)
    wal_rows = sum(args[0].shape[0] for _, args in reqs[half:])
    engine.close(checkpoint=False)  # the crash: the WAL holds everything after the snapshot
    folds, rows = _k_fold(torch, make(), reqs, "cuda")

    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec_engine = StreamingEngine(make(), **kw)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    counted = {k: n - before[k] for k, n in launch_counts().items()}
    snap = rec_engine.telemetry_snapshot()
    graphs = rec_engine.graph_stats()
    replays = sum(g["replays"] for g in graphs)
    _check(snap["recoveries"] == 1 and snap["replayed"] >= 1 and snap["failed"] == 0,
           f"{name}: recoveries {snap['recoveries']}, replayed {snap['replayed']}, failed {snap['failed']}")
    _check(snap["fused"] and snap["fused_fallbacks"] == 0 and rec_engine.device.type == "cuda",
           f"{name}: the recovery left the card's graphs (fused {snap['fused']}, device {rec_engine.device})")
    _check(replays == snap["replayed"], f"{name}: {replays} graph replays for {snap['replayed']} chunk records")
    compared = _m_equal(torch, _m_states(rec_engine), crashed, f"{name} recovered vs crashed")
    _k_check_states(torch, rec_engine, folds, rows, f"{name} recovered vs fold")
    in_replays = rec_engine.graph_launches()
    captured = {k: sum(g["captured_launches"].get(k, 0) for g in graphs) for k in kernels}
    for k in kernels:
        _check(in_replays.get(k, 0) > 0, f"{name}: {k} never launched in the replay ({in_replays})")
        # each graph's warm-up and capture run the wrappers once each: the counters
        # advance twice what a graph captured, never at a replay
        _check(counted.get(k, 0) == 2 * captured[k], f"{name}: {k} counted {counted.get(k, 0)}, "
               f"captured {captured[k]}")

    # the replay under the profiler: each hand kernel's device launches equal
    # captured x (replays + the warm-up); the recovery is repeatable (nothing is written)
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            again = StreamingEngine(make(), **kw)
            torch.cuda.synchronize()
        g2 = again.graph_stats()
        expected = {k: sum(g["captured_launches"].get(k, 0) * (g["replays"] + 1) for g in g2) for k in kernels}
        again.close(checkpoint=False)
        times = _kernel_times(prof, torch)
        seen = {k: sum(len(v) for n, v in times.items() if K_PROFILE_NAMES[k][0] in n) // K_PROFILE_NAMES[k][1]
                for k in kernels}
        if seen == expected or not times:
            break
    _check(seen == expected or not times, f"{name}: profiled launches {seen} vs captured x (replays + 1) {expected}")

    # a new tenant after recovery gets a fresh slot and a fresh state
    used = set(rec_engine._keyed._slots.values())
    args = reqs[0][1]
    rec_engine.submit("tenant-new", *args).result(timeout=300)
    rec_engine.flush(timeout=300)
    _check(rec_engine._keyed._slots["tenant-new"] not in used, f"{name}: the new tenant took an existing slot")
    fresh, fresh_rows = _k_fold(torch, make(), [("tenant-new", args)], "cuda")
    _k_check_states(torch, rec_engine, fresh, fresh_rows, f"{name} new tenant")
    folds.update(fresh)
    rows.update(fresh_rows)
    rec = {
        "requests": len(reqs), "snapshot_generation": gen, "snapshot_bytes": snapshot_bytes,
        "snapshot_write_ms": snapshot_write_ms, "recovery_ms": recovery_s * 1e3,
        "records_replayed": snap["replayed"], "rows_replayed": wal_rows, "replay_rows_per_s": wal_rows / recovery_s,
        # of the recovery: each graph's warm-up and capture, the rest is reading, restoring, replaying
        "capture_ms": sum(g["warmup_ms"] + g["capture_ms"] for g in graphs),
        "graphs_captured": len(graphs), "graph_replays": replays, "launches_in_replays": in_replays,
        "launches_counted": {k: counted.get(k, 0) for k in kernels}, "launches_profiled": seen,
        "profile_attempts": attempt + 1, "leaves_equal": compared,
    }
    print(f"phase M2 {name} {json.dumps(rec)}")
    return rec, rec_engine, folds, rows


def phase_m(torch, np, obs, instrument) -> dict:
    """The durable state plane on the card: M1 the checkpoint overhead, M2 crash
    and recovery, M3 snapshots across devices and save/restore."""
    import tempfile

    from metrics_tpu_torch import QuantileSketch
    from metrics_tpu_torch.engine import CheckpointConfig, StreamingEngine

    t0 = time.perf_counter()
    out = {"M1": phase_m1(torch, np, obs, instrument)}
    if os.path.isdir("/dev/shm"):
        # the same procedure in memory: what the filesystem adds to the overhead
        out["M1_shm"] = phase_m1(torch, np, obs, instrument, root="/dev/shm")
    rng = np.random.default_rng(17)

    def labels(n):
        return rng.integers(0, K2_CLASSES, n).astype(np.int64), rng.integers(0, K2_CLASSES, n).astype(np.int64)

    with tempfile.TemporaryDirectory() as qdir, tempfile.TemporaryDirectory() as fdir:
        out["M2_quantile"], engine, _, _ = _m2_crash_and_recover(
            torch, np, "quantile", QuantileSketch, _k_quantile_reqs(np, 19, M2_QUANTILE_REQUESTS, K_TENANTS),
            ("hist_add",), qdir)
        engine.close(checkpoint=False)
        flagship = [(f"tenant-{int(rng.integers(0, K_TENANTS))}", labels(int(rng.integers(K2_ROWS[0], K2_ROWS[1] + 1))))
                    for _ in range(M2_FLAGSHIP_REQUESTS)]
        out["M2_flagship"], engine, _, _ = _m2_crash_and_recover(
            torch, np, "flagship", _k2_metric, flagship, ("stat_scores", "pair_count"), fdir)

        # M3: the card's final snapshot restores into a CPU engine; the CPU engine's
        # snapshot, and the T record of an eviction after it, restore on the card
        card = _m_states(engine)
        engine.close()  # the final snapshot, written on the card
        kw = dict(buckets=K_BUCKETS, max_queue=K_QUEUE, capacity=K_TENANTS,
                  checkpoint=CheckpointConfig(directory=fdir, interval_s=3600.0, retain=M_RETAIN))
        cpu = StreamingEngine(_k2_metric("cpu"), **kw)
        try:
            snap = cpu.telemetry_snapshot()
            _check(snap["recoveries"] == 1 and snap["replayed"] == 0, f"M3 CPU: {snap['recoveries']} recoveries, "
                   f"{snap['replayed']} replayed")
            to_cpu = _m_equal(torch, _m_states(cpu), card, "M3 card snapshot on the CPU")
            _k_submit(cpu, flagship[:M3_CPU_REQUESTS], 1)
            cpu.checkpoint_now()
            _check(cpu.evict_tenant("tenant-3") is True, "M3: evict_tenant('tenant-3') on the CPU engine")
            on_cpu = _m_states(cpu)
        finally:
            cpu.close(checkpoint=False)
        back = StreamingEngine(_k2_metric("cuda"), **kw)
        try:
            snap = back.telemetry_snapshot()
            _check(snap["recoveries"] == 1 and snap["replayed"] == 1 and snap["failed"] == 0,
                   f"M3 card: {snap['recoveries']} recoveries, {snap['replayed']} replayed (the T record)")
            _check("tenant-3" not in back._keyed.keys, "M3: the evicted tenant is back after recovery")
            to_card = _m_equal(torch, _m_states(back), on_cpu, "M3 CPU snapshot on the card")
        finally:
            back.close(checkpoint=False)

        # MetricCollection.save/restore of the flagship collection on the card
        col = _k2_metric()
        for _ in range(3):
            col.update(*(torch.from_numpy(a).to("cuda") for a in labels(M3_BATCH)))
        path = os.path.join(fdir, "flagship.ckpt")
        col.save(path)
        restored, on_cpu_col = _k2_metric(), _k2_metric("cpu")
        restored.restore(path)
        on_cpu_col.restore(path)
        for name, m in col._modules.items():
            for state in m._defaults:
                for other in (restored, on_cpu_col):
                    got = getattr(other._modules[name], state)
                    _check(got.dtype == getattr(m, state).dtype and torch.equal(got.cpu(), getattr(m, state).cpu()),
                           f"M3 save/restore: {name}.{state} differs on {got.device}")
        # the values: equal on the card; on the CPU within the parity tolerance (the
        # macro F1's mean over 1000 classes adds in another order there)
        want, on_cpu_values = col.compute(), on_cpu_col.compute()
        for name, value in restored.compute().items():
            _check(torch.equal(value, want[name]), f"M3 save/restore: compute()[{name!r}] differs on the card")
            _check(torch.allclose(on_cpu_values[name].float(), want[name].cpu().float(), rtol=1e-6, atol=0),
                   f"M3 save/restore: compute()[{name!r}] on the CPU beyond rtol 1e-6")
        out["M3"] = {"card_to_cpu_leaves_equal": to_cpu, "cpu_to_card_leaves_equal": to_card,
                     "evicted_tenant_gone": True, "collection_snapshot_bytes": os.path.getsize(path),
                     "collection_groups": {k: list(v) for k, v in col.compute_groups.items()}}
        print(f"phase M3 {json.dumps(out['M3'])}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase M: {out['seconds']:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import metrics_tpu_torch.entry as entry_mod
    from metrics_tpu_torch import obs
    from metrics_tpu_torch.kernels import _build, cms_walk, confmat, scatter
    from metrics_tpu_torch.kernels import binned_curve as bc
    from metrics_tpu_torch.obs import instrument

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    # the card's integer issue rate: 128 lanes of each SM, one instruction each per clock
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_ops_per_s = sms * 128 * clock_mhz * 1e6
    print(f"issue rate: {sms} SMs x 128 lanes x {clock_mhz} MHz (clocks.max.sm) = {issue_ops_per_s} ops/s")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names = (confmat.KERNEL_NAME, scatter.KERNEL_NAME, bc.KERNEL_NAME, cms_walk.KERNEL_NAME)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all started together
        libs = dict(zip(names, pool.map(_build.build, names)))
    print(f"build {', '.join(f'{n}.cu' for n in names)}: {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"  {lib.name}")
        for ln in lib.with_suffix(".log").read_text().splitlines():
            if "ptxas" in ln or "spill" in ln:
                print(f"    {ln.strip()}")

    route_err = phase_a(torch, confmat)
    scatter_err = phase_a_scatter(torch, scatter)
    scatter_err["cms_rows_add"] = max(scatter_err["cms_rows_add"], phase_a_cms_ids(torch, scatter))
    walk_err = phase_a_walk(torch, scatter, cms_walk)
    launches, args, step = phase_b(torch, confmat, entry_mod)
    steps = phase_c_steps(torch, entry_mod, step, args)
    main_shape = phase_c_kernel(torch, confmat, n=entry_mod.FULL_CONFIG["batch"], classes=entry_mod.FULL_CONFIG["classes"])
    six_shape = phase_c_kernel(torch, confmat, n=SIX_N, classes=SIX_C)  # Phase J2's shape, shared memory
    phase_d_profile(torch, entry_mod, step, args)
    del args, step
    sketch_launches, sketch_data = phase_e(torch, scatter, cms_walk, obs, instrument)
    sketch_recs = phase_f(torch, scatter, cms_walk, sketch_data, issue_ops_per_s, clock_mhz * 1e6)
    del sketch_data
    curve_err = phase_g(torch, bc)
    curve_launches, curve_data = phase_h(torch, bc, obs, instrument)
    curve_recs = phase_i(torch, bc, curve_data)
    del curve_data
    collection_step = phase_j1(torch, entry_mod, obs, instrument, steps)
    six = phase_j2(torch, obs, instrument)
    phase_j3(torch)
    engine = phase_k(torch, scatter)
    import numpy as np

    classification_l = phase_l(torch, np)
    durable = phase_m(torch, np, obs, instrument)

    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms")
    what = {"pair_count": ("train step, global atomics", "six-metric collection update, shared memory, clusters of 2"),
            "stat_scores": ("train step, one block", "six-metric collection update")}
    replaces = {"pair_count": "metrics_tpu/kernels/confmat.py:126",
                "stat_scores": "metrics_tpu/kernels/confmat.py:126, "
                               "metrics_tpu/functional/classification/stat_scores.py:334-339"}
    kernels = []
    for route in ROUTES:
        main, six_rec = main_shape[route], six_shape[route]
        kernels.append({
            "name": route,
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/pair_count.cu",
            "replaces": replaces[route],
            "launches": launches[route],
            "max_abs_err": route_err[route],
            **{k: main[k] for k in fields},
            "shapes": [{"shape": f"N={r['n']}, {r['rows']} x {r['cols']} int64 labels ({w})",
                        **{k: r[k] for k in fields}} for r, w in zip((main, six_rec), what[route])],
            # launches of each path's run: the dict step (Phase B), the same three metrics in a
            # collection (J1), the six-metric collection with groups on and off (J2)
            "launches_by_path": {
                "phase_b_dict_step": launches[route],
                "phase_j1_collection_and_dict_steps": collection_step["launches"][route],
                "phase_j1_per_step": {k: v[route] for k, v in collection_step["launches_per_step"].items()},
                "phase_j2_per_update": {k: v[route] for k, v in six["launches_per_update"].items()},
                "phase_j2_forming_update": six["launches_forming_update"][route],
            },
        })
    shape_fields = ("shape", *fields)
    for kernel, rec, shapes in (
        ("hist_add", sketch_recs["hist_add"], ()),
        ("hist_max", sketch_recs["hist_max_p12"], (sketch_recs["hist_max_p12"], sketch_recs["hist_max_p16"])),
        # the ids route is the main path's (cms_table_update on the card); the columns route the registry's
        ("cms_rows_add", sketch_recs["cms_rows_add_ids"],
         (sketch_recs["cms_rows_add_ids"], sketch_recs["cms_rows_add"])),
    ):
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/scatter.cu",
            "replaces": "metrics_tpu/kernels/scatter.py:84",
            "launches": sketch_launches[kernel],
            "max_abs_err": scatter_err[kernel],
            **{k: rec[k] for k in fields},
            **({"shapes": [{k: r[k] for k in shape_fields} for r in shapes]} if shapes else {}),
        })
    walk = sketch_recs[f"cms_walk_{HH_BATCH}"]
    kernels.append({
        "name": "cms_walk",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/cms_walk.cu",
        "replaces": "metrics_tpu/sketch/kernels.py:296",
        "launches": sketch_launches["cms_walk"],
        "max_abs_err": walk_err,
        **{k: walk[k] for k in fields},
        **{k: walk[k] for k in WALK_FIELDS},
        "shapes": [{k: sketch_recs[f"cms_walk_{n}"][k] for k in (*shape_fields, *WALK_FIELDS)} for n in WALK_SHAPES],
    })
    main_curve = curve_recs[f"T{CURVE_T}_C1"]
    kernels.append({
        "name": "binned_curve",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/binned_curve.cu",
        "replaces": "metrics_tpu/kernels/binned_curve.py:45",
        "launches": curve_launches,
        "max_abs_err": curve_err["max_abs_err"],
        **{k: main_curve[k] for k in fields},
        "shapes": [{k: curve_recs[key][k] for k in shape_fields}
                   for key in (f"T{CURVE_T}_C1", "T1024_C1", f"T{CURVE_T}_C{CURVE_COLS}")],
    })
    print(json.dumps({"step": steps, "collection_step": collection_step, "six_metric_collection": six,
                      "engine": engine, "binary_multilabel_mse": classification_l, "durable": durable,
                      "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
