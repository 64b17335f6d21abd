"""Smoke run of metrics_tpu_torch on one NVIDIA GPU (H100): build, check, time.

Run from the root of a checkout, on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

It builds every CUDA kernel of the port's main path from the sources in the
checkout, and then:

- Phase A holds each kernel against its plain PyTorch version on the card
  (``torch.equal`` on int32 counts) at the training step's shape and others:
  both branches of the pair-count kernel, a ragged length, a mask,
  out-of-range and negative indices, and N = 0.
- Phase B drives the main path through the user's entry point
  (``metrics_tpu_torch.entry.entry``): the fused Accuracy + F1 +
  ConfusionMatrix training step at batch 1024, hidden 4096, 1000 classes,
  8 layers. Kernel launch counts are zeroed just before and read just after;
  each step must launch the pair-count kernel exactly 3 times. The card's
  metric states are held bit for bit against a CPU recomputation from the
  same predictions. The stateful ``update``/``forward``/``compute``/``reset``
  path runs once on the card too.
- Phase C times the bare and the fused step, and each kernel against its
  plain version, one PyTorch library call, and its memory bound. ``ms`` is
  the wrapper's call time by CUDA events over back-to-back calls;
  ``device_ms`` is the kernel's own device time from ``torch.profiler``.
- Phase D profiles the bare step, the fused step and the fused step's metric
  updates alone: device busy time and idle share per step, and device time
  by kernel.
- Phase A also holds each scatter kernel of the sketch plane (``hist_add``,
  ``hist_max``, ``cms_rows_add`` of ``csrc/scatter.cu``) against its plain
  version: every branch (a shared-memory table, one above 48 KB of dynamic
  shared memory, hist_max's packed int16 table for tables beyond one block,
  and global atomics),
  ragged and tiny N, N = 0, out-of-range indices, zero weights, int32
  extremes, Zipf-skewed keys, and inputs that are views at a storage offset
  with N % 4 != 0 (idx and val at one offset and at two).
- Phase E drives the sketch plane at the JAX classes' default sizes through
  the functional API and once through the stateful one: QuantileSketch
  (alpha 0.01, 2048 buckets), CardinalitySketch (p = 12 and 16) and the
  4 x 2048 count-min table on 8 batches of 2^22 values, HeavyHittersSketch
  (k 32, 4 x 2048) on 4 batches of 4096 ids. Launch counts are zeroed just
  before and read just after: 2 hist_add per quantile update, 1 hist_max per
  cardinality update, 1 cms_rows_add per table update, none for the
  heavy-hitter ledger walk, and no reference dispatch on a CUDA tensor. The
  int32 states are held against a CPU recomputation and the merge of two
  half-streams against the single stream.
- Phase F times each scatter kernel at the Phase E shapes (call, device,
  plain version, one PyTorch library call, byte bound), each sketch's update
  and values/s, the ledger walk per item, and profiles one quantile update.
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

The second-to-last line of output is a JSON object with one record per
kernel (``shapes`` lists every shape a redesigned kernel was timed at); the
last is ``{"ok": true, "device": {...}}``. Any failure raises, and the script
exits non-zero without those lines. Without a GPU it exits
non-zero at once. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
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
HH_BATCH = 4096  # ids per heavy-hitter update: its ledger walk is one item at a time
HH_BATCHES = 4  # fewer than SKETCH_BATCHES: the walk takes about 0.4 ms per item on the card
CURVE_N = 10**6  # scores per curve update in Phases G to I
CURVE_T = 200
CURVE_UPDATES = 8
CURVE_COLS = 10
EXACT_N = 2**20
ZIPF_IDS = 10**7
ZIPF_S = 1.1
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


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
    """(name, n, rows, cols, index range, masked) of the Phase A cases."""
    return [
        ("train_step", 1024, 1000, 1000, (0, 1000), False),  # the main path's global-atomic branch
        ("shared_1M", 2**20, 100, 100, (0, 100), False),  # the shared-memory branch
        ("ragged", 4097, 7, 23, (0, 23), False),
        ("masked", 65539, 50, 50, (0, 50), True),
        ("out_of_range", 10000, 20, 20, (-5, 25), False),
        ("out_of_range_global_masked", 9999, 1000, 1000, (-7, 1007), True),
        ("empty", 0, 5, 5, (0, 5), False),
    ]


def phase_a(torch, confmat) -> int:
    """Every pair-count case: kernel vs plain version on the same CUDA inputs."""
    gen = torch.Generator().manual_seed(1234)
    worst = 0
    for name, n, rows, cols, (lo, hi), masked in _pair_count_cases():
        r = torch.randint(lo, hi, (n,), generator=gen).to(torch.int32).cuda()
        c = torch.randint(lo, hi, (n,), generator=gen).to(torch.int32).cuda()
        m = torch.randint(0, 2, (n,), generator=gen).bool().cuda() if masked else None
        before = confmat.launches
        got = confmat.pair_count_cuda(r, c, rows, cols, m)
        torch.cuda.synchronize()
        want = confmat.pair_count_bincount(r, c, rows, cols, m)
        _check(got.dtype == torch.int32 and got.shape == (rows, cols), f"{name}: {got.dtype} {tuple(got.shape)}")
        _check(torch.equal(got, want), f"{name}: kernel differs from pair_count_bincount")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        worst = max(worst, err)
        _check(confmat.launches == before + (1 if n else 0), f"{name}: launch count")
        branch = "none (N = 0)" if n == 0 else ("shared" if confmat.uses_shared_branch(rows, cols) else "global")
        print(f"phase A {name}: N={n} R={rows} C={cols} mask={masked} branch={branch} "
              f"equal=True max_abs_err={err} total={int(want.sum())}")
    _check(not confmat.uses_shared_branch(1000, 1000), "1000x1000 must take the global-atomic branch")
    _check(confmat.uses_shared_branch(100, 100), "100x100 must take the shared-memory branch")
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

    confmat.launches = 0  # the main path's run starts here
    t0 = time.perf_counter()
    losses = []
    for _ in range(FLAGSHIP_STEPS + 1):
        loss, params, states = step(params, states, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = confmat.launches  # ... and ends here
    del spied.update_state
    n_steps = FLAGSHIP_STEPS + 1
    print(f"phase B ran {n_steps} steps in {wall:.3f} s; pair_count launches={launches}")
    _check(launches == 3 * n_steps, f"expected {3 * n_steps} pair_count launches, got {launches}")
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


def phase_c_kernel(torch, confmat, n, rows, cols):
    """Kernel, plain version, library call and bound at one shape."""
    gen = torch.Generator().manual_seed(99)
    r = torch.randint(0, rows, (n,), generator=gen).to(torch.int32).cuda()
    c = torch.randint(0, cols, (n,), generator=gen).to(torch.int32).cuda()
    key = r.to(torch.int64) * cols + c
    iters = 200
    ms = _time_ms(lambda: confmat.pair_count_cuda(r, c, rows, cols), iters)
    plain_ms = _time_ms(lambda: confmat.pair_count_bincount(r, c, rows, cols), iters)
    library_ms = _time_ms(lambda: torch.bincount(key, minlength=rows * cols + 1), iters)
    nbytes = 2 * 4 * n + 4 * rows * cols  # two int32 index streams read, the int32 table written
    ops = 4 * n  # per pair: two range compares, one key multiply-add, one increment
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    kernels, _ = _profile_steps(torch, lambda: confmat.pair_count_cuda(r, c, rows, cols), 20)
    launches = [us for name, v in kernels.items() if "pair_count" in name for us in v]
    device_ms = sum(launches) / len(launches) / 1e3 if launches else None
    rec = {"n": n, "rows": rows, "cols": cols, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops}
    print(f"phase C pair_count {json.dumps(rec)}")
    return rec


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
    pair = [us for name, v in metric_kernels.items() if "pair_count" in name for us in v]
    top = sorted(metric_kernels.items(), key=lambda kv: -sum(kv[1]))[:12]
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


def phase_e(torch, scatter, obs, instrument):
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
    # name: (init, update, merge, batches, launches per update)
    paths = {
        "quantile": (q.init_state, q.update_state, q.merge_states, lat, {"hist_add": 2}),
        "cardinality_p12": (c12.init_state, c12.update_state, c12.merge_states, ids, {"hist_max": 1}),
        "cardinality_p16": (c16.init_state, c16.update_state, c16.merge_states, ids, {"hist_max": 1}),
        "count_min_4x2048": (table_zeros, sk.cms_table_update, lambda a, b: a + b, ids, {"cms_rows_add": 1}),
        "heavy_hitters": (hh.init_state, hh.update_state, hh.merge_states, hh_ids, {}),
    }
    states, launches, walls = {}, {k: 0 for k in scatter.launches}, {}
    obs.enable()
    try:
        for name, (init, update, merge, batches, per_update) in paths.items():
            instrument.KERNEL_DISPATCHES.clear()
            for k in scatter.launches:  # the main path's run starts here ...
                scatter.launches[k] = 0
            half = len(batches) // 2
            t0 = time.perf_counter()
            first = _fold(init, update, batches[:half])
            single = first
            for b in batches[half:]:
                single = update(single, b)
            second = _fold(init, update, batches[half:])
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            counted = dict(scatter.launches)  # ... and ends here
            n_updates = len(batches) + half
            want = {k: per_update.get(k, 0) * n_updates for k in counted}
            _check(counted == want, f"{name}: launches {counted}, expected {want}")
            for kernel, entry in ENTRY_OF.items():
                ref = instrument.KERNEL_DISPATCHES.value(kernel=entry, impl="reference")
                opt = instrument.KERNEL_DISPATCHES.value(kernel=entry, impl="optimized")
                _check(ref == 0, f"{name}: {ref} reference dispatches of {entry} on a CUDA tensor")
                _check(opt == want[kernel], f"{name}: {opt} kernel dispatches of {entry}, expected {want[kernel]}")
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
    h_cpu = HeavyHittersSketch(k=32, depth=4, width=2048, device="cpu")
    first_cpu = _fold(h_cpu.init_state, h_cpu.update_state, cpu["hh"][:half])
    single_cpu = _fold(lambda: first_cpu, h_cpu.update_state, cpu["hh"][half:])
    second_cpu = _fold(h_cpu.init_state, h_cpu.update_state, cpu["hh"][half:])
    for card, host, what in ((first, first_cpu, "first half"), (second, second_cpu, "second half"),
                             (single, single_cpu, "single stream")):
        _equal_states(torch, card, host, f"heavy hitters ({what}) against the CPU recomputation")
    _check(torch.equal(merged["counts"], single["counts"]), "heavy-hitter counts: merge != single stream")
    _check(torch.equal(merged["ledger"].cpu(), sk.topk_merge(torch.stack([first_cpu["ledger"], second_cpu["ledger"]]))),
           "heavy-hitter merged ledger differs from topk_merge on the CPU")
    top_keys, top_counts = hh.compute_from(single)
    cpu_keys, cpu_counts = h_cpu.compute_from(single_cpu)
    _check(torch.equal(top_keys.cpu(), cpu_keys) and torch.equal(top_counts.cpu(), cpu_counts), "hh_rank differs")
    print(f"phase E heavy_hitters: counts and ledger bit-identical to the CPU (both halves and the single stream); "
          f"merged counts == single stream, merged ledger == topk_merge on the CPU; top 5 "
          f"{list(zip(top_keys[:5].tolist(), top_counts[:5].tolist()))}")

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


def _kernel_record(torch, kernel: str, run, plain, library, nbytes: int, ops: int, extra: dict) -> dict:
    """Kernel, plain version, library call and bound at one shape."""
    iters = 50
    ms = _time_ms(run, iters)
    plain_ms = _time_ms(plain, 10, warmup=2)
    library_ms = _time_ms(library, iters)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    device_ms = _per_call_ms(_call_kernels(torch, run, f"{kernel}_", 1))
    rec = {**extra, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops}
    print(f"phase F {kernel} {json.dumps(rec)}")
    return rec


def phase_f(torch, scatter, data) -> dict:
    """Each scatter kernel at the Phase E shapes; each sketch's update; one profiled quantile update."""
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
    recs["cms_rows_add"] = _kernel_record(
        torch, "cms_rows_add", lambda: scatter.cms_rows_add_cuda(counts, cols, valid),
        lambda: scatter.cms_rows_add_reference(counts, cols, valid), lambda: flat.index_add_(0, key, inc),
        4 * 4 * n + n + 8 * 4 * 2048, 3 * 4 * n, {"shape": f"N={n}, 4 x 2048 table"})

    # per-update time and values/s of each sketch on one batch
    updates = {}
    for name, (init, update, _, batches, _) in data["paths"].items():
        state, batch = init(), batches[0]
        reps = 1 if name == "heavy_hitters" else 10
        ms = _time_ms(lambda: update(state, batch), reps, warmup=1)
        updates[name] = {"values": batch.numel(), "ms_per_update": ms, "values_per_s": batch.numel() / ms * 1e3}
    updates["heavy_hitters"]["us_per_item"] = updates["heavy_hitters"]["ms_per_update"] * 1e3 / HH_BATCH
    print(f"phase F sketch updates {json.dumps(updates)}")

    # one quantile update under the profiler: device time by kernel and idle share
    init, update = data["paths"]["quantile"][:2]
    state = init()
    kernels, wall_us = _profile_steps(torch, lambda: update(state, lat0), 5)
    busy_us = sum(sum(v) for v in kernels.values())
    profile = {
        "device_busy_us_per_update": busy_us / 5,
        "wall_us_per_update_under_profiler": wall_us / 5,
        "idle_share": 1.0 - busy_us / wall_us if wall_us else None,
        "launches_per_update": sum(len(v) for v in kernels.values()) / 5,
        "top_kernels": [
            {"name": name[:90], "launches_per_update": len(v) / 5, "us_per_update": sum(v) / 5}
            for name, v in sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:10]
        ],
    }
    print(f"phase F quantile update profile {json.dumps(profile)}")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import metrics_tpu_torch.entry as entry_mod
    from metrics_tpu_torch import obs
    from metrics_tpu_torch.kernels import _build, confmat, scatter
    from metrics_tpu_torch.kernels import binned_curve as bc
    from metrics_tpu_torch.obs import instrument

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names = (confmat.KERNEL_NAME, scatter.KERNEL_NAME, bc.KERNEL_NAME)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all started together
        libs = dict(zip(names, pool.map(_build.build, names)))
    print(f"build {', '.join(f'{n}.cu' for n in names)}: {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"  {lib.name}")
        for ln in lib.with_suffix(".log").read_text().splitlines():
            if "ptxas" in ln or "spill" in ln:
                print(f"    {ln.strip()}")

    max_abs_err = phase_a(torch, confmat)
    scatter_err = phase_a_scatter(torch, scatter)
    launches, args, step = phase_b(torch, confmat, entry_mod)
    steps = phase_c_steps(torch, entry_mod, step, args)
    main_shape = phase_c_kernel(torch, confmat, n=entry_mod.FULL_CONFIG["batch"],
                                rows=entry_mod.FULL_CONFIG["classes"], cols=entry_mod.FULL_CONFIG["classes"])
    phase_c_kernel(torch, confmat, n=2**20, rows=100, cols=100)
    phase_d_profile(torch, entry_mod, step, args)
    del args, step
    sketch_launches, sketch_data = phase_e(torch, scatter, obs, instrument)
    sketch_recs = phase_f(torch, scatter, sketch_data)
    del sketch_data
    curve_err = phase_g(torch, bc)
    curve_launches, curve_data = phase_h(torch, bc, obs, instrument)
    curve_recs = phase_i(torch, bc, curve_data)

    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms")
    kernels = [{
        "name": "pair_count",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/pair_count.cu",
        "replaces": "metrics_tpu/kernels/confmat.py:126",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **{k: main_shape[k] for k in fields},
    }]
    shape_fields = ("shape", *fields)
    for kernel, rec, shapes in (
        ("hist_add", sketch_recs["hist_add"], ()),
        ("hist_max", sketch_recs["hist_max_p12"], (sketch_recs["hist_max_p12"], sketch_recs["hist_max_p16"])),
        ("cms_rows_add", sketch_recs["cms_rows_add"], ()),
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
    print(json.dumps({"step": steps, "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
