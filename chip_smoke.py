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
  version: both branches (a shared-memory table, one above 48 KB of dynamic
  shared memory, and global atomics), ragged and tiny N, N = 0, out-of-range
  indices, zero weights, int32 extremes and Zipf-skewed keys.
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

The second-to-last line of output is a JSON object with one record per
kernel; the last is ``{"ok": true, "device": {...}}``. Any failure raises,
and the script exits non-zero without those lines. Without a GPU it exits
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
        ("hll_p16", "max", SKETCH_BATCH, 2**16, (0, 2**16), "rank"),  # 256 KB: global atomics
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

    for name, op, n, n_bins, index, values in _scatter_hist_cases():
        kernel = f"hist_{op}"
        if index == "zipf":
            idx = _zipf(torch, n, gen, n_ids=n_bins)
        else:
            idx = torch.randint(index[0], index[1], (n,), generator=gen, device="cuda", dtype=torch.int32)
        vals = _scatter_values(torch, values, n, gen)
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
        branch = "shared" if scatter.uses_shared_branch(n_bins) else "global"
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
    kernels, _ = _profile_steps(torch, run, 20)
    times = [us for name, v in kernels.items() if f"{kernel}_" in name for us in v]
    device_ms = sum(times) / len(times) / 1e3 if times else None
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
        {"shape": f"N={n}, 2048 bins (the quantile sketch's positive store)"})

    for p in (12, 16):
        reg_idx, rank = sk.hll_registers(ids0, p=p)
        regs = torch.zeros(1 << p, dtype=torch.int32, device="cuda")
        lib_regs, reg_idx64 = regs.clone(), reg_idx.to(torch.int64)
        recs[f"hist_max_p{p}"] = _kernel_record(
            torch, "hist_max", lambda: scatter.hist_max_cuda(regs, reg_idx, rank),
            lambda: scatter.hist_max_reference(regs, reg_idx, rank),
            lambda: lib_regs.scatter_reduce_(0, reg_idx64, rank, "amax", include_self=True),
            8 * n + 8 * (1 << p), 3 * n, {"shape": f"N={n}, 2^{p} registers"})

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
    from metrics_tpu_torch.obs import instrument

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names = (confmat.KERNEL_NAME, scatter.KERNEL_NAME)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all started together
        libs = dict(zip(names, pool.map(_build.build, names)))
    print(f"build {', '.join(f'{n}.cu' for n in names)}: {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"  {lib.name}")
        for ln in lib.with_suffix(".log").read_text().splitlines():
            if "ptxas" in ln:
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
    for kernel, rec in (("hist_add", sketch_recs["hist_add"]), ("hist_max", sketch_recs["hist_max_p12"]),
                        ("cms_rows_add", sketch_recs["cms_rows_add"])):
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/scatter.cu",
            "replaces": "metrics_tpu/kernels/scatter.py:84",
            "launches": sketch_launches[kernel],
            "max_abs_err": scatter_err[kernel],
            **{k: rec[k] for k in fields},
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
