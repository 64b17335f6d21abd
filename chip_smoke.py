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

The second-to-last line of output is a JSON object with one record per
kernel; the last is ``{"ok": true, "device": {...}}``. Any failure raises,
and the script exits non-zero without those lines. Without a GPU it exits
non-zero at once. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores, taken for int32 ALU work
FLAGSHIP_STEPS = 20
TIMING_REPS = 5


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import metrics_tpu_torch.entry as entry_mod
    from metrics_tpu_torch.kernels import _build, confmat

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = _build.build(confmat.KERNEL_NAME)
    print(f"build pair_count.cu: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines() if "ptxas" in ln]
    for ln in ptxas:
        print(f"  {ln}")

    max_abs_err = phase_a(torch, confmat)
    launches, args, step = phase_b(torch, confmat, entry_mod)
    steps = phase_c_steps(torch, entry_mod, step, args)
    main_shape = phase_c_kernel(torch, confmat, n=entry_mod.FULL_CONFIG["batch"],
                                rows=entry_mod.FULL_CONFIG["classes"], cols=entry_mod.FULL_CONFIG["classes"])
    phase_c_kernel(torch, confmat, n=2**20, rows=100, cols=100)
    phase_d_profile(torch, entry_mod, step, args)

    kernels = [{
        "name": "pair_count",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/pair_count.cu",
        "replaces": "metrics_tpu/kernels/confmat.py:126",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "device_ms": main_shape["device_ms"],
    }]
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
