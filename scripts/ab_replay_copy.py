"""A replayed record's host-to-device copy, before and after it copied each column
once, and ``chip_smoke.py`` Phases P3 and P4 alone.

Run on a machine with a CUDA GPU and ``nvcc``, from the root of a checkout:

    python3 scripts/ab_replay_copy.py [P3] [P4]

The earlier copy (``np.array(arr, copy=True)``, then ``Tensor.pin_memory()``,
two host copies) and the engine's ``_to_device_async`` (one copy into a pinned
tensor) are timed in the order A, B, B, A, three rounds, on the columns a
replay copies (int64 labels at both buckets, a bool mask, float32 values, a
one-element int32 column, and a read-only int64 view as the WAL decoder gives):
``micro_us`` holds each variant's sorted µs a call. Then Phase P3 runs once with
each copy in the same order, by swapping the engine's module function, and
prints each metric's replay and held live rows/s, the replay's idle share, the
promotion ms and the lag's peak seconds; then Phase P4 once. Each line is
printed beside the collector's state (on, and no capture pausing it). It exits
1 without a GPU.
"""

import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def two_copies(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """The replay's copy before it copied once."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_replay_copy: torch.cuda.is_available() is False; this needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from metrics_tpu_torch.engine import runtime
    from metrics_tpu_torch.kernels import _build, confmat, scatter
    from metrics_tpu_torch.utils import graphs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.build, (confmat.KERNEL_NAME, scatter.KERNEL_NAME)))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    one_copy = runtime._to_device_async
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    arrays = {"i64_256": rng.integers(0, 1000, 256), "i64_64": rng.integers(0, 1000, 64),
              "bool_256": rng.integers(0, 2, 256).astype(bool), "f32_256": rng.random(256).astype(np.float32),
              "i32_1": np.zeros(1, np.int32)}
    arrays["ro_i64_256"] = np.frombuffer(arrays["i64_256"].tobytes(), np.int64)
    order = (("old", two_copies), ("new", one_copy), ("new", one_copy), ("old", two_copies))
    micro = {}
    for _ in range(3):
        for label, fn in order:
            for name, a in arrays.items():
                for _ in range(200):
                    fn(a, dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(3000):
                    fn(a, dev)
                torch.cuda.synchronize()
                micro.setdefault(f"{label} {name}", []).append((time.perf_counter() - t) / 3000 * 1e6)
    print("micro_us", json.dumps({k: sorted(v) for k, v in micro.items()}), flush=True)

    which = sys.argv[1:] or ["P3", "P4"]
    if "P3" in which:
        for label, fn in order:
            runtime._to_device_async = fn
            t = time.perf_counter()
            r = cs.phase_p3(torch, np)
            brief = {name: {k: r[name][k] for k in ("replay_rows_per_s", "live_rows_per_s_held_segment",
                                                    "replay_idle_share", "promote_ms", "lag_peak_s")} for name in r}
            print("P3", label, json.dumps(brief), f"{time.perf_counter() - t:.1f} s",
                  "gc", gc.isenabled(), graphs._collector_pauses, flush=True)
        runtime._to_device_async = one_copy
    if "P4" in which:
        t = time.perf_counter()
        cs.phase_p4(torch, np)
        print("P4 done", f"{time.perf_counter() - t:.1f} s", "gc", gc.isenabled(), graphs._collector_pauses,
              flush=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
