"""Where the host time of a pair-count call goes, and the kernel's device time.

Run on a machine with a CUDA GPU and ``nvcc``, from anywhere:

    python3 scripts/time_pair_count.py [--root DIR] [--label NAME] [--device-only]

It imports ``metrics_tpu_torch`` from ``DIR`` (default: the checkout that holds
this script) and builds its ``csrc/pair_count.cu``, so that two trees (a parent
commit and a change, or an edited copy of one) can be compared in one session:
run it on each, in the order A, B, B, A. Both wrapper generations are handled:
the table route's C interface before and after it took int64 labels, and the
stat-score route where the tree has one.

At the training step's shape (N = 1024, 1000 classes) and the six-metric
collection's (N = 10^6, 100 classes), on int32 and on int64 labels, it prints
one JSON line per route and shape, all times in µs:

- ``call_us``: host wall time of one wrapper call, back to back (the kernels
  take a few µs, so the device never holds the host back);
- ``events_us``: the same calls by CUDA events (what ``chip_smoke.py`` Phase C
  reports as ``ms``);
- the parts of a call: ``prep_us`` (the wrapper's checks and views of the
  labels, casts included where the tree makes them), ``zeros_us`` (the
  output's allocation and fill), ``stream_us`` (entering the device and reading
  the current stream), ``c_launch_us`` (the C function alone: its device
  queries and the launch);
- ``device_us``: the kernel's device time per call from ``torch.profiler``
  (alone with ``--device-only``, on int64 labels: for kernel variants).

The last line is ``{"ok": true, ...}``. It exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHAPES = (("train_step", 1024, 1000), ("six_metric_update", 10**6, 100))
CALLS = 2000  # back-to-back calls per timing
REPEATS = 5  # timings per quantity; the median is kept


def _host_us(fn, torch) -> float:
    """Median over REPEATS of the mean host wall time of one call of ``fn``."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(REPEATS):
        start = time.perf_counter()
        for _ in range(CALLS):
            fn()
        runs.append((time.perf_counter() - start) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def _events_us(fn, torch) -> float:
    """Median over REPEATS of one call's share of back-to-back calls, by CUDA events."""
    runs = []
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / CALLS * 1e3)
    return statistics.median(runs)


def _device_us(fn, torch, match: str, calls: int = 50, tries: int = 3):
    """Mean device µs of the kernels whose names hold ``match``, per call, over the
    launches ``torch.profiler`` recorded in ``calls`` calls; None if it recorded
    fewer than half of them in every try."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
        if 2 * len(times) >= calls:
            return sum(times) / len(times)
    return None


def _table_parts(torch, confmat, r, c, classes: int) -> dict:
    """The parts of one ``pair_count_cuda`` call, for either generation of the wrapper."""
    lib = confmat._lib()
    dev = r.device
    new = hasattr(confmat, "_labels")  # the wrapper that reads int64 labels as they are
    if new:
        # the caller's name joined _ignore_args' parameters with the int32 check
        named = len(inspect.signature(confmat._ignore_args).parameters) == 2
        ignore_args = (lambda: confmat._ignore_args(None, "x")) if named else (lambda: confmat._ignore_args(None))
        prep = lambda: (confmat._labels(r, c, "x"), ignore_args())  # noqa: E731
        rr, cc = confmat._labels(r, c, "x")
    else:
        prep = lambda: (confmat._as_index(r, "row_idx"), confmat._as_index(c, "col_idx"))  # noqa: E731
        rr, cc = confmat._as_index(r, "row_idx"), confmat._as_index(c, "col_idx")
    out = torch.zeros((classes, classes), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = rr.numel()
    if new:
        args = [rr.data_ptr(), rr.element_size() == 8, cc.data_ptr(), cc.element_size() == 8, None, n,
                classes, classes, 0, 0]
        if len(lib.pair_count_launch.argtypes) == 13:  # a tree whose C interface took a cluster size
            args.append(0)
        args += [out.data_ptr(), stream]
    else:
        args = [rr.data_ptr(), cc.data_ptr(), None, n, classes, classes, out.data_ptr(), stream]

    def stream_part():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    return {
        "prep_us": _host_us(prep, torch),
        "zeros_us": _host_us(lambda: torch.zeros((classes, classes), dtype=torch.int32, device=dev), torch),
        "stream_us": _host_us(stream_part, torch),
        "c_launch_us": _host_us(lambda: lib.pair_count_launch(*args), torch),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                        help="checkout whose metrics_tpu_torch is timed")
    parser.add_argument("--label", default="", help="name of the tree in the output")
    parser.add_argument("--device-only", action="store_true", help="only device_us, on int64 labels")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_pair_count: no CUDA GPU", file=sys.stderr)
        return 1
    from metrics_tpu_torch.kernels import confmat

    if Path(confmat.__file__).resolve().parents[2] != Path(args.root).resolve():
        raise RuntimeError(f"imported {confmat.__file__}, not the tree at {args.root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(99)
    for shape, n, classes in SHAPES:
        t64 = torch.randint(0, classes, (n,), generator=gen).cuda()
        p64 = torch.randint(0, classes, (n,), generator=gen).cuda()
        for dtype in ("int64",) if args.device_only else ("int32", "int64"):
            t, p = (t64, p64) if dtype == "int64" else (t64.to(torch.int32), p64.to(torch.int32))
            routes = [("pair_count", lambda: confmat.pair_count_cuda(t, p, classes, classes), "pair_count_")]
            if hasattr(confmat, "stat_scores_cuda"):
                routes.append(("stat_scores", lambda: confmat.stat_scores_cuda(t, p, classes), "stat_scores_kernel"))
            for route, fn, match in routes:
                rec = {"label": args.label, "route": route, "shape": shape, "n": n, "classes": classes,
                       "labels": dtype}
                if not args.device_only:
                    rec.update(call_us=_host_us(fn, torch), events_us=_events_us(fn, torch))
                    if route == "pair_count":
                        rec.update(_table_parts(torch, confmat, t, p, classes))
                rec["device_us"] = _device_us(fn, torch, match)
                rec["card"] = card
                print(json.dumps(rec), flush=True)
    print(json.dumps({"ok": True, "label": args.label, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
