"""The heavy-hitter ledger walk's time at a heavy-hitter batch, and where its cycles go.

Two steps. First, on any machine, make a copy of a tree whose walk records
``clock64()`` as it goes:

    python3 scripts/time_cms_walk.py --instrument SRC --out DST

copies ``SRC/metrics_tpu_torch`` to ``DST/metrics_tpu_torch`` and edits the copy
of ``csrc/cms_walk.cu``: the walk reads the SM clock at fixed points of each
chunk or step and thread 0 adds the cycles between them into one total per part, which
a C function ``cms_walk_clock_parts`` hands back. Two generations of the walk
are recognised:

- ``per-item`` (one kernel, each chunk's estimates on the walker's chain):
  ``load`` (the ids), ``hash`` (the columns), ``match_table`` (the
  ``__match_any_sync`` rounds and the table's read-modify-writes),
  ``holds`` (the presence test and the ballot) and ``decisions`` (the items
  decided one at a time);
- ``step`` (the estimates in kernels of their own; k <= 32 walked by 16
  warps, 512 items a step), per warp: ``load`` (ids and estimates), ``where`` (the
  presence test, a lookup in the table of the keys), ``candidate`` (each warp's first
  candidate, the first barrier, the step's first candidate), ``raises`` (the
  raises applied at once), ``barrier`` (the second barrier, which ORs whether
  curmin may have moved) and ``refresh`` (the new curmin; with a candidate,
  warp 0's exact decision, the third barrier, the snapshot's update). Thread 0's clock is
  the one summed, so a part that waits at a barrier holds the wait.

Then, on a machine with a CUDA GPU and ``nvcc``:

    python3 scripts/time_cms_walk.py --root DIR [--label NAME]

imports ``metrics_tpu_torch`` from ``DIR`` (default: the checkout that holds
this script), builds its walk, and walks N = 2^17 Zipf(1.1) ids over 10^7 (the
same draw for every tree) into an empty 4 x 2048 table and k = 32 ledger. It
prints one JSON line: ``call_ms`` (CUDA events over back-to-back calls),
``device_ms`` (``torch.profiler``, every kernel of a call) and
``device_ms_by_kernel``, and for an instrumented tree the cycles of each part
summed over one call, per unit (a chunk of 32 or a step) and per item,
with the card's name and power limit. To compare trees, run it on each in
the order A, B, B, A on one card, one after another. It exits 1 without a
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

N_IDS = 2**17
SEED = 2024
CALLS = 20

# The instrumentation: a device array of part totals and the C function that reads and clears it.
_HEADER = """
// ---- instrumented copy (scripts/time_cms_walk.py): cycles of the walk by part
__device__ unsigned long long g_clock_parts[8];
#define CLK_INIT long long clk_t = clock64(); unsigned long long clk_p[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define CLK(p) { const long long t_ = clock64(); clk_p[p] += (unsigned long long)(t_ - clk_t); clk_t = t_; }
#define CLK_STORE if (threadIdx.x == 0) { for (int q = 0; q < 8; ++q) atomicAdd(&g_clock_parts[q], clk_p[q]); }
extern "C" int cms_walk_clock_parts(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_clock_parts, sizeof(g_clock_parts));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_clock_parts, zero, sizeof(zero));
}
"""

# (generation, parts, [(anchor, what takes its place)]): each anchor must occur exactly once; the
# last edit of a generation puts the store of the totals before its anchor.
_GENERATIONS = [
    ("per-item", ("load", "hash", "match_table", "holds", "decisions"), [
        ("  long long walked = 0;\n", "  long long walked = 0;\n  CLK_INIT\n"),
        ("      const bool valid = at + lane < n && id >= 0;\n",
         "      const bool valid = at + lane < n && id >= 0;\n      CLK(0)\n"),
        ("        const int cell = j * width + cm_hash::column<kPow2>(id, seeds[j], (uint32_t)width);\n",
         "        const int cell = j * width + cm_hash::column<kPow2>(id, seeds[j], (uint32_t)width);\n"
         "        CLK(1)\n"),
        ("        est = min(est, (int32_t)((uint32_t)before + __popc(peers & ((1u << lane) - 1)) + 1u));\n",
         "        est = min(est, (int32_t)((uint32_t)before + __popc(peers & ((1u << lane) - 1)) + 1u));\n"
         "        CLK(2)\n"),
        ("      __syncwarp();  // the chunk's adds and the last chunk's ledger writes are seen by every lane\n",
         "      __syncwarp();  // the chunk's adds and the last chunk's ledger writes are seen by every lane\n"
         "      CLK(2)\n"),
        ("      unsigned todo = __ballot_sync(kAll, valid && (held || est > curmin));\n",
         "      unsigned todo = __ballot_sync(kAll, valid && (held || est > curmin));\n      CLK(3)\n"),
        ("        ledger.decide(__shfl_sync(kAll, id, src), __shfl_sync(kAll, est, src), curmin);\n      }\n",
         "        ledger.decide(__shfl_sync(kAll, id, src), __shfl_sync(kAll, est, src), curmin);\n      }\n"
         "      CLK(4)\n"),
        ("  return walked;\n", "  CLK_STORE\n  return walked;\n"),
    ]),
    ("step", ("load", "where", "candidate", "raises", "barrier", "refresh"), [
        ("  unsigned long long raises = 0, evictions = 0, chunks = 0;\n",
         "  unsigned long long raises = 0, evictions = 0, chunks = 0;\n  CLK_INIT\n"),
        ("      const bool valid = x >= 0;  // items past n hold -1\n",
         "      const bool valid = x >= 0;  // items past n hold -1\n      CLK(0)\n"),
        ("      unsigned m = valid ? table_find(tkey, tmask, x) : 0u;  // the snapshot: the slots that hold x\n",
         "      unsigned m = valid ? table_find(tkey, tmask, x) : 0u;  // the snapshot: the slots that hold x\n"
         "      CLK(1)\n"),
        ("        const int32_t xw = found ? cand_x[wc] : 0, ew = found ? cand_e[wc] : 0;\n",
         "        const int32_t xw = found ? cand_x[wc] : 0, ew = found ? cand_e[wc] : 0;\n        CLK(2)\n"),
        ("        raises += __popc(__ballot_sync(kAll, up));\n",
         "        raises += __popc(__ballot_sync(kAll, up));\n        CLK(3)\n"),
        ("        const bool any_moved = __syncthreads_or(moved);\n",
         "        const bool any_moved = __syncthreads_or(moved);\n        CLK(4)\n"),
        ("          if (any_moved) curmin = __reduce_min_sync(kAll, lane < k ? cnt[lane] : INT_MAX);\n"
         "          break;\n",
         "          if (any_moved) curmin = __reduce_min_sync(kAll, lane < k ? cnt[lane] : INT_MAX);\n"
         "          CLK(5)\n          break;\n"),
        ("        todo = todo && (warp > wc || (warp == wc && lane > cc));\n",
         "        todo = todo && (warp > wc || (warp == wc && lane > cc));\n        CLK(5)\n"),
        ("  if (counters != nullptr) {\n    if (lane == 0) atomicAdd(counters, raises);\n",
         "  CLK_STORE\n  if (counters != nullptr) {\n    if (lane == 0) atomicAdd(counters, raises);\n"),
    ]),
]


def instrument(src: Path, dst: Path) -> str:
    """Copy ``src``'s package to ``dst`` and put the clock reads into its walk; returns the generation."""
    shutil.copytree(src / "metrics_tpu_torch", dst / "metrics_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"), dirs_exist_ok=True)
    path = dst / "metrics_tpu_torch" / "csrc" / "cms_walk.cu"
    text = path.read_text()
    for generation, parts, edits in _GENERATIONS:
        if all(text.count(anchor) == 1 for anchor, _ in edits):
            break
    else:
        raise SystemExit(f"{path}: the walk is neither generation this script knows")
    for anchor, replacement in edits:
        text = text.replace(anchor, replacement)
    at = text.index('#include "cm_hash.cuh"\n') + len('#include "cm_hash.cuh"\n')
    path.write_text(text[:at] + _HEADER + text[at:] + f"\n// parts: {','.join(parts)}\n")
    return generation


def _zipf(torch, n: int, gen, n_ids: int = 10**7, s: float = 1.1):
    cdf = torch.cumsum(torch.arange(1, n_ids + 1, device="cuda", dtype=torch.float64).pow(-s), 0)
    u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    return torch.searchsorted(cdf / cdf[-1], u).clamp_(max=n_ids - 1).to(torch.int32)


def measure(root: Path, label: str) -> dict:
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch.kernels import _build, cms_walk

    if not torch.cuda.is_available():
        raise SystemExit("time_cms_walk: no CUDA GPU")
    assert Path(cms_walk.__file__).resolve().is_relative_to(root.resolve()), cms_walk.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = _build.load(cms_walk.KERNEL_NAME)
    source = (Path(cms_walk.__file__).parent.parent / "csrc" / "cms_walk.cu").read_text()
    parts = source.rsplit("// parts: ", 1)[1].split()[0].split(",") if "// parts: " in source else None
    ids = _zipf(torch, N_IDS, torch.Generator(device="cuda").manual_seed(SEED))
    table = torch.zeros((4, 2048), dtype=torch.int32, device="cuda")
    ledger = torch.stack([torch.full((32,), -1, dtype=torch.int32, device="cuda"),
                          torch.zeros(32, dtype=torch.int32, device="cuda")], dim=1)
    run = lambda: cms_walk.cms_walk_cuda(table, ledger, ids)  # noqa: E731
    for _ in range(3):
        out = run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        run()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / CALLS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            run()
        torch.cuda.synchronize()
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and "cms_walk" in evt.name:
            name = evt.name[evt.name.index("cms_walk"):].split("<")[0].split("(")[0]
            by_kernel.setdefault(name, []).append(evt.time_range.elapsed_us())
    per_kernel = {name: sum(v) / len(v) / 1e3 for name, v in by_kernel.items()}
    rec = {"label": label, "root": str(root), "card": card, "n": N_IDS, "call_ms": call_ms,
           "device_ms": sum(per_kernel.values()) if per_kernel else None, "device_ms_by_kernel": per_kernel,
           "launches_profiled": {name: len(v) for name, v in by_kernel.items()}}
    if parts is not None:
        lib.cms_walk_clock_parts.argtypes = [ctypes.c_void_p]
        totals = (ctypes.c_ulonglong * 8)()
        lib.cms_walk_clock_parts(totals)  # clears what the timed calls added
        got = cms_walk.cms_walk_cuda(table, ledger, ids)
        torch.cuda.synchronize()
        code = lib.cms_walk_clock_parts(totals)
        if code != 0:
            raise SystemExit(f"cms_walk_clock_parts: CUDA error {code}")
        unit = cms_walk.STEP if "barrier" in parts else 32
        chunks = N_IDS // unit
        rec["unit"] = f"step of {unit}" if "barrier" in parts else "chunk of 32"
        rec["cycles"] = {p: totals[i] for i, p in enumerate(parts)}
        rec["cycles_per_unit"] = {p: totals[i] / chunks for i, p in enumerate(parts)}
        rec["cycles_per_item"] = sum(totals[i] for i in range(len(parts))) / N_IDS
        rec["same_result"] = bool(torch.equal(got[0], out[0]) and torch.equal(got[1], out[1]))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--instrument", type=Path, help="tree to copy with clock reads in its walk")
    ap.add_argument("--out", type=Path, help="where the instrumented copy goes")
    args = ap.parse_args()
    if args.instrument is not None:
        print(json.dumps({"instrumented": str(args.out), "generation": instrument(args.instrument, args.out)}))
        return 0
    print(json.dumps(measure(args.root.resolve(), args.label)))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
