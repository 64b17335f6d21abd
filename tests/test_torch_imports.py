"""Import guard: the port and ``chip_smoke.py`` import nothing of JAX.

Every ``.py`` under ``metrics_tpu_torch/`` and ``chip_smoke.py`` is parsed, and
any import of ``jax``, ``jaxlib``, ``flax`` or ``metrics_tpu`` (as opposed to
``metrics_tpu_torch``) fails, whether by an ``import`` statement or by
``importlib.import_module`` / ``__import__`` of a string literal.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "metrics_tpu")
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "metrics_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def forbidden_imports(source: str) -> list:
    """``(line, module)`` of every forbidden import in ``source``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0 and _forbidden(node.module):
            found.append((node.lineno, node.module))
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None)) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and _forbidden(node.args[0].value)
        ):
            found.append((node.lineno, node.args[0].value))
    return found


def test_sources_were_found():
    assert "metrics_tpu_torch/kernels/confmat.py" in SOURCES and len(SOURCES) > 20


CURVE_MODULES = ["metrics_tpu_torch/kernels/binned_curve.py"] + [
    f"metrics_tpu_torch/{pkg}/{name}.py"
    for pkg in ("functional/classification", "classification")
    for name in ("precision_recall_curve", "roc", "auroc", "average_precision", "specificity_at_sensitivity",
                 "recall_at_fixed_precision")
]


@pytest.mark.parametrize("relpath", CURVE_MODULES)
def test_curve_modules_are_scanned(relpath):
    assert relpath in SOURCES


CORE_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("metric", "aggregation", "collections", "entry", "utils/imports", "utils/plot", "utils/data",
                 "obs/instrument", "obs/registry", "functional/classification/precision_recall",
                 "functional/classification/specificity", "classification/precision_recall",
                 "classification/specificity")
]


@pytest.mark.parametrize("relpath", CORE_MODULES)
def test_core_modules_are_scanned(relpath):
    assert relpath in SOURCES


ENGINE_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("engine/__init__", "engine/bucketing", "engine/stream", "engine/telemetry", "engine/runtime",
                 "kernels/engine_scan", "obs/jsonl", "utils/graphs", "utils/params_io")
]


@pytest.mark.parametrize("relpath", ENGINE_MODULES)
def test_engine_modules_are_scanned(relpath):
    assert relpath in SOURCES


SLICE_10_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("functional/regression/__init__", "functional/regression/basic", "regression/__init__",
                 "regression/basic", "functional/classification/_pipeline", "utils/checks", "utils/enums")
]


@pytest.mark.parametrize("relpath", SLICE_10_MODULES)
def test_regression_and_task_facade_modules_are_scanned(relpath):
    assert relpath in SOURCES


CKPT_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("comm/__init__", "comm/codec", "ckpt/__init__", "ckpt/format", "ckpt/store", "ckpt/writer",
                 "ckpt/restore", "ckpt/faults")
]


@pytest.mark.parametrize("relpath", CKPT_MODULES)
def test_durable_state_plane_modules_are_scanned(relpath):
    assert relpath in SOURCES


def _series(reg):
    """One registry's worth of every kind of series: labelled and unlabelled
    counters (integral and fractional), a gauge, histograms with explicit and
    default edges, label values that need escaping, a help text with a newline,
    and a family whose series were dropped by label."""
    events = reg.counter("engine_events_total", "Lifecycle events.")
    events.inc(3, event="submitted", engine="0")
    events.inc(2.5, event="rows", engine="0")
    events.inc(7, event="submitted", engine="1")
    events.inc_many([(1, {"event": "batches", "engine": "1"}), (4, {"event": "rows", "engine": "1"})])
    reg.counter("plain_total").inc(11)
    depth = reg.gauge("queue_depth", "Queued\nrequests.")
    depth.set(5, engine="0")
    depth.set(0.125, engine="1")
    occ = reg.histogram("occupancy", "Real rows a batch.", buckets=(0.25, 0.5, 0.75, 1.0))
    for v in (0.1, 0.25, 0.3, 0.99, 1.0, 1.5):
        occ.observe(v, engine="0")
    lat = reg.histogram("latency_seconds", "Latency.")
    for v in (2e-6, 3e-4, 0.02, 12.0):
        lat.observe(v, engine="0", path='a"b\\c')
    gone = reg.counter("gone_total", "Dropped with its engine.")
    gone.inc(1, engine="0")
    gone.inc(2, engine="1")
    gone.drop_labels(engine="0")
    occ.touch(engine="2")
    return reg


def test_render_prometheus_equals_the_jax_registrys():
    """The port's registry renders the same Prometheus text, and takes the same
    snapshot, as the JAX package's for the same series."""
    from metrics_tpu.obs.registry import Registry as JaxRegistry

    from metrics_tpu_torch.obs.registry import Registry

    port, ref = _series(Registry()), _series(JaxRegistry())
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.snapshot() == ref.snapshot()
    assert "gone_total{engine=\"1\"} 2" in port.render_prometheus()
    assert 'engine="0"' not in port.render_prometheus().split("gone_total")[-1]


@pytest.mark.parametrize("relpath", SOURCES)
def test_no_jax_or_reference_package_import(relpath):
    assert forbidden_imports((ROOT / relpath).read_text()) == []


@pytest.mark.parametrize(
    "line",
    [
        "import jax",
        "import jax.numpy as jnp",
        "from jax import numpy",
        "import flax.linen",
        "from jaxlib import xla_client",
        "import metrics_tpu",
        "from metrics_tpu.kernels import confmat",
        "import importlib; importlib.import_module('metrics_tpu.metric')",
        "__import__('jax')",
    ],
)
def test_guard_catches(line):
    assert forbidden_imports(line)


@pytest.mark.parametrize(
    "line", ["import metrics_tpu_torch", "from metrics_tpu_torch.kernels import confmat", "from . import registry"]
)
def test_guard_allows_the_port(line):
    assert forbidden_imports(line) == []
