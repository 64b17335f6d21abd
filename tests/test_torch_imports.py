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
