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


GUARD_TIER_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("guard/__init__", "guard/errors", "guard/quota", "guard/breaker", "guard/shed", "guard/fairness",
                 "guard/quarantine", "guard/watchdog", "guard/config", "guard/plane", "guard/faults",
                 "tier/__init__", "tier/config", "tier/coldstore", "tier/residency")
]


@pytest.mark.parametrize("relpath", GUARD_TIER_MODULES)
def test_guard_and_tier_plane_modules_are_scanned(relpath):
    assert relpath in SOURCES


REPL_OBS_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("repl/__init__", "repl/config", "repl/errors", "repl/transport", "repl/shipper", "repl/replica",
                 "obs/__init__", "obs/context", "obs/trace", "obs/flight", "obs/fleet")
]


@pytest.mark.parametrize("relpath", REPL_OBS_MODULES)
def test_replication_plane_and_obs_modules_are_scanned(relpath):
    assert relpath in SOURCES


COMM_PARALLEL_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("comm/transport", "comm/membership", "comm/plan", "comm/plane", "comm/axis", "parallel/__init__",
                 "parallel/sync", "utils/distributed")
]


@pytest.mark.parametrize("relpath", COMM_PARALLEL_MODULES)
def test_comm_plane_and_parallel_modules_are_scanned(relpath):
    assert relpath in SOURCES


def test_the_comm_plane_exports_every_name_of_the_jax_package():
    import metrics_tpu.comm as jax_comm

    import metrics_tpu_torch.comm as comm
    import metrics_tpu_torch.parallel.sync as sync

    assert set(jax_comm.__all__) <= set(comm.__all__) and len(comm.__all__) == 41
    assert all(callable(getattr(comm, name)) for name in comm.__all__)
    assert all(callable(getattr(sync, name)) for name in ("reduce_in_trace", "in_trace", "sync_state_host"))
    from metrics_tpu_torch.comm import axis

    assert sync.use_mesh is axis.use_mesh and sync.resolve_axis is axis.resolve_axis


SHARD_QUERY_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("shard/__init__", "shard/ring", "shard/engine", "cluster/__init__", "cluster/errors",
                 "query/__init__", "query/errors", "query/report", "query/rollup", "query/tree", "query/cache",
                 "query/global_query")
]


@pytest.mark.parametrize("relpath", SHARD_QUERY_MODULES)
def test_shard_and_query_plane_modules_are_scanned(relpath):
    assert relpath in SOURCES


CLUSTER_PART_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("cluster/store", "cluster/config", "cluster/node", "cluster/client", "part/__init__", "part/pmap",
                 "part/config", "part/migrate", "part/node", "part/client")
]


@pytest.mark.parametrize("relpath", CLUSTER_PART_MODULES)
def test_cluster_and_partition_plane_modules_are_scanned(relpath):
    assert relpath in SOURCES


@pytest.mark.parametrize("plane,count", [("shard", 6), ("query", 15), ("cluster", 12), ("part", 7)])
def test_the_shard_query_and_cluster_planes_export_the_jax_names(plane, count):
    """``shard``, ``query``, ``cluster`` and ``part`` export every name of the
    JAX package's."""
    import importlib

    port = importlib.import_module(f"metrics_tpu_torch.{plane}")
    ref = importlib.import_module(f"metrics_tpu.{plane}")
    assert len(port.__all__) == count and all(hasattr(port, name) for name in port.__all__)
    assert sorted(port.__all__) == sorted(ref.__all__)


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


PILOT_CONFMAT_FAMILY_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("pilot/__init__", "pilot/config", "pilot/journal", "pilot/signals", "pilot/policy",
                 "pilot/actuator", "pilot/loop", "functional/classification/jaccard",
                 "functional/classification/cohen_kappa", "functional/classification/matthews_corrcoef",
                 "classification/jaccard", "classification/cohen_kappa", "classification/matthews_corrcoef")
]


@pytest.mark.parametrize("relpath", PILOT_CONFMAT_FAMILY_MODULES)
def test_pilot_plane_and_confusion_matrix_family_modules_are_scanned(relpath):
    assert relpath in SOURCES


def test_the_pilot_plane_exports_the_jax_names():
    import metrics_tpu.pilot as ref

    import metrics_tpu_torch.pilot as port

    assert len(port.__all__) == 13 and sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, name) for name in port.__all__)


def test_utils_exports_the_jax_names_the_port_defines():
    """All 12 names of the JAX package's ``utils.__all__``."""
    import metrics_tpu.utils as ref

    import metrics_tpu_torch.utils as port

    assert len(port.__all__) == 12 and sorted(port.__all__) == sorted(ref.__all__)
    assert all(callable(getattr(port, name)) for name in port.__all__)


def test_kernels_export_the_registry_without_its_fallback_switches():
    """The JAX names of the registry, less ``configure``, ``mode`` and
    ``forced``: the port has no mode that sends a CUDA tensor to a plain version."""
    import metrics_tpu.kernels as ref

    import metrics_tpu_torch.kernels as port
    from metrics_tpu_torch.kernels import registry

    names = ("REGISTRY", "KernelEntry", "dispatch", "get", "names", "register", "selected", "registry")
    assert all(name in port.__all__ and name in ref.__all__ for name in names)
    assert sorted(set(ref.__all__) - set(port.__all__)) == ["configure", "forced", "mode"]
    assert not any(hasattr(port, name) for name in ("configure", "forced", "mode"))
    assert port.REGISTRY is registry.REGISTRY and port.dispatch is registry.dispatch and port.registry is registry
    assert "pair_count_cuda" in port.names()


FAMILY_CLASSES = ["BinaryCohenKappa", "BinaryJaccardIndex", "BinaryMatthewsCorrCoef", "CohenKappa", "JaccardIndex",
                  "MatthewsCorrCoef", "MulticlassCohenKappa", "MulticlassJaccardIndex", "MulticlassMatthewsCorrCoef",
                  "MultilabelJaccardIndex", "MultilabelMatthewsCorrCoef"]


@pytest.mark.parametrize("where,names", [
    ("classification", FAMILY_CLASSES),
    ("", ["CohenKappa", "JaccardIndex", "MatthewsCorrCoef"]),
    ("functional", ["cohen_kappa", "jaccard_index", "matthews_corrcoef"]),
])
def test_the_confusion_matrix_family_names_are_exported_as_in_jax(where, names):
    import importlib

    port = importlib.import_module("metrics_tpu_torch" + (f".{where}" if where else ""))
    ref = importlib.import_module("metrics_tpu" + (f".{where}" if where else ""))
    family = sorted(n for n in ref.__all__ if any(k in n.lower() for k in ("jaccard", "kappa", "matthews")))
    assert family == sorted(names)
    assert all(name in port.__all__ and hasattr(port, name) for name in names)


SLICE_18_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("functional/nominal/__init__", "functional/nominal/utils", "functional/nominal/stats",
                 "nominal/__init__", "nominal/stats")
] + [
    f"metrics_tpu_torch/{pkg}/{name}.py"
    for pkg in ("functional/classification", "classification")
    for name in ("hamming", "exact_match", "calibration_error", "hinge", "ranking", "dice")
]


@pytest.mark.parametrize("relpath", SLICE_18_MODULES)
def test_nominal_and_classification_rest_modules_are_scanned(relpath):
    assert relpath in SOURCES


def test_classification_exports_every_name_of_the_jax_package():
    import metrics_tpu.classification as ref

    import metrics_tpu_torch.classification as port

    assert len(ref.__all__) == 84 and sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, name) for name in port.__all__)


SLICE_18_TOP = ["CalibrationError", "CramersV", "Dice", "ExactMatch", "HammingDistance", "HingeLoss",
                "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT"]
SLICE_18_FUNCTIONAL = ["calibration_error", "cramers_v", "cramers_v_matrix", "dice", "exact_match", "hamming_distance",
                       "hinge_loss", "pearsons_contingency_coefficient", "pearsons_contingency_coefficient_matrix",
                       "theils_u", "theils_u_matrix", "tschuprows_t", "tschuprows_t_matrix"]


@pytest.mark.parametrize("where,names", [("", SLICE_18_TOP), ("functional", SLICE_18_FUNCTIONAL),
                                         ("nominal", SLICE_18_TOP[1:2] + SLICE_18_TOP[6:]),
                                         ("functional.nominal", [n for n in SLICE_18_FUNCTIONAL if "_" in n
                                                                 and n.split("_")[0] in ("cramers", "pearsons",
                                                                                         "theils", "tschuprows")])])
def test_the_slice_18_names_are_exported_as_in_jax(where, names):
    import importlib

    port = importlib.import_module("metrics_tpu_torch" + (f".{where}" if where else ""))
    ref = importlib.import_module("metrics_tpu" + (f".{where}" if where else ""))
    assert all(name in ref.__all__ for name in names)
    assert all(name in port.__all__ and hasattr(port, name) for name in names)
    if where.endswith("nominal"):
        assert sorted(port.__all__) == sorted(ref.__all__) == sorted(names)


def test_the_top_level_and_functional_counts():
    import metrics_tpu_torch as port
    import metrics_tpu_torch.functional as port_fn

    assert len(port.__all__) == 80 and len(port_fn.__all__) == 101


SLICE_19_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("functional/regression/moments", "functional/regression/misc", "regression/moments",
                 "regression/misc", "functional/pairwise/__init__", "functional/pairwise/similarity",
                 "functional/retrieval/__init__", "functional/retrieval/_utils", "functional/retrieval/rank_metrics",
                 "retrieval/__init__", "retrieval/base", "retrieval/rank_metrics", "retrieval/precision_recall_curve")
]


@pytest.mark.parametrize("relpath", SLICE_19_MODULES)
def test_regression_pairwise_and_retrieval_modules_are_scanned(relpath):
    assert relpath in SOURCES


@pytest.mark.parametrize("where,count", [("regression", 16), ("functional.regression", 16),
                                         ("functional.pairwise", 4), ("functional.retrieval", 9),
                                         ("retrieval", 13)])
def test_the_slice_19_packages_export_every_name_of_the_jax_package(where, count):
    import importlib

    port = importlib.import_module(f"metrics_tpu_torch.{where}")
    ref = importlib.import_module(f"metrics_tpu.{where}")
    assert len(port.__all__) == count and sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, name) for name in port.__all__)


def test_the_slice_19_names_reach_the_top_level_and_functional():
    """The 19 top-level and 22 functional names of the slice, exported as the
    JAX package exports them."""
    import metrics_tpu as ref
    import metrics_tpu.functional as ref_fn
    import metrics_tpu.regression as ref_reg
    import metrics_tpu.retrieval as ref_ret

    import metrics_tpu_torch as port
    import metrics_tpu_torch.functional as port_fn

    top = ({n for n in ref_reg.__all__ if n in ref.__all__} | {n for n in ref_ret.__all__ if n in ref.__all__}) - {
        "LogCoshError", "MeanAbsoluteError", "MeanAbsolutePercentageError", "MeanSquaredError",
        "MeanSquaredLogError", "SymmetricMeanAbsolutePercentageError", "WeightedMeanAbsolutePercentageError"}
    assert len(top) == 19 and top <= set(port.__all__)
    fn = {n for n in ref_fn.__all__ if n.startswith(("pairwise_", "retrieval_")) or n in (
        "concordance_corrcoef", "cosine_similarity", "explained_variance", "kendall_rank_corrcoef", "kl_divergence",
        "pearson_corrcoef", "r2_score", "spearman_corrcoef", "tweedie_deviance_score")}
    assert len(fn) == 22 and fn <= set(port_fn.__all__)
    assert len(set(ref_fn.__all__) & set(port_fn.__all__)) == 75  # 69 at slice 19's end, 6 audio names since


def test_utils_define_the_legacy_helpers_the_jax_package_does_not_export():
    """The enums, the legacy checks and ``to_categorical``, ``allclose`` and
    ``rank_zero_warn_once``: defined where the JAX package defines them and, as
    there, left out of ``utils.__all__``."""
    import metrics_tpu.utils as ref

    import metrics_tpu_torch.utils as port
    from metrics_tpu_torch.utils import checks, data, enums, prints

    names = {enums: ("DataType", "AverageMethod", "MDMCAverageMethod", "ClassificationTaskNoMultilabel"),
             checks: ("_basic_input_validation", "_check_shape_and_type_consistency", "_check_classification_inputs",
                      "_input_squeeze", "_input_format_classification"),
             data: ("to_categorical", "allclose"), prints: ("rank_zero_warn_once",)}
    for module, defined in names.items():
        assert all(callable(getattr(module, n)) for n in defined)
        assert not any(n in port.__all__ or n in ref.__all__ for n in defined)
    assert enums.DataType.from_str("multilabel") == enums.DataType.MULTILABEL == "multi-label"
    assert enums.AverageMethod.NONE == "none" and enums.MDMCAverageMethod.from_str("samplewise") == "samplewise"
    with pytest.raises(ValueError, match="expected one of \\['binary', 'multiclass'\\]"):
        enums.ClassificationTaskNoMultilabel.from_str_or_raise("multilabel")
    import torch

    assert data.to_categorical(torch.tensor([[0.1, 0.9], [0.8, 0.2]])).tolist() == [1, 0]
    assert data.allclose(torch.tensor([1.0, 2.0]), torch.tensor([1, 2])) and not data.allclose(torch.ones(2), torch.zeros(2))


def test_rank_zero_warn_once_warns_once(recwarn):
    from metrics_tpu_torch.utils.prints import rank_zero_warn_once

    message = "metrics_tpu_torch test: rank_zero_warn_once"
    rank_zero_warn_once(message)
    rank_zero_warn_once(message)
    assert [str(w.message) for w in recwarn].count(message) == 1


SLICE_20_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("kernels/_batched", "wrappers/__init__", "wrappers/bootstrapping", "wrappers/classwise",
                 "wrappers/minmax", "wrappers/multioutput", "wrappers/tracker", "image/__init__")
] + [
    f"metrics_tpu_torch/{pkg}/{name}.py"
    for pkg in ("functional/image", "image")
    for name in ("psnr", "ssim", "uqi", "ergas", "sam", "d_lambda", "tv")
] + [f"metrics_tpu_torch/functional/image/{name}.py" for name in ("__init__", "helper", "gradients")]


@pytest.mark.parametrize("relpath", SLICE_20_MODULES)
def test_wrapper_and_image_modules_are_scanned(relpath):
    assert relpath in SOURCES


@pytest.mark.parametrize("where,count", [("wrappers", 5), ("functional.image", 9)])
def test_the_wrappers_and_the_image_functionals_export_every_jax_name(where, count):
    import importlib

    port = importlib.import_module(f"metrics_tpu_torch.{where}")
    ref = importlib.import_module(f"metrics_tpu.{where}")
    assert len(port.__all__) == count and sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, name) for name in port.__all__)


IMAGE_WITH_A_NETWORK = ["FrechetInceptionDistance", "InceptionScore", "KernelInceptionDistance",
                        "LearnedPerceptualImagePatchSimilarity"]


def test_image_exports_the_eight_names_that_need_no_network():
    """The eight names of slice 20 stay exported beside the four of slice 21."""
    import metrics_tpu.image as ref

    import metrics_tpu_torch.image as port

    no_network = sorted(set(ref.__all__) - set(IMAGE_WITH_A_NETWORK))
    assert len(no_network) == 8 and set(no_network) <= set(port.__all__)
    assert all(hasattr(port, name) for name in no_network)
    assert sorted(set(port.__all__) - set(no_network)) == IMAGE_WITH_A_NETWORK


def test_the_slice_20_names_reach_the_top_level_and_functional():
    """The 5 wrappers and 8 image modules at the top level (75 of 92), the 9
    image functionals in ``functional`` (69 of the JAX 88, 95 with the 26
    task-level names)."""
    import metrics_tpu as ref
    import metrics_tpu.functional as ref_fn
    import metrics_tpu.functional.image as ref_img_fn
    import metrics_tpu.wrappers as ref_wrappers

    import metrics_tpu_torch as port
    import metrics_tpu_torch.functional as port_fn
    import metrics_tpu_torch.image as port_img

    top = set(ref_wrappers.__all__) | (set(port_img.__all__) - set(IMAGE_WITH_A_NETWORK))
    assert len(top) == 13 and top <= set(ref.__all__) and top <= set(port.__all__)
    assert set(ref_img_fn.__all__) <= set(ref_fn.__all__) and set(ref_img_fn.__all__) <= set(port_fn.__all__)
    assert len(ref.__all__) == 92 and len(ref_fn.__all__) == 88


SLICE_21_MODULES = [
    f"metrics_tpu_torch/{name}.py"
    for name in ("image/inception_net", "image/fid", "image/kid", "image/inception", "image/lpips_net", "image/lpip",
                 "utils/params_io", "utils/imports", "audio/__init__", "functional/audio/__init__",
                 "functional/audio/_stoi_native")
] + [
    f"metrics_tpu_torch/{pkg}/{name}.py"
    for pkg in ("functional/audio", "audio")
    for name in ("snr", "sdr", "pit", "stoi", "pesq")
]


@pytest.mark.parametrize("relpath", SLICE_21_MODULES)
def test_the_network_image_and_audio_modules_are_scanned(relpath):
    assert relpath in SOURCES
    assert forbidden_imports((ROOT / relpath).read_text()) == []


@pytest.mark.parametrize("where,count", [("image", 12), ("audio", 7), ("functional.audio", 8)])
def test_image_and_audio_export_every_jax_name(where, count):
    import importlib

    port = importlib.import_module(f"metrics_tpu_torch.{where}")
    ref = importlib.import_module(f"metrics_tpu.{where}")
    assert len(port.__all__) == count and sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, name) for name in port.__all__)


def test_the_slice_21_names_reach_the_top_level_and_functional():
    """The 5 audio modules of the JAX top level (80 of 92) and the 6 audio
    functionals of the JAX ``functional`` (75 of its 88, 101 with the 26
    task-level names); what stays missing is text."""
    import metrics_tpu as ref
    import metrics_tpu.audio as ref_audio
    import metrics_tpu.functional as ref_fn
    import metrics_tpu.functional.audio as ref_audio_fn

    import metrics_tpu_torch as port
    import metrics_tpu_torch.audio as port_audio
    import metrics_tpu_torch.functional as port_fn

    top = set(ref_audio.__all__) & set(ref.__all__)
    assert len(top) == 5 and top <= set(port.__all__)
    assert all(getattr(port, name) is getattr(port_audio, name) for name in top)
    fn = set(ref_audio_fn.__all__) & set(ref_fn.__all__)
    assert len(fn) == 6 and "pit_permutate" in fn and fn <= set(port_fn.__all__)
    assert len(set(ref.__all__) - set(port.__all__)) == 12
    assert len(set(ref_fn.__all__) & set(port_fn.__all__)) == 75
