"""The port's MTCKPT1 format and codecs (``metrics_tpu_torch/ckpt/format.py``,
``metrics_tpu_torch/comm/codec.py``) against the JAX package's.

One counterpart for each test of ``tests/ckpt/test_format.py``, run on the port,
then the cross-reads: ``dumps`` of the same tree gives the same bytes in both
packages (lossless, and under the int8 and fp16 policies), a blob written by
either package ``loads`` in the other with equal leaves, and the int8 codes and
scales are bit-identical (float32 division and round-half-even on both sides).
"""

import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from metrics_tpu.ckpt import dumps as jax_dumps
from metrics_tpu.ckpt import loads as jax_loads
from metrics_tpu.comm import codec as jax_codec
from metrics_tpu_torch.ckpt import CorruptSnapshotError, dumps, loads, read_manifest
from metrics_tpu_torch.ckpt import format as ckpt_format
from metrics_tpu_torch.comm import codec
from metrics_tpu_torch.comm.codec import CodecPolicy


def _sample_tree():
    rng = np.random.default_rng(0)
    return {
        "fixed": rng.standard_normal((3, 4)).astype(np.float32),
        "counts": np.arange(6, dtype=np.int64),
        "flag": np.zeros((), np.bool_),
        "cat": [rng.standard_normal(5).astype(np.float32), np.zeros(0, np.float32)],
        "empty_list": [],
        "nested": {"tup": (np.float16(2.5), [1, 2]), "none": None, "s": "label"},
        "scalars": {"i": 7, "f": 1.25, "b": True},
        "opaque": {(1, "non-str-key"): b"payload"},
        "_update_count": np.int32(11),
    }


def _assert_leaves_equal(got, want):
    """Equal trees: containers by type, arrays by dtype, shape and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_leaves_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_leaves_equal(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        got = np.asarray(got)
        assert got.dtype == np.asarray(want).dtype and got.shape == np.asarray(want).shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


# --------------------------------------------------------------------------- counterparts of tests/ckpt/test_format.py


class TestRoundTrip:
    def test_lossless_bit_identical(self):
        tree = _sample_tree()
        snap = loads(dumps(tree, meta={"step": 3}, schema_version=2))
        assert snap.schema_version == 2
        assert snap.meta == {"step": 3}
        assert snap.tree["fixed"].dtype == np.float32 and snap.tree["counts"].dtype == np.int64
        assert snap.tree["flag"].dtype == np.bool_
        assert snap.tree["cat"][1].shape == (0,)
        assert snap.tree["scalars"]["b"] is True
        assert int(snap.tree["_update_count"]) == 11
        _assert_leaves_equal(snap.tree, tree)

    def test_zero_dim_and_weird_dtypes(self):
        tree = {
            "scalar": np.float64(3.5),
            "u8": np.arange(4, dtype=np.uint8),
            "c64": np.array([1 + 2j], dtype=np.complex64),
        }
        out = loads(dumps(tree)).tree
        assert out["scalar"].shape == () and float(out["scalar"]) == 3.5
        assert out["u8"].dtype == np.uint8
        assert out["c64"].dtype == np.complex64 and out["c64"][0] == 1 + 2j

    def test_bfloat16_round_trip(self):
        import ml_dtypes

        x = np.arange(8, dtype=np.float32).astype(ml_dtypes.bfloat16)
        out = loads(dumps({"x": x})).tree["x"]
        assert out.dtype == ml_dtypes.bfloat16
        assert np.array_equal(out.astype(np.float32), x.astype(np.float32))

    def test_extension_dtype_without_ml_dtypes_is_a_corrupt_snapshot(self, tmp_path):
        """A process without ml_dtypes refuses a bfloat16 leaf with the format's
        error, naming the dtype, and reads plain dtypes without importing it (a
        fresh interpreter: here JAX has registered ml_dtypes' types with numpy)."""
        import ml_dtypes

        (tmp_path / "bf16.ckpt").write_bytes(dumps({"x": np.arange(4, dtype=np.float32).astype(ml_dtypes.bfloat16)}))
        (tmp_path / "plain.ckpt").write_bytes(dumps({"y": np.arange(4, dtype=np.int32)}))
        script = (
            "import sys; sys.modules['ml_dtypes'] = None\n"
            "from metrics_tpu_torch.ckpt import CorruptSnapshotError, loads\n"
            f"assert loads(open({str(tmp_path / 'plain.ckpt')!r}, 'rb').read()).tree['y'].dtype.name == 'int32'\n"
            "try:\n"
            f"    loads(open({str(tmp_path / 'bf16.ckpt')!r}, 'rb').read())\n"
            "except CorruptSnapshotError as exc:\n"
            "    print('refused:', exc)\n"
        )
        out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120,
                             cwd=str(Path(__file__).resolve().parent.parent))
        assert out.returncode == 0, out.stderr
        assert "refused:" in out.stdout and "bfloat16" in out.stdout and "ml_dtypes" in out.stdout

    def test_nan_inf_survive(self):
        x = np.array([np.nan, np.inf, -np.inf, 0.0], np.float32)
        out = loads(dumps({"x": x})).tree["x"]
        assert np.array_equal(out, x, equal_nan=True)


class TestCodecPolicy:
    def test_default_is_lossless(self):
        manifest = read_manifest(dumps(_sample_tree()))
        assert all(leaf["codec"] == "lossless" for leaf in manifest["leaves"] if leaf["kind"] == "array")

    def test_lossy_policy_quantizes_large_floats_keeps_counts_exact(self):
        rng = np.random.default_rng(1)
        tree = {
            "scores": rng.standard_normal(8192).astype(np.float32),
            "tiny": rng.standard_normal(8).astype(np.float32),
            "counts": np.arange(100, dtype=np.int64),
            "_update_count": np.int32(9),
        }
        blob = dumps(tree, policy=CodecPolicy(lossy="int8"), reductions={"scores": "cat", "tiny": "cat"})
        assert len(blob) < len(dumps(tree)) / 2.5  # the big leaf actually shrank
        snap = loads(blob)
        assert np.array_equal(snap.tree["counts"], tree["counts"])
        assert int(snap.tree["_update_count"]) == 9
        assert np.array_equal(snap.tree["tiny"], tree["tiny"])
        err = np.abs(snap.tree["scores"] - tree["scores"])
        assert err.max() > 0  # it did quantize
        # blockwise int8 bound: absmax_block / 254 per element
        blocks = tree["scores"].reshape(-1, 1024)
        bound = np.repeat(np.abs(blocks).max(axis=1) / 254.0, 1024)
        assert np.all(err <= bound + 1e-7)

    def test_reducible_states_stay_lossless_under_lossy_policy(self):
        tree = {"total": np.random.default_rng(2).standard_normal(8192).astype(np.float32)}
        blob = dumps(tree, policy=CodecPolicy(lossy="int8"), reductions={"total": "sum"})
        assert np.array_equal(loads(blob).tree["total"], tree["total"])


class TestCorruption:
    def test_bad_magic(self):
        blob = dumps(_sample_tree())
        with pytest.raises(CorruptSnapshotError, match="magic"):
            loads(b"NOTMAGIC" + blob[8:])

    @pytest.mark.parametrize("frac", [0.0, 0.1, 0.5, 0.95])
    def test_truncation_always_detected(self, frac):
        blob = dumps(_sample_tree())
        with pytest.raises(CorruptSnapshotError):
            loads(blob[: int(len(blob) * frac)])

    def test_bit_flips_in_manifest_and_payload_detected(self):
        blob = dumps({"x": np.arange(64, dtype=np.float32)})
        for off in (len(ckpt_format.MAGIC) + 13, len(blob) - 5):  # manifest / payload
            bad = bytearray(blob)
            bad[off] ^= 0x10
            with pytest.raises(CorruptSnapshotError):
                loads(bytes(bad))

    def test_read_manifest_checks_crc_without_payloads(self):
        blob = dumps(_sample_tree())
        assert read_manifest(blob)["format_version"] == ckpt_format.FORMAT_VERSION
        bad = bytearray(blob)
        bad[len(ckpt_format.MAGIC) + 14] ^= 1  # inside the manifest JSON
        with pytest.raises(CorruptSnapshotError):
            read_manifest(bytes(bad))

    def test_unknown_format_version_rejected(self):
        blob = dumps({"x": np.ones(2)})
        manifest = read_manifest(blob)
        manifest["format_version"] = 99
        mbytes = json.dumps(manifest, separators=(",", ":")).encode()
        header = ckpt_format.MAGIC + struct.pack("<QI", len(mbytes), zlib.crc32(mbytes) & 0xFFFFFFFF)
        payload = blob[len(blob) - manifest["payload_nbytes"]:]
        with pytest.raises(CorruptSnapshotError, match="format_version"):
            loads(header + mbytes + payload)


# --------------------------------------------------------------------------- the two packages


def _lossy_tree():
    rng = np.random.default_rng(3)
    return {
        "scores": rng.standard_normal(5000).astype(np.float32) * 40,
        "halves": (rng.integers(-400, 400, 3000) / 2).astype(np.float32),  # x.5 values: round half to even
        "zeros": np.zeros(2048, np.float32),
        "counts": np.arange(4096, dtype=np.int32),
        "f64": rng.standard_normal(1500),
        "_update_count": np.int32(3),
    }


POLICIES = {
    "lossless": (None, None),
    "int8": (CodecPolicy(lossy="int8"), jax_codec.CodecPolicy(lossy="int8")),
    "fp16": (CodecPolicy(lossy="fp16"), jax_codec.CodecPolicy(lossy="fp16")),
    "int8_reducible": (CodecPolicy(lossy="int8", quantize_reducible=True),
                       jax_codec.CodecPolicy(lossy="int8", quantize_reducible=True)),
}
REDUCTIONS = {"scores": "cat", "halves": "cat", "zeros": "cat", "f64": "sum", "counts": "sum"}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("tree", ["sample", "lossy"])
def test_same_tree_same_bytes_in_both_packages(policy, tree):
    tree = _sample_tree() if tree == "sample" else _lossy_tree()
    port_policy, jax_policy = POLICIES[policy]
    meta = {"seq": 7, "tenants": 2}
    assert dumps(tree, policy=port_policy, reductions=REDUCTIONS, meta=meta, schema_version=3) == jax_dumps(
        tree, policy=jax_policy, reductions=REDUCTIONS, meta=meta, schema_version=3
    )


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_blob_of_either_package_loads_in_the_other(policy, writer):
    tree = _lossy_tree()
    port_policy, jax_policy = POLICIES[policy]
    if writer == "jax":
        blob = jax_dumps(tree, policy=jax_policy, reductions=REDUCTIONS, meta={"w": writer})
        got, want = loads(blob), jax_loads(blob)
    else:
        blob = dumps(tree, policy=port_policy, reductions=REDUCTIONS, meta={"w": writer})
        got, want = jax_loads(blob), loads(blob)
    assert got.meta == want.meta == {"w": writer}
    _assert_leaves_equal(got.tree, want.tree)
    if policy == "lossless":
        _assert_leaves_equal(got.tree, tree)
    # counts stay exact under every policy
    np.testing.assert_array_equal(got.tree["counts"], tree["counts"])


@pytest.mark.parametrize("block", [1, 7, 1024])
@pytest.mark.parametrize("n", [0, 5, 1023, 1024, 4097])
def test_int8_codes_and_scales_are_the_jax_packages(block, n):
    rng = np.random.default_rng(n + block)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 300.0], n)).astype(np.float32)
    if n > 4:
        x[:4] = [0.5, -1.5, 2.5, 127.0]  # ties, and a value at the scale's edge
    port, ref = codec.Int8BlockCodec(block).encode(x), jax_codec.Int8BlockCodec(block).encode(x)
    assert port.codec == ref.codec and port.shape == ref.shape and port.dtype == ref.dtype
    for got, want in zip(port.payloads, ref.payloads):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(codec.Int8BlockCodec(block).decode(port), jax_codec.Int8BlockCodec(block).decode(ref))


def test_codec_registry_and_policy_choices_match_jax():
    for name in ("lossless", "fp16", "int8", "int8x1024"):
        assert codec.get_codec(name).name == jax_codec.get_codec(name).name
    with pytest.raises(KeyError, match="unknown codec"):
        codec.get_codec("zstd")
    cases = [("x", "cat", np.float32, 8192), ("x", "sum", np.float32, 8192), ("_update_count", None, np.float32, 8192),
             ("x", "cat", np.int32, 8192), ("x", "cat", np.float16, 8192), ("x", None, np.float64, 100)]
    for lossy in (None, "int8", "fp16"):
        for args in cases:
            assert CodecPolicy(lossy=lossy).choose(*args) == jax_codec.CodecPolicy(lossy=lossy).choose(*args)
    assert CodecPolicy(lossy="int8").all_lossless() == CodecPolicy()
