"""The port's consistent-hash ring (``metrics_tpu_torch/shard/ring.py``) against
the JAX package's, and the ring's own properties (twins of
``tests/shard/test_ring.py``).

A key must land on the same shard in both packages, bit for bit, or a sharded
checkpoint written by one package would route tenants away from their WALs in
the other. The parity cases draw 10^4 keys of every type ``stable_key_bytes``
encodes (bytes, str, bool, int, float, None, nested tuples) from a numpy seed
and compare ``stable_key_bytes``, ``hash_bytes`` and ``shard_for`` across ring
sizes, vnode counts and seeds.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

import metrics_tpu.shard as jshard
from metrics_tpu_torch.shard import DEFAULT_VNODES, HashRing, hash_bytes, stable_key_bytes

KEYS_1K = [f"tenant-{i}" for i in range(1000)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _key(rng, depth=0):
    kind = int(rng.integers(0, 8 if depth < 2 else 7))
    if kind == 0:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 12))).astype(np.uint8))
    if kind == 1:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, int(rng.integers(0, 10))))
    if kind == 2:
        return bool(rng.integers(0, 2))
    if kind == 3:
        return int(rng.integers(-(2**62), 2**62)) * int(rng.integers(1, 4))
    if kind == 4:
        return float(rng.normal() * 10.0 ** int(rng.integers(-5, 6)))
    if kind == 5:
        return None
    if kind == 6:
        return int(rng.integers(-5, 5))
    return tuple(_key(rng, depth + 1) for _ in range(int(rng.integers(0, 4))))


def _keys(seed, n=10_000):
    rng = np.random.default_rng(seed)
    return [_key(rng) for _ in range(n)]


def _loads(ring, keys):
    counts = [0] * ring.shards
    for key in keys:
        counts[ring.shard_for(key)] += 1
    return counts


@pytest.mark.parametrize("shards,vnodes,seed", [(8, DEFAULT_VNODES, 0), (3, 16, 7), (16, 64, 1)])
def test_assignment_equals_jax_for_every_key_type(shards, vnodes, seed):
    keys = _keys(shards * 100 + seed)
    kinds = {type(k) for k in keys}
    assert {bytes, str, bool, int, float, type(None), tuple} <= kinds
    ring, ref = HashRing(shards, vnodes=vnodes, seed=seed), jshard.HashRing(shards, vnodes=vnodes, seed=seed)
    assert ring._hashes == ref._hashes and ring._owners == ref._owners
    assert ring.assignment(keys) == ref.assignment(keys)
    assert [ring.shard_for(k) for k in keys] == [ref.shard_for(k) for k in keys]


def test_key_bytes_and_hashes_equal_jax():
    keys = _keys(11, n=2000) + ["1", 1, 1.0, b"1", True, False, None, ("a", 1), ("a", (1, 2.0)), -0.0, float("inf")]
    for key in keys:
        data = stable_key_bytes(key)
        assert data == jshard.stable_key_bytes(key), key
        for seed in (0, 3):
            assert hash_bytes(data, seed=seed) == jshard.hash_bytes(data, seed=seed)


@pytest.mark.parametrize("start,grow", [(4, 8), (8, 9), (2, 16)])
def test_grown_is_monotone_and_equals_jax(start, grow):
    # distinct keys only: a repeated None or small int would count its move many times
    keys = list({stable_key_bytes(k): k for k in _keys(start + grow, n=4000)}.values())
    old, new = HashRing(start), HashRing(start).grown(grow)
    assert new == HashRing(grow) and new.assignment(keys) == jshard.HashRing(start).grown(grow).assignment(keys)
    moved = 0
    for key in keys:
        a, b = old.shard_for(key), new.shard_for(key)
        if a != b:
            assert b >= start, f"{key!r} moved old→old ({a}→{b})"
            moved += 1
    assert 0 < moved <= 1.3 * len(keys) * (grow - start) / grow


def test_balance_envelope_1k_tenants_8_shards():
    counts = _loads(HashRing(8), KEYS_1K)
    assert sum(counts) == 1000 and min(counts) > 0
    assert max(counts) / (1000 / 8) <= 1.3, counts


@pytest.mark.parametrize("seed", range(4))
def test_balance_envelope_holds_across_ring_seeds(seed):
    counts = _loads(HashRing(8, seed=seed), KEYS_1K)
    assert max(counts) / (1000 / 8) <= 1.3, (seed, counts)


def test_growth_is_monotone_and_bounded():
    old, new = HashRing(4), HashRing(4).grown(8)
    moved, stolen = 0, [0] * 8
    for key in KEYS_1K:
        a, b = old.shard_for(key), new.shard_for(key)
        if a != b:
            assert b >= 4
            moved += 1
            stolen[b] += 1
    assert moved <= 1.3 * 1000 / 2, moved
    assert max(stolen[4:]) <= 1.3 * 1000 / 8, stolen


def test_single_shard_growth_moves_about_k_over_m():
    old, new = HashRing(8), HashRing(8).grown(9)
    moved = [key for key in KEYS_1K if old.shard_for(key) != new.shard_for(key)]
    assert all(new.shard_for(k) == 8 for k in moved)
    assert len(moved) <= 1.3 * 1000 / 9, len(moved)


def test_validation_matches_jax():
    for make in (HashRing, jshard.HashRing):
        with pytest.raises(ValueError, match="shard"):
            make(0)
        with pytest.raises(ValueError, match="vnode"):
            make(2, vnodes=0)
        with pytest.raises(ValueError):
            make(4).grown(4)
        with pytest.raises(ValueError):
            make(4).grown(2)
    assert repr(HashRing(3, vnodes=5, seed=2)) == repr(jshard.HashRing(3, vnodes=5, seed=2))


def test_key_types_are_distinct_and_placed():
    ring = HashRing(8)
    keys = ["1", 1, 1.0, b"1", True, None, ("a", 1), ("a", (1, 2.0))]
    blobs = [stable_key_bytes(k) for k in keys]
    assert len(set(blobs)) == len(blobs)
    for key in keys:
        assert 0 <= ring.shard_for(key) < 8


def test_hash_bytes_length_finalized():
    assert hash_bytes(b"a") != hash_bytes(b"a\x00")
    assert hash_bytes(b"") != hash_bytes(b"\x00")


def test_placement_deterministic_across_processes():
    """A child interpreter with another PYTHONHASHSEED places identically (the
    child imports only the port, so no JAX start-up is paid)."""
    prog = (
        "from metrics_tpu_torch.shard.ring import HashRing\n"
        "r = HashRing(8)\n"
        "print([r.shard_for(f'tenant-{i}') for i in range(64)])\n"
    )
    parent = [HashRing(8).shard_for(f"tenant-{i}") for i in range(64)]
    for hashseed in ("0", "12345"):
        env = dict(os.environ, PYTHONHASHSEED=hashseed)
        out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, env=env, check=True,
                             timeout=120, cwd=ROOT)
        assert eval(out.stdout.strip()) == parent, hashseed


def test_default_vnodes_exported():
    assert HashRing(2).vnodes == DEFAULT_VNODES == jshard.DEFAULT_VNODES == 256
