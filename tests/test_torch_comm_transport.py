"""The comm plane's transports and the ragged gather against the JAX package's.

The same seeded numpy buffers go through both packages' ``LoopbackWorld``,
fault injectors, fakes and ``gather_ragged``: the same rows in the same rank
order, the same collectives issued (pad-to-max against exact-size broadcast),
the same failure types and attributed peers. ``gather_all_tensors`` rides
``gather_ragged`` in both packages, so ranks passing tensors of different
``ndim`` raise the JAX package's ``ValueError`` (ROADMAP C.7).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu import comm as jcomm
from metrics_tpu.utils.distributed import gather_all_tensors as jax_gather_all_tensors
from metrics_tpu_torch import comm
from metrics_tpu_torch.comm.transport import current_call_cancelled, set_call_cancel_event
from metrics_tpu_torch.utils.distributed import gather_all_tensors

PACKAGES = {"port": comm, "jax": jcomm}


class Counting:
    """Counts every allgather and broadcast a wrapped transport issues."""

    def __init__(self, inner):
        self._inner = inner
        self.calls = []
        self.rank = getattr(inner, "rank", None)
        self.supports_broadcast = inner.supports_broadcast

    def world_size(self):
        return self._inner.world_size()

    def allgather(self, x):
        self.calls.append(("allgather", tuple(np.asarray(x).shape)))
        return self._inner.allgather(x)

    def broadcast_from(self, x, root, shape, dtype):
        self.calls.append(("broadcast", root))
        return self._inner.broadcast_from(x, root, shape, dtype)


def _run_both(fn_for_rank, world):
    """``fn_for_rank(pkg, transport, rank)`` on every rank of both packages'
    loopback worlds; ``{"port": [...], "jax": [...]}``."""
    out = {}
    for name, pkg in PACKAGES.items():
        lw = pkg.LoopbackWorld(world, timeout=10.0)
        out[name] = lw.run([lambda t, r=r, pkg=pkg: fn_for_rank(pkg, t, r) for r in range(world)])
    return out


def _equal_rows(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "int32", "int8", "bool", "float16"])
def test_loopback_allgather_and_broadcast_rank_order(world, dtype):
    rng = np.random.default_rng(world)
    bufs = [(rng.standard_normal((3, 2)) * 10).astype(dtype) for _ in range(world)]

    def fn(pkg, t, r):
        rows = t.allgather(bufs[r])
        roots = [t.broadcast_from(bufs[r] if r == root else None, root, (3, 2), dtype) for root in range(world)]
        return rows, roots

    out = _run_both(fn, world)
    for r in range(world):
        _equal_rows(out["port"][r][0], out["jax"][r][0])
        _equal_rows(out["port"][r][1], out["jax"][r][1])
        _equal_rows(out["port"][r][0], bufs)


def _ragged(world, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(world)]
    if kind == "mild":  # pad-to-max ships under 1.25x: one padded allgather
        return [rng.standard_normal((8 + (r % 2), 3)).astype(np.float32) for r in range(world)]
    if kind == "skewed":  # pad-to-max would ship far more: exact broadcasts
        return [rng.integers(0, 9, (1 + 40 * (r == 0), 2)).astype(np.int32) for r in range(world)]
    if kind == "empty_rank":
        return [rng.standard_normal((0 if r == 1 else 5,)).astype(np.float32) for r in range(world)]
    raise ValueError(kind)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["equal", "mild", "skewed", "empty_rank"])
def test_gather_ragged_rows_and_collectives_equal_the_jax_package(world, kind):
    shards = _ragged(world, kind)

    def fn(pkg, t, r):
        counted = Counting(t)
        rows = pkg.gather_ragged(counted, shards[r])
        return rows, counted.calls

    out = _run_both(fn, world)
    for r in range(world):
        _equal_rows(out["port"][r][0], out["jax"][r][0])
        _equal_rows(out["port"][r][0], shards)
        assert out["port"][r][1] == out["jax"][r][1]


@pytest.mark.parametrize("name", ["port", "jax"])
def test_gather_ragged_without_a_rank_pads_instead_of_broadcasting(name):
    pkg = PACKAGES[name]
    shards = _ragged(2, "skewed")
    scripted = pkg.ScriptedFakeTransport(2, [[np.asarray(s.shape, np.int64) for s in shards],
                                             [np.pad(s, ((0, 41 - len(s)), (0, 0))) for s in shards]])
    rows = pkg.gather_ragged(scripted, shards[0])
    _equal_rows(rows, shards)
    assert scripted.calls == 2


def _raised(fn):
    """Run ``fn`` and hand back what it raised (caught inside the rank, so
    the loopback world does not abort its barriers under the other ranks)."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the test inspects it
        return exc
    return None


@pytest.mark.parametrize("world", [2, 3])
def test_mixed_rank_shards_raise_value_error_in_both_packages(world):
    shards = [np.zeros((2,) * (1 + (r == world - 1)), np.float32) for r in range(world)]
    for name, pkg in PACKAGES.items():
        lw = pkg.LoopbackWorld(world, timeout=10.0)
        errors = lw.run([lambda t, r=r: _raised(lambda: pkg.gather_ragged(t, shards[r])) for r in range(world)])
        assert all(isinstance(e, ValueError) and "mixed-rank" in str(e) for e in errors), (name, errors)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["equal", "mild", "skewed"])
def test_gather_all_tensors_rides_gather_ragged_like_the_jax_package(world, kind):
    """``gather_all_tensors(transport=...)``: the same rows as the JAX
    package's, as tensors on the input's device."""
    shards = _ragged(world, kind, seed=3)
    port = comm.LoopbackWorld(world, timeout=10.0).run(
        [lambda t, r=r: gather_all_tensors(torch.from_numpy(shards[r]), transport=t) for r in range(world)]
    )
    ref = jcomm.LoopbackWorld(world, timeout=10.0).run(
        [lambda t, r=r: jax_gather_all_tensors(jnp.asarray(shards[r]), transport=t) for r in range(world)]
    )
    for r in range(world):
        assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in port[r])
        _equal_rows([x.numpy() for x in port[r]], [np.asarray(x) for x in ref[r]])


def test_gather_all_tensors_refuses_mixed_rank_shards_c7():
    """ROADMAP C.7: the port's ``gather_all_tensors`` went to
    ``torch.distributed`` directly and, given tensors of different ``ndim``,
    padded or failed inside the backend; the JAX package raises
    ``ValueError("mixed-rank ...")`` before any payload moves."""
    shards = [np.zeros((3,), np.float32), np.zeros((3, 1), np.float32)]
    port = comm.LoopbackWorld(2, timeout=10.0).run(
        [lambda t, r=r: _raised(lambda: gather_all_tensors(torch.from_numpy(shards[r]), transport=t)) for r in range(2)]
    )
    ref = jcomm.LoopbackWorld(2, timeout=10.0).run(
        [lambda t, r=r: _raised(lambda: jax_gather_all_tensors(jnp.asarray(shards[r]), transport=t)) for r in range(2)]
    )
    for errors in (port, ref):
        assert all(isinstance(e, ValueError) and "mixed-rank" in str(e) for e in errors), errors
    assert [str(e) for e in port] == [str(e) for e in ref]


@pytest.mark.parametrize("name", ["port", "jax"])
def test_straggler_is_attributed_not_deadlocked(name):
    pkg = PACKAGES[name]
    lw = pkg.LoopbackWorld(3, timeout=0.3)
    errors = [None] * 3

    def rank(r):
        t = lw.transport(r)
        try:
            t.allgather(np.zeros(2, np.float32))
            if r != 2:
                t.allgather(np.zeros(2, np.float32))  # rank 2 never shows up for the second round
        except pkg.TransportError as exc:
            errors[r] = exc

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    for r in (0, 1):
        assert isinstance(errors[r], pkg.PeerLostError) and errors[r].peers == (2,)
    assert errors[2] is None
    lw.reset()
    out = lw.run([lambda t: t.allgather(np.ones(1, np.int32))] * 3)
    assert [len(rows) for rows in out] == [3, 3, 3]


@pytest.mark.parametrize("name", ["port", "jax"])
def test_fault_injectors(name):
    pkg = PACKAGES[name]
    flaky = pkg.FlakyTransport(pkg.ReplicaFakeTransport(2), fail=2)
    for _ in range(2):
        with pytest.raises(pkg.TransportError):
            flaky.allgather(np.ones(1))
    assert flaky.failures_injected == 2 and len(flaky.allgather(np.ones(1))) == 2
    stall = pkg.StallTransport(pkg.ReplicaFakeTransport(2), stall_s=0.05, stalls=1)
    t0 = time.perf_counter()
    stall.allgather(np.ones(1))
    assert time.perf_counter() - t0 >= 0.05
    t0 = time.perf_counter()
    stall.allgather(np.ones(1))
    assert time.perf_counter() - t0 < 0.05
    with pytest.raises(pkg.PeerLostError):
        pkg.DeadPeerTransport(2).allgather(np.ones(1))
    with pytest.raises(pkg.PeerLostError):
        pkg.DeadPeerTransport(2).broadcast_from(np.ones(1), 0, (1,), np.float64)
    rows = pkg.ScriptedFakeTransport(3, [[np.zeros(2), np.ones(2), np.full(2, 2.0)]], rank=1).allgather(np.full(2, 7.0))
    _equal_rows(rows, [np.zeros(2), np.full(2, 7.0), np.full(2, 2.0)])
    assert pkg.LocalTransport().allgather(np.arange(3))[0].tolist() == [0, 1, 2]


def test_cancelled_call_is_discarded_by_the_loopback_world():
    lw = comm.LoopbackWorld(2, timeout=1.0)
    event = threading.Event()
    event.set()
    set_call_cancel_event(event)
    try:
        assert current_call_cancelled()
        with pytest.raises(comm.TransportError, match="abandoned"):
            lw.transport(0).allgather(np.zeros(1))
    finally:
        set_call_cancel_event(None)
    assert not current_call_cancelled()


def test_subset_transport_maps_global_ranks_to_dense_indices():
    lw = comm.LoopbackWorld(4, timeout=5.0)
    live = (0, 2, 3)
    out = [None] * 4

    def rank(r):
        sub = lw.transport(r).subset(live)
        out[r] = (sub.rank, sub.world_size(), [int(v[0]) for v in sub.allgather(np.array([r]))])

    threads = [threading.Thread(target=rank, args=(r,)) for r in live]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert out[0] == (0, 3, [0, 2, 3]) and out[2] == (1, 3, [0, 2, 3]) and out[3] == (2, 3, [0, 2, 3])
    assert lw.transport(1).subset(range(4)).world_size() == 4
