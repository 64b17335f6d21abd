"""The port's snapshot store and request journal (``metrics_tpu_torch/ckpt/store.py``,
``ckpt/faults.py``) against the JAX package's.

One counterpart for each test of ``tests/ckpt/test_store.py``,
``test_store_skips.py``, ``test_journal.py`` and the journal half of
``test_wal_fsync.py``, run on the port; then the cross-reads: generations
committed by either package's store, and journal segments appended by either
package's journal, are read by the other's (the same file names, framing and
seqs).
"""

import os

import numpy as np
import pytest

from metrics_tpu.ckpt import RequestJournal as JaxJournal
from metrics_tpu.ckpt import SnapshotStore as JaxStore
from metrics_tpu.ckpt import dumps as jax_dumps
from metrics_tpu_torch.ckpt import RequestJournal, SnapshotStore, dumps, loads
from metrics_tpu_torch.ckpt.faults import DiskFull, flip_bit, strip_payloads, tear


def _blob(val: float) -> bytes:
    return dumps({"x": np.full(64, val, np.float32), "_update_count": np.int32(int(val))})


@pytest.fixture
def store(tmp_path):
    return SnapshotStore(str(tmp_path), retain=3, durable=False)


@pytest.fixture
def journal(tmp_path):
    return RequestJournal(str(tmp_path), durable=False)


# --------------------------------------------------------------------------- tests/ckpt/test_store.py


class TestCommitAndRetention:
    def test_generations_monotone_and_latest_wins(self, store):
        for v in range(3):
            assert store.commit(_blob(v)) == v
        gen, snap = store.latest_valid()
        assert gen == 2 and float(snap.tree["x"][0]) == 2.0

    def test_retention_gc_keeps_last_k(self, store):
        for v in range(6):
            store.commit(_blob(v))
        assert store.generations() == [3, 4, 5]
        assert not os.path.exists(store.path(0))

    def test_no_tmp_files_after_commit(self, store, tmp_path):
        store.commit(_blob(1))
        assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp.")]

    def test_per_rank_sharded_layout(self, tmp_path):
        s0 = SnapshotStore(str(tmp_path), rank=0, world=2, durable=False)
        s1 = SnapshotStore(str(tmp_path), rank=1, world=2, durable=False)
        s0.commit(_blob(10))
        s1.commit(_blob(20))
        s1.commit(_blob(21))
        assert s0.generations() == [0]
        assert s1.generations() == [0, 1]
        assert float(s0.latest_valid()[1].tree["x"][0]) == 10.0
        assert float(s1.latest_valid()[1].tree["x"][0]) == 21.0


class TestFaultRecovery:
    @pytest.mark.parametrize("frac", [0.0, 0.3, 0.7, 0.99])
    def test_torn_write_falls_back_one_generation(self, store, frac):
        store.commit(_blob(1))
        store.commit(_blob(2))
        tear(store.path(1), frac=frac)
        with pytest.warns(RuntimeWarning):
            gen, snap = store.latest_valid()
        assert gen == 0 and float(snap.tree["x"][0]) == 1.0
        assert store.last_skipped and store.last_skipped[0][0] == 1

    def test_bit_flip_detected_and_skipped(self, store):
        store.commit(_blob(1))
        store.commit(_blob(2))
        flip_bit(store.path(1))
        with pytest.warns(RuntimeWarning):
            gen, snap = store.latest_valid()
        assert gen == 0 and int(snap.tree["_update_count"]) == 1

    def test_partial_manifest_file_skipped(self, store):
        store.commit(_blob(1))
        store.commit(_blob(2))
        strip_payloads(store.path(1))  # manifest intact, payloads gone
        with pytest.warns(RuntimeWarning):
            gen, snap = store.latest_valid()
        assert gen == 0

    def test_all_generations_corrupt_returns_none(self, store):
        store.commit(_blob(1))
        tear(store.path(0), keep_bytes=4)
        with pytest.warns(RuntimeWarning):
            assert store.latest_valid() is None
        assert [g for g, _ in store.last_skipped] == [0]

    def test_disk_full_leaves_no_visible_generation(self, store):
        store.commit(_blob(1))
        with DiskFull() as df:
            with pytest.raises(OSError):
                store.commit(_blob(2))
        assert df.refused == 1
        gen, snap = store.latest_valid()
        assert gen == 0 and float(snap.tree["x"][0]) == 1.0
        assert store.generations() == [0]

    def test_caller_validation_skips_schema_mismatch(self, store):
        store.commit(dumps({"y": np.ones(3)}, schema_version=1))
        store.commit(dumps({"x": np.ones(3)}, schema_version=7))

        def validate(snap):
            if snap.schema_version != 1:
                raise ValueError("wrong schema")

        with pytest.warns(RuntimeWarning):
            gen, snap = store.latest_valid(validate=validate)
        assert gen == 0 and "y" in snap.tree

    def test_round_trip_bit_identical_through_store(self, store):
        rng = np.random.default_rng(3)
        tree = {"a": rng.standard_normal((17, 5)).astype(np.float32), "b": [rng.integers(0, 9, 4)]}
        gen = store.commit(dumps(tree))
        snap = loads(store.read(gen))
        assert np.array_equal(snap.tree["a"], tree["a"])
        assert np.array_equal(snap.tree["b"][0], tree["b"][0])


# --------------------------------------------------------------------------- tests/ckpt/test_store_skips.py


class TestSkipWarnings:
    def test_skip_warns_and_names_the_fallback(self, tmp_path):
        store = SnapshotStore(str(tmp_path), durable=False)
        store.commit(_blob(0))
        store.commit(_blob(1))
        tear(store.path(1), frac=0.5)
        with pytest.warns(RuntimeWarning, match="recovered from an older generation"):
            gen, snap = store.latest_valid()
        assert gen == 0
        assert store.last_skipped and store.last_skipped[0][0] == 1

    def test_total_loss_warns_loudly(self, tmp_path):
        store = SnapshotStore(str(tmp_path), durable=False)
        store.commit(_blob(0))
        flip_bit(store.path(0), offset=40)
        with pytest.warns(RuntimeWarning, match="NO valid generation remained"):
            assert store.latest_valid() is None

    def test_clean_scan_is_silent(self, tmp_path, recwarn):
        store = SnapshotStore(str(tmp_path), durable=False)
        store.commit(_blob(0))
        gen, _ = store.latest_valid()
        assert gen == 0
        assert not [w for w in recwarn.list if "skipped" in str(w.message)]

    def test_warning_lists_reasons_capped(self, tmp_path):
        store = SnapshotStore(str(tmp_path), retain=6, durable=False)
        for v in range(5):
            store.commit(_blob(v))
        for g in range(1, 5):
            tear(store.path(g), frac=0.3)
        with pytest.warns(RuntimeWarning, match=r"skipped 4 .*; \.\.\."):
            gen, _ = store.latest_valid()
        assert gen == 0


# --------------------------------------------------------------------------- tests/ckpt/test_journal.py


class TestAppendReplay:
    def test_seqs_monotone_and_replay_ordered(self, journal):
        assert journal.append(b"a") == 0
        assert journal.append_many([b"b", b"c", b"d"]) == [1, 2, 3]
        assert list(journal.replay()) == [(0, b"a"), (1, b"b"), (2, b"c"), (3, b"d")]

    def test_replay_after_seq_is_exclusive(self, journal):
        journal.append_many([b"a", b"b", b"c"])
        assert [s for s, _ in journal.replay(after_seq=1)] == [2]
        assert [s for s, _ in journal.replay(after_seq=2)] == []

    def test_empty_journal(self, journal):
        assert journal.last_seq == -1
        assert list(journal.replay()) == []


class TestTornTail:
    def test_partial_frame_dropped(self, journal, tmp_path):
        journal.append_many([b"keep-me", b"also-keep"])
        journal.close()
        path = journal._segments()[-1][1]
        with open(path, "ab") as f:
            f.write(b"\x20\x00\x00\x00\x99\x99\x99\x99part")  # frame promising more bytes
        reopened = RequestJournal(str(tmp_path), durable=False)
        assert [p for _, p in reopened.replay()] == [b"keep-me", b"also-keep"]
        assert reopened.last_seq == 1

    def test_reopen_truncates_tear_and_continues_cleanly(self, journal, tmp_path):
        journal.append_many([b"r0", b"r1"])
        journal.close()
        path = journal._segments()[-1][1]
        with open(path, "ab") as f:
            f.write(b"\x08\x00")  # torn mid-header
        j2 = RequestJournal(str(tmp_path), durable=False)
        assert j2.append(b"r2") == 2
        j2.flush()
        assert list(j2.replay()) == [(0, b"r0"), (1, b"r1"), (2, b"r2")]

    def test_corrupt_payload_stops_replay(self, journal):
        journal.append_many([b"good", b"evil", b"after"])
        journal.flush()
        path = journal._segments()[-1][1]
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size - 8)  # inside the last record's payload
            f.write(b"X")
        replayed = [p for _, p in journal.replay()]
        assert replayed[:2] == [b"good", b"evil"]
        assert b"after" not in replayed or replayed == [b"good", b"evil"]


class TestRotation:
    def test_rotate_drops_covered_segments(self, journal):
        journal.append_many([b"a", b"b"])
        journal.rotate(covered_seq=1)  # snapshot covered both
        journal.append(b"c")
        journal.flush()
        assert len(journal._segments()) == 1  # the covered segment is gone
        assert list(journal.replay(after_seq=1)) == [(2, b"c")]

    def test_rotate_keeps_uncovered_tail(self, journal):
        journal.append_many([b"a", b"b", b"c"])
        journal.rotate(covered_seq=0)  # snapshot only covered seq 0
        journal.append(b"d")
        journal.flush()
        assert [s for s, _ in journal.replay(after_seq=0)] == [1, 2, 3]

    def test_seq_continuity_across_reopen_and_rotation(self, journal, tmp_path):
        journal.append_many([b"a", b"b"])
        journal.rotate(covered_seq=1)
        journal.append(b"c")
        journal.close()
        j2 = RequestJournal(str(tmp_path), durable=False)
        assert j2.last_seq == 2
        assert j2.append(b"d") == 3
        j2.flush()
        assert [s for s, _ in j2.replay(after_seq=1)] == [2, 3]


class TestTailCursor:
    def test_cursor_reads_only_new_records_and_follows_rotation(self, journal):
        cursor = journal.tail_cursor()
        journal.append_many([b"a", b"b"])
        assert cursor.read() == [(0, b"a"), (1, b"b")]
        assert cursor.read() == []
        journal.rotate(covered_seq=-1)  # a new segment, nothing dropped
        journal.append(b"c")
        assert cursor.read() == [(2, b"c")]
        assert list(journal.read_from(0)) == [(1, b"b"), (2, b"c")]


# --------------------------------------------------------------------------- the journal half of tests/ckpt/test_wal_fsync.py


class TestJournalSyncedSeq:
    def test_fsync_advances_synced_seq(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.append_many([b"a", b"b", b"c"])
        assert j.synced_seq == -1
        j.flush(fsync=True)
        assert j.synced_seq == 2
        j.append_many([b"d", b"e"])
        assert j.last_seq == 4 and j.synced_seq == 2
        j.close()

    def test_flush_without_fsync_does_not_advance(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.append(b"a")
        j.flush()
        assert j.synced_seq == -1
        j.close()

    def test_close_and_reopen_sync(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.append_many([b"a", b"b"])
        j.close()
        assert j.synced_seq == 1
        j2 = RequestJournal(str(tmp_path))
        assert j2.synced_seq == j2.last_seq == 1
        j2.close()

    def test_torn_tail_reopen_never_rewinds_past_synced(self, tmp_path):
        j = RequestJournal(str(tmp_path))
        j.append_many([b"r0", b"r1", b"r2"])
        j.flush(fsync=True)
        synced = j.synced_seq
        assert synced == 2
        j.append_many([b"r3", b"r4"])
        j.flush()
        seg = j._segments()[0][1]
        with open(seg, "r+b") as f:  # crash: the final record's frame is torn mid-write
            f.truncate(os.path.getsize(seg) - 3)
        j._file.close()  # abandon without close() (close would fsync)
        j._file = None
        j2 = RequestJournal(str(tmp_path))
        assert j2.last_seq >= synced
        assert j2.last_seq == 3
        assert [p for _, p in j2.replay()] == [b"r0", b"r1", b"r2", b"r3"]
        assert j2.append(b"r4-again") == 4
        j2.close()

    def test_non_durable_journal_never_syncs(self, tmp_path):
        j = RequestJournal(str(tmp_path), durable=False)
        j.append(b"a")
        j.flush(fsync=True)
        assert j.synced_seq == -1
        j.close()


# --------------------------------------------------------------------------- the two packages


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_generations_of_either_package_read_in_the_other(tmp_path, writer):
    """Both stores name, retain and validate generations alike: the reader sees
    the writer's generations, the newest intact one first, and skips a torn one."""
    make_writer, make_reader = (JaxStore, SnapshotStore) if writer == "jax" else (SnapshotStore, JaxStore)
    blob = jax_dumps if writer == "jax" else dumps
    w = make_writer(str(tmp_path), retain=2, rank=1, world=2, durable=False)
    for v in range(3):
        w.commit(blob({"x": np.full(8, v, np.int32)}, meta={"seq": v}))
    r = make_reader(str(tmp_path), retain=2, rank=1, world=2, durable=False)
    assert r.generations() == w.generations() == [1, 2]
    assert r.read_meta(2) == {"seq": 2}
    assert r.path(2) == w.path(2)
    tear(w.path(2), frac=0.5)
    with pytest.warns(RuntimeWarning):
        gen, snap = r.latest_valid()
    assert gen == 1 and snap.tree["x"].dtype == np.int32 and int(snap.tree["x"][0]) == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_of_either_package_replays_in_the_other(tmp_path, writer):
    """Segment names, framing and seqs are shared: the reader replays the
    writer's records, truncates its torn tail on reopen and continues the seqs."""
    make_writer, make_reader = (JaxJournal, RequestJournal) if writer == "jax" else (RequestJournal, JaxJournal)
    w = make_writer(str(tmp_path), durable=False)
    w.append_many([b"a", b"b"])
    w.rotate(covered_seq=0)
    w.append_many([b"c", b"d"])
    w.close()
    seg = w._segments()[-1][1]
    with open(seg, "ab") as f:
        f.write(b"\x05\x00")  # a crash mid-append
    r = make_reader(str(tmp_path), durable=False)
    assert [name for _, name in r._segments()] == [name for _, name in w._segments()]
    assert r.last_seq == 3
    assert list(r.replay(after_seq=0)) == [(1, b"b"), (2, b"c"), (3, b"d")]
    assert r.append(b"e") == 4
    r.close()
    assert list(make_writer(str(tmp_path), durable=False).replay(after_seq=2)) == [(3, b"d"), (4, b"e")]
