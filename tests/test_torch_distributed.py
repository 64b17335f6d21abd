"""Cross-process sync of the port, in two CPU processes over ``gloo``.

``gather_all_tensors`` must hand every rank every rank's tensor, equal shapes
through one all-gather and ragged shapes through pad-to-max-then-trim; a
metric's ``compute()`` must then equal the metric computed in one process on
the union of the ranks' batches, for sum states and for ragged "cat" states.
"""

import socket

import numpy as np
import torch
import torch.multiprocessing as mp

from metrics_tpu_torch.classification import MulticlassAccuracy, MulticlassStatScores
from metrics_tpu_torch.utils.distributed import distributed_available, gather_all_tensors

WORLD = 2
NUM_CLASSES = 4


def _batch(rank):
    rng = np.random.default_rng(rank)
    n = 5 + 3 * rank  # ragged across ranks
    preds = torch.from_numpy(rng.integers(0, NUM_CLASSES, (n, 2)))
    target = torch.from_numpy(rng.integers(0, NUM_CLASSES, (n, 2)))
    return preds, target


def _worker(rank, port, out_dir):
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank)
    try:
        assert distributed_available()
        same = gather_all_tensors(torch.full((3,), rank, dtype=torch.int32))
        ragged = gather_all_tensors(torch.arange(6 * (rank + 1), dtype=torch.int64).reshape(3 * (rank + 1), 2))
        preds, target = _batch(rank)
        acc = MulticlassAccuracy(NUM_CLASSES, average="micro", device="cpu")
        acc.update(preds, target)
        samplewise = MulticlassStatScores(NUM_CLASSES, average=None, multidim_average="samplewise", device="cpu")
        samplewise.update(preds, target)
        torch.save(
            {"same": same, "ragged": ragged, "acc": acc.compute(), "samplewise": samplewise.compute(),
             "local_tp": acc.tp.clone()},
            f"{out_dir}/rank{rank}.pt",
        )
    finally:
        torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_single_process_gather_is_the_identity():
    t = torch.arange(4)
    assert not distributed_available()
    out = gather_all_tensors(t)
    assert len(out) == 1 and out[0] is t


def test_two_process_gather_and_metric_sync(tmp_path):
    mp.spawn(_worker, args=(_free_port(), str(tmp_path)), nprocs=WORLD, join=True)
    results = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]

    union_preds = torch.cat([_batch(r)[0] for r in range(WORLD)])
    union_target = torch.cat([_batch(r)[1] for r in range(WORLD)])
    want_acc = MulticlassAccuracy(NUM_CLASSES, average="micro", device="cpu")
    want_acc.update(union_preds, union_target)
    want_sw = MulticlassStatScores(NUM_CLASSES, average=None, multidim_average="samplewise", device="cpu")
    want_sw.update(union_preds, union_target)

    for rank, res in enumerate(results):
        assert [t.tolist() for t in res["same"]] == [[0, 0, 0], [1, 1, 1]]
        assert [tuple(t.shape) for t in res["ragged"]] == [(3, 2), (6, 2)]
        assert torch.equal(res["ragged"][1], torch.arange(12).reshape(6, 2))
        assert torch.equal(res["acc"], want_acc.compute())
        assert torch.equal(res["samplewise"], want_sw.compute())
        # compute() restored the local state after syncing
        local = MulticlassAccuracy(NUM_CLASSES, average="micro", device="cpu")
        local.update(*_batch(rank))
        assert torch.equal(res["local_tp"], local.tp)
