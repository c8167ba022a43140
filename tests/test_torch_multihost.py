"""The port's ``parallel/multihost.py`` against the JAX package's.

The cases of ``tests/test_multihost.py``, each run on both packages' module
(parametrised), and ``shard_indices`` equal to JAX's for several process
counts, epochs and seeds. The gathers across real processes are in
``tests/test_torch_distributed.py``.
"""

import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.parallel import multihost as jmh
from icl_speech_text_llm_tpu_torch.parallel import multihost as tmh

torch.set_num_threads(1)

MODULES = pytest.mark.parametrize("mh", [jmh, tmh], ids=["jax", "port"])

ROWS = [
    {"text": "hello world", "true_label": "positive", "predicted_label": "neutral",
     "dataset_type": "voxceleb"},
    {"text": "ünïcödé — spéech", "true_label": "negative", "predicted_label": "negative",
     "dataset_type": "voxceleb_greek"},
    {"text": "", "true_label": "a, b", "predicted_label": "a,b,c", "dataset_type": "hvb"},
]


@MODULES
def test_row_encoding_round_trip(mh):
    buf = mh.encode_rows(ROWS)
    assert buf.dtype == np.uint8
    assert mh.decode_rows(buf, buf.size) == ROWS


@MODULES
def test_row_encoding_round_trip_with_padding(mh):
    buf = mh.encode_rows(ROWS)
    padded = np.concatenate([buf, np.zeros(37, np.uint8)])
    assert mh.decode_rows(padded, buf.size) == ROWS


def test_row_encoding_is_jax_byte_for_byte():
    np.testing.assert_array_equal(tmh.encode_rows(ROWS), jmh.encode_rows(ROWS))


@MODULES
def test_single_process_helpers_are_noops(mh):
    assert mh.gather_predictions(ROWS) == ROWS
    assert mh.broadcast_from_main({"a": [1, 2]}) == {"a": [1, 2]}
    assert mh.process_count() == 1 and mh.is_main_process()
    mh.sync_hosts("noop")


def test_initialize_distributed_without_a_group_is_a_noop(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert tmh.initialize_distributed(device="cpu") == 0
    assert not torch.distributed.is_initialized()


def test_a_group_of_one_runs_the_collectives_alone():
    assert tmh.initialize_distributed(num_processes=1, process_id=0, device="cpu") == 0
    try:
        assert torch.distributed.get_world_size() == 1
        assert tmh.process_count() == 1 and tmh.is_main_process()
        t = torch.tensor([3.0])
        torch.distributed.all_reduce(t)
        assert t.item() == 3.0
    finally:
        tmh.shutdown_distributed()
    assert not torch.distributed.is_initialized()


@MODULES
def test_shard_indices_partition_exact(mh):
    n, pc = 20, 4
    shards = [mh.shard_indices(n, epoch=1, process_id=p, num_processes=pc) for p in range(pc)]
    assert all(len(s) == n // pc for s in shards)
    assert sorted(np.concatenate(shards).tolist()) == sorted(range(n))


@MODULES
def test_shard_indices_wraps_remainder(mh):
    n, pc = 10, 4  # pads 10 → 12 by wrapping, like DistributedSampler
    shards = [mh.shard_indices(n, epoch=0, process_id=p, num_processes=pc) for p in range(pc)]
    assert all(len(s) == 3 for s in shards)
    assert set(np.concatenate(shards).tolist()) == set(range(n))


@MODULES
def test_shard_indices_epoch_reshuffle_deterministic(mh):
    a0 = mh.shard_indices(50, epoch=0, process_id=0, num_processes=2)
    a0_again = mh.shard_indices(50, epoch=0, process_id=0, num_processes=2)
    a1 = mh.shard_indices(50, epoch=1, process_id=0, num_processes=2)
    np.testing.assert_array_equal(a0, a0_again)
    assert a0.tolist() != a1.tolist()


@MODULES
def test_shard_indices_no_shuffle_is_strided(mh):
    shards = [mh.shard_indices(8, shuffle=False, process_id=p, num_processes=2)
              for p in range(2)]
    assert shards[0].tolist() == [0, 2, 4, 6]
    assert shards[1].tolist() == [1, 3, 5, 7]


@MODULES
def test_shard_indices_single_host_full(mh):
    idx = mh.shard_indices(16, epoch=0, shuffle=False, process_id=0, num_processes=1)
    assert idx.tolist() == list(range(16))


@pytest.mark.parametrize("n,epoch,seed,shuffle", [
    (20, 0, 0, True), (37, 3, 42, True), (5, 1, 7, True), (13, 0, 0, False), (1, 2, 42, True)])
@pytest.mark.parametrize("pc", [1, 2, 3, 4, 8])
def test_shard_indices_equal_jax(n, epoch, seed, shuffle, pc):
    for p in range(pc):
        kw = dict(epoch=epoch, shuffle=shuffle, seed=seed, process_id=p, num_processes=pc)
        got, want = tmh.shard_indices(n, **kw), jmh.shard_indices(n, **kw)
        assert got.tolist() == want.tolist(), (p, pc)


def test_the_train_loops_one_process_order_is_jax_s():
    """The train loop's per-epoch order (the same on every rank) is
    ``shard_indices`` with one process, as the port's single-process copy
    was: the ``RandomState(seed + epoch)`` permutation."""
    for epoch in range(3):
        got = tmh.shard_indices(30, epoch, seed=42, process_id=0, num_processes=1)
        assert got.tolist() == np.random.RandomState(42 + epoch).permutation(30).tolist()


@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_rows_split_a_global_batch(world):
    from icl_speech_text_llm_tpu_torch.training.loop import local_rows

    rows = list(range(8))
    parts = [local_rows(rows, r, world) for r in range(world)]
    assert sum(parts, []) == rows and all(len(p) == 8 // world for p in parts)
    with pytest.raises(ValueError):
        local_rows(rows, 0, 3)
