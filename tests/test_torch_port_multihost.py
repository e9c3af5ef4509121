"""The port's multi-process data path (``mvlpt_torch.parallel.multihost``,
``DataLoader(host_shard=...)``, ``prefetch_to_device(sharding=mesh)``)
against the JAX package's multi-host contract (mvlpt_tpu/parallel/
multihost.py; tests/test_multihost.py), on the CPU.

Each rank decodes its data rank's rows of every global batch, bit-equal to
those rows of the single-rank batch (the augmentation draws key on the
global index); the model ranks of one data row take the same rows; eval
loaders read every row. The backend follows the topology, and
``allgather_tree`` runs on two spawned gloo ranks."""

import time

import jax
import numpy as np
import pytest
import torch

from mvlpt_tpu.data.loader import DataLoader as JDataLoader
from mvlpt_tpu.parallel import local_batch_slice as j_local_batch_slice
from tests import torch_port_mesh_child as child
from tests.test_multihost import _ArrayDataset
from tests.torch_port_util import collect_ranks, run_rank, spawn_ranks

from mvlpt_torch.data.loader import DataLoader, build_data_loader, eval_mode, prefetch_to_device
from mvlpt_torch.parallel import Mesh, allgather_tree, choose_backend, local_batch_slice
from mvlpt_torch.parallel import maybe_initialize_distributed, rank_device

MESHES = [(4, 1), (2, 2), (1, 2), (2, 1)]


def _mesh(n_data, n_model, rank):
    """This rank's place in an (n_data, n_model) mesh, without groups."""
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model, d, m, None, None)


@pytest.mark.parametrize("n_data,n_model", MESHES)
def test_local_batch_slice_matches_jax(monkeypatch, n_data, n_model):
    """Each rank's (start, size) is JAX's for a process of index data_rank
    among n_data processes; the data ranks tile the batch in order, and
    the model ranks of a data row share its rows."""
    monkeypatch.setattr(jax, "process_count", lambda: n_data)
    covered = []
    for rank in range(n_data * n_model):
        mesh = _mesh(n_data, n_model, rank)
        monkeypatch.setattr(jax, "process_index", lambda d=mesh.data_rank: d)
        got = local_batch_slice(32, mesh)
        assert got == j_local_batch_slice(32)
        assert got == local_batch_slice(32, _mesh(n_data, n_model,
                                                  mesh.data_rank * n_model))
        if mesh.model_rank == 0:
            covered.extend(range(got[0], got[0] + got[1]))
    assert covered == list(range(32))


@pytest.mark.parametrize("n_data", [3, 4])
def test_local_batch_slice_uneven_raises_the_jax_message(monkeypatch, n_data):
    monkeypatch.setattr(jax, "process_count", lambda: n_data)
    with pytest.raises(ValueError) as jerr:
        j_local_batch_slice(30 if n_data == 4 else 32)
    with pytest.raises(ValueError) as terr:
        local_batch_slice(30 if n_data == 4 else 32, _mesh(n_data, 1, 0))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("multitask", [False, True])
@pytest.mark.parametrize("n_hosts", [2, 4])
def test_host_shards_reassemble_global_batch(n_hosts, multitask):
    """Each rank's rows equal those rows of the single-rank batch bit for
    bit, as the JAX loader's do (tests/test_multihost.py)."""
    bs = 8
    kw = dict(batch_size=bs, shuffle=True, num_workers=0, seed=3, drop_last=True,
              multitask=multitask)
    full = list(DataLoader(_ArrayDataset(), **kw))
    per = bs // n_hosts
    for h in range(n_hosts):
        shard = list(DataLoader(_ArrayDataset(), host_shard=(h * per, per), **kw))
        j_shard = list(JDataLoader(_ArrayDataset(), host_shard=(h * per, per), **kw))
        assert len(shard) == len(full) == len(j_shard)
        for b, gbatch in enumerate(full):
            keys = ("image", "label", "task") if multitask else ("image", "label")
            for key in keys:
                np.testing.assert_array_equal(shard[b][key], gbatch[key][h * per:(h + 1) * per])
                np.testing.assert_array_equal(shard[b][key], j_shard[b][key])
            assert shard[b]["n_valid"] == per


def test_host_shard_requires_drop_last_with_the_jax_message():
    with pytest.raises(ValueError) as jerr:
        JDataLoader(_ArrayDataset(), batch_size=8, shuffle=False, num_workers=0,
                    drop_last=False, host_shard=(0, 4))
    with pytest.raises(ValueError) as terr:
        DataLoader(_ArrayDataset(), batch_size=8, shuffle=False, num_workers=0,
                   drop_last=False, host_shard=(0, 4))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("n_data,n_model,rank,want", [
    (2, 1, 1, (4, 4)), (2, 2, 3, (4, 4)), (2, 2, 1, (0, 4)), (1, 2, 1, None), (4, 1, 2, (4, 2))])
def test_build_data_loader_sets_host_shard(n_data, n_model, rank, want):
    """A train loader under a mesh with a data axis takes its data rank's
    rows (JAX: ``build_data_loader`` under ``process_count() > 1``); a
    model axis alone, and every eval loader, read every row."""
    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.data.datum import Datum

    cfg = get_cfg_default()
    items = [Datum(impath="x.jpg", label=0, domain=0)] * 8
    mesh = _mesh(n_data, n_model, rank)
    train = build_data_loader(cfg, items, batch_size=8, tfm=lambda im: im, is_train=True,
                              mesh=mesh)
    assert train.host_shard == want
    ev = build_data_loader(cfg, items, batch_size=8, tfm=lambda im: im, is_train=False,
                           mesh=mesh)
    assert ev.host_shard is None


def test_eval_mode_clears_the_host_shard():
    """eval_mode reads every row on every rank, as the JAX eval_mode does."""
    kw = dict(batch_size=8, shuffle=True, num_workers=0, seed=3, drop_last=True)
    loader = eval_mode(DataLoader(_ArrayDataset(), host_shard=(4, 4), **kw))
    j_loader = eval_mode(JDataLoader(_ArrayDataset(), host_shard=(4, 4), **kw))
    assert loader.host_shard is None and j_loader.host_shard is None
    got, want = list(loader), list(j_loader)
    assert sum(b["n_valid"] for b in got) == len(_ArrayDataset())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])


@pytest.mark.parametrize("n_data,n_model,rank", [(2, 1, 1), (2, 2, 2), (1, 2, 1)])
def test_prefetch_stages_the_ranks_rows(n_data, n_model, rank):
    """prefetch_to_device(sharding=mesh) stages this data rank's rows of
    each batch (parallel.local_batch), n_valid as it is."""
    rng = np.random.RandomState(0)
    batches = [{"image": rng.randint(0, 256, (4, 3, 3, 3)).astype(np.uint8),
                "label": np.arange(4) + 10 * i, "n_valid": 4} for i in range(3)]
    mesh = _mesh(n_data, n_model, rank)
    got = list(prefetch_to_device(iter(batches), device="cpu", sharding=mesh))
    per = 4 // n_data
    rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    assert len(got) == 3
    for b, want in zip(got, batches):
        assert b["image"].dtype == torch.uint8 and b["n_valid"] == 4
        np.testing.assert_array_equal(b["image"].numpy(), want["image"][rows])
        np.testing.assert_array_equal(b["label"].numpy(), want["label"][rows])


@pytest.mark.parametrize("local,cards,device,want", [
    (2, 1, "cuda", "gloo"), (2, 2, "cuda", "nccl"), (1, 1, "cuda", "nccl"),
    (4, 2, "cuda", "gloo"), (2, 0, "cpu", "gloo")])
def test_backend_follows_the_topology(monkeypatch, local, cards, device, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    backend, why = choose_backend(torch.device(device), local)
    assert backend == want and why


def test_rank_device_and_no_launch(monkeypatch):
    """The rank's card is LOCAL_RANK modulo the cards; without torchrun's
    WORLD_SIZE above 1 nothing is initialised; with it but without the
    rest of torchrun's variables, it raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert rank_device("cuda") == torch.device("cuda", 1)
    assert rank_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        maybe_initialize_distributed("cpu")


def test_allgather_tree_single_process_and_two_ranks(tmp_path):
    """Without a group each leaf gains a leading axis (JAX: process_count
    1); on two gloo ranks every rank holds both ranks' leaves in rank
    order, dtypes kept."""
    single = allgather_tree({"a": np.array([1.0, 2.0]), "b": [np.int64(4)]})
    np.testing.assert_array_equal(single["a"], [[1.0, 2.0]])
    np.testing.assert_array_equal(single["b"][0], [4])
    procs = spawn_ranks(run_rank, 2, 2, str(tmp_path), child.allgather, str(tmp_path))
    collect_ranks(procs, tmp_path, time.monotonic() + 120)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(got["a"], [[0, 1.5], [1, 2.5]])
        assert got["a"].dtype == np.float32
        np.testing.assert_array_equal(got["b"], [0, 3])
        np.testing.assert_array_equal(got["c"], [[[False]], [[True]]])
