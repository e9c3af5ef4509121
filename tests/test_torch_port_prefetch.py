"""Staging on the device (``mvlpt_torch.data.loader.prefetch_to_device``
and ``DeviceStager``) on the CPU, against the bare loader and the JAX
package's ``prefetch_to_device``: the same batches in the same order at
``size`` 1, 2 and more than the epoch, ``n_valid`` a host int, every
array's dtype kept (uint8 under TPU.DEVICE_NORMALIZE) (a mesh's
``sharding``: tests/test_torch_port_multihost.py); the training CLI's per-step losses bit
for bit with and without its staging; and the windowed epoch's progress
lines, printed once the next window is staged, the same lines in the
same order as the JAX CLI's."""

import re

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mvlpt_tpu.data.loader import prefetch_to_device as j_prefetch
from mvlpt_torch.data.loader import DeviceStager, build_data_loader, prefetch_to_device
from tests.test_torch_port_trainer import (  # noqa: F401 (fixtures)
    _argv, _run, env, init_dir, synthetic_vocab, world)


def _loader(tmp_path, is_train: bool, to_uint8: bool):
    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.data.datum import Datum
    from mvlpt_torch.data.transforms import build_transform

    rng = np.random.default_rng(0)
    items = []
    for i in range(11):
        p = tmp_path / f"im_{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (36 + i, 40, 3), np.uint8)).save(p, quality=90)
        items.append(Datum(impath=str(p), label=i % 3))
    cfg = get_cfg_default()
    cfg.INPUT.SIZE = (24, 24)
    cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip", "normalize")
    cfg.TPU.DEVICE_NORMALIZE = to_uint8
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.SEED = 5
    return build_data_loader(cfg, items, 4, build_transform(cfg, is_train), is_train)


@pytest.mark.parametrize("size", [1, 2, 9], ids=["size1", "size2", "past-the-epoch"])
@pytest.mark.parametrize("is_train,to_uint8", [(True, True), (False, False)],
                         ids=["train-uint8", "eval-float"])
def test_batches_equal_the_bare_loader(tmp_path, size, is_train, to_uint8):
    loader = _loader(tmp_path, is_train, to_uint8)
    bare = list(loader)
    loader.epoch = 0  # the same epoch's draws again
    staged = list(prefetch_to_device(loader, size=size, device="cpu"))
    loader.epoch = 0
    jax_staged = list(j_prefetch(iter(loader), size=size))
    assert len(staged) == len(bare) == len(jax_staged) == (2 if is_train else 3)
    for got, want, jwant in zip(staged, bare, jax_staged):
        assert got.keys() == want.keys() == jwant.keys()
        assert type(got["n_valid"]) is int and got["n_valid"] == want["n_valid"]
        for k in ("image", "label"):
            assert isinstance(got[k], torch.Tensor)
            assert got[k].dtype == torch.from_numpy(want[k]).dtype
            np.testing.assert_array_equal(got[k].numpy(), want[k])
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(jwant[k]))
    assert staged[0]["image"].dtype == (torch.uint8 if to_uint8 else torch.float32)
    if not is_train:
        assert [b["n_valid"] for b in staged] == [4, 4, 3]


def test_stager_keeps_host_values_and_empty_iterators():
    stage = DeviceStager("cpu")
    out = stage({"image": np.zeros((2, 3), np.uint8), "n_valid": 2, "num_tasks": 1})
    assert out["n_valid"] == 2 and out["num_tasks"] == 1
    assert out["image"].dtype == torch.uint8 and out["image"].device.type == "cpu"
    assert list(prefetch_to_device(iter([]), device="cpu")) == []


def test_pinned_ring_reuses_a_buffer_once_its_copy_is_done(monkeypatch):
    """The ring (the card's path; pinned memory faked on the CPU): ``depth``
    buffers a (shape, dtype); the oldest is reused after a wait on the
    event of the copy that last read it, and never twice in one batch."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: empty(*a, **k))

    class Event:
        def __init__(self):
            self.waits = 0

        def synchronize(self):
            self.waits += 1

    stager = DeviceStager("cpu", depth=2)
    x = np.arange(6, dtype=np.uint8).reshape(2, 3)
    bufs, events = [], []
    for i in range(4):
        buf, slot = stager._pinned(x + i, [])
        slot[1] = Event()
        bufs.append(buf)
        events.append(slot[1])
        assert np.array_equal(buf.numpy(), x + i)
    assert bufs[2] is bufs[0] and bufs[3] is bufs[1] and bufs[0] is not bufs[1]
    assert [e.waits for e in events] == [1, 1, 0, 0]
    other, _ = stager._pinned(x.astype(np.int32), [])
    assert other.dtype == torch.int32 and all(other is not b for b in bufs)
    taken = []
    first, _ = stager._pinned(x, taken)
    second, _ = stager._pinned(x, taken)
    third, _ = stager._pinned(x, taken)  # the ring's two are this batch's: a third
    assert len({id(first), id(second), id(third)}) == 3


_WINDOWED = ("TRAIN.STEPS_PER_DISPATCH", "3", "TRAIN.WINDOW_MIN_TAIL", "1",
             "TEST.NO_TEST", "True", "TEST.FINAL_MODEL", "last_step", "TPU.DEVICE_NORMALIZE",
             "True")


@pytest.mark.parametrize("opts", [(), _WINDOWED], ids=["per-step", "windowed"])
def test_cli_losses_bit_equal_without_staging(env, init_dir, tmp_path, monkeypatch, opts):
    """The CLI's per-step losses and final prompt, staged through
    prefetch_to_device, equal bit for bit a run whose batches reach the
    steps unstaged (host numpy batches, the code before staging)."""
    from mvlpt_torch.train import trainer as t_trainer

    argv = ["--model-dir", init_dir]
    staged, staged_losses = _run("port", _argv(env, tmp_path / "staged", *argv, opts=opts),
                                 monkeypatch)
    with monkeypatch.context() as mp:
        mp.setattr(t_trainer, "prefetch_to_device", lambda it, **kw: it)
        bare, bare_losses = _run("port", _argv(env, tmp_path / "bare", *argv, opts=opts),
                                 monkeypatch)
    assert len(staged_losses) == 14 and staged_losses == bare_losses
    for a, b in zip(jax.tree_util.tree_leaves(staged.state.prompt_params),
                    jax.tree_util.tree_leaves(bare.state.prompt_params)):
        assert torch.equal(a, b)
    assert all(e["stage_s"] >= 0 for e in staged.timings["epochs"])


_PROGRESS = re.compile(r"^epoch \[(\d+)/(\d+)\] batch \[(\d+)/(\d+)\] (.*) lr (\S+)$")


def _progress(out_dir) -> list:
    with open(out_dir / "log.txt") as f:
        return [m.groups() for m in map(_PROGRESS.match, f.read().splitlines()) if m]


def test_windowed_progress_printed_after_the_next_window_is_staged(env, init_dir, tmp_path,
                                                                   monkeypatch):
    """Windows of 3, 3 and 1 over two epochs of 7 batches: each window's
    line is printed once the next window's batches are staged (the host
    decodes while the card replays), and the lines are the JAX CLI's, in
    the same order, heads and lr equal and values within the printed
    digits."""
    from mvlpt_torch.train.trainer import PromptTrainer

    events = []
    stage = DeviceStager.stage
    progress = PromptTrainer._print_progress
    monkeypatch.setattr(DeviceStager, "stage",
                        lambda self, b: events.append("stage") or stage(self, b))
    monkeypatch.setattr(PromptTrainer, "_print_progress",
                        lambda self, done, *a: events.append(done) or progress(self, done, *a))
    argv = ["--model-dir", init_dir]
    _run("port", _argv(env, tmp_path / "port", *argv, opts=_WINDOWED), monkeypatch)
    _run("jax", _argv(env, tmp_path / "jax", *argv, opts=_WINDOWED), monkeypatch)

    staged, per_epoch = 0, []
    for e in events:
        if e == "stage":
            staged += 1
        else:
            per_epoch.append((e, staged))
    # (batches done, batches staged so far in the run) at each print
    assert per_epoch == [(3, 7), (6, 7), (7, 7), (3, 14), (6, 14), (7, 14)]

    port, jax_ = _progress(tmp_path / "port"), _progress(tmp_path / "jax")
    assert len(port) == len(jax_) == 6
    for a, b in zip(port, jax_):
        assert a[:4] == b[:4] and a[5] == b[5]
        va, vb = a[4].split(), b[4].split()
        va, vb = dict(zip(va[::2], va[1::2])), dict(zip(vb[::2], vb[1::2]))
        assert va.keys() == vb.keys()  # the JAX meter keeps its keys sorted
        assert all(abs(float(va[k]) - float(vb[k])) <= 2e-4 for k in va), (a, b)
