"""``utils.pipeline``: the one-deep read-ahead of the extraction and eval
passes, on the CPU.

``pipelined_inference`` enqueues each result's copy to the host right
after its dispatch (on the card into pinned memory, with an event) and
reads batch i after batch i+1's dispatch. It must yield the same arrays in
the same order as a sequential read, dispatch batch i+1 before it reads
batch i, and ``dump_split_features`` must write the same arrays as the
read it replaced (``.cpu()`` after the next dispatch)."""

import numpy as np
import pytest
import torch

from mvlpt_torch.data.loader import DataLoader
from mvlpt_torch.utils import pipeline
from tests.test_multihost import _ArrayDataset


def _shipped_before(loader, dispatch):
    """The read of the parent's pipelined_inference: ``.cpu()`` of batch
    i after batch i+1's dispatch, bf16 upcast to fp32."""
    def read(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    pend = None
    for batch in loader:
        dev = dispatch(batch)
        if pend is not None:
            yield read(pend[0]), pend[1]
        pend = (dev, batch)
    if pend is not None:
        yield read(pend[0]), pend[1]


def _dispatch(batch):
    x = torch.from_numpy(batch["image"])
    return (x * 3 + 1).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_batches", [0, 1, 4])
def test_same_arrays_in_the_same_order(dtype, n_batches):
    rng = np.random.RandomState(n_batches)
    batches = [{"image": rng.randn(3, 5).astype(np.float32), "i": i} for i in range(n_batches)]

    def dispatch(b):
        return (torch.from_numpy(b["image"]) * 2).to(dtype)

    got = list(pipeline.pipelined_inference(iter(batches), dispatch))
    assert [b["i"] for _, b in got] == list(range(n_batches))
    for (arr, b) in got:
        want = (torch.from_numpy(b["image"]) * 2).to(dtype).float().numpy()
        assert arr.dtype == np.float32
        np.testing.assert_array_equal(arr, want)


class _Logged:
    """A dispatched result whose read (numpy's ``__array__``) is logged."""

    def __init__(self, log, i):
        self.log, self.i = log, i

    def __array__(self, dtype=None, copy=None):
        self.log.append(("read", self.i))
        return np.full(2, self.i, np.float32)


def test_dispatches_ahead_of_each_read():
    log = []

    def loader():
        for i in range(3):
            log.append(("next", i))
            yield {"i": i}

    def dispatch(b):
        log.append(("dispatch", b["i"]))
        return _Logged(log, b["i"])

    for arr, b in pipeline.pipelined_inference(loader(), dispatch):
        log.append(("yield", b["i"]))
        np.testing.assert_array_equal(arr, [b["i"]] * 2)
    assert log == [("next", 0), ("dispatch", 0), ("next", 1), ("dispatch", 1), ("read", 0),
                   ("yield", 0), ("next", 2), ("dispatch", 2), ("read", 1), ("yield", 1),
                   ("read", 2), ("yield", 2)]


def test_dump_split_features_writes_the_same_arrays(tmp_path, monkeypatch):
    """dump_split_features with the read-ahead against the same function
    with the parent's read: feature_list and label_list equal bit for bit,
    in dtype and shape too (a padded tail batch cut at n_valid)."""
    def loader():
        return DataLoader(_ArrayDataset(n=11, dim=6), batch_size=4, shuffle=True, seed=2,
                          num_workers=0, drop_last=True)

    n = pipeline.dump_split_features(loader(), _dispatch, str(tmp_path / "new.npz"))
    with monkeypatch.context() as mp:
        mp.setattr(pipeline, "pipelined_inference", _shipped_before)
        n_old = pipeline.dump_split_features(loader(), _dispatch, str(tmp_path / "old.npz"))
    assert n == n_old == 11
    new, old = np.load(tmp_path / "new.npz"), np.load(tmp_path / "old.npz")
    assert sorted(new.files) == sorted(old.files) == ["feature_list", "label_list"]
    for key in new.files:
        assert new[key].dtype == old[key].dtype and new[key].shape == old[key].shape
        assert new[key].tobytes() == old[key].tobytes()
