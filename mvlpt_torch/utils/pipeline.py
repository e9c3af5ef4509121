"""One-deep host/device inference pipelining.

The counterpart of ``mvlpt_tpu/utils/pipeline.py``. CUDA launches are
asynchronous, so dispatching batch i+1 before reading batch i's result
overlaps the host's work for the next batch (decode, staging, launches)
with this batch's compute, with the same results in the same order.

On the card each result's copy into pinned host memory is enqueued right
after its dispatch, with an event, and the read of batch i waits on that
event alone. A plain ``.cpu()`` after batch i+1's dispatch would queue
behind batch i+1's tower on the one stream, and the next decode would
wait for that tower too.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from mvlpt_torch.utils import profiler


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class _Pending:
    """A dispatched result on its way to the host: on the card, its copy
    into a pinned buffer enqueued with an event recorded after it; else
    the result as it is."""

    __slots__ = ("value", "event")

    def __init__(self, value):
        self.value, self.event = value, None
        if isinstance(value, torch.Tensor) and value.is_cuda:
            host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            host.copy_(value.detach(), non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            self.value = host

    def read(self) -> np.ndarray:
        """The result on the host; the wait for it is the span
        ``eval.read`` (``utils.profiler``)."""
        with profiler.span("eval.read", device=False):
            if self.event is not None:
                self.event.synchronize()
            return _to_numpy(self.value)


def pipelined_inference(loader: Iterable[dict], dispatch: Callable[[dict], object],
                        ) -> Iterator[tuple[np.ndarray, dict]]:
    """Yield ``(numpy(dispatch(batch)), batch)`` for every batch, one
    dispatch ahead of the read; bf16 results come back as fp32."""
    pend = None
    for batch in loader:
        dev = _Pending(dispatch(batch))
        if pend is not None:
            yield pend[0].read(), pend[1]
        pend = (dev, batch)
    if pend is not None:
        yield pend[0].read(), pend[1]


def dump_split_features(loader, dispatch: Callable[[dict], object], out_path: str) -> int:
    """Features over a full deterministic pass of ``loader``, saved as the
    reference's npz (``feature_list`` fp32, ``label_list``;
    lpclip/feat_extractor.py:105-167), the padded rows of the last batch
    cut at its ``n_valid``. Shared by the lpclip and extract_features
    CLIs. Returns the number of rows written."""
    from mvlpt_torch.data.loader import eval_mode

    eval_mode(loader)
    feats, labels = [], []
    for f, batch in pipelined_inference(loader, dispatch):
        n = batch.get("n_valid", len(batch["image"]))
        feats.append(f.astype(np.float32)[:n])
        labels.append(np.asarray(batch["label"])[:n])
    np.savez(out_path, feature_list=np.concatenate(feats), label_list=np.concatenate(labels))
    return int(sum(len(lab) for lab in labels))
