"""One-deep host/device inference pipelining.

The counterpart of ``mvlpt_tpu/utils/pipeline.py``. CUDA launches are
asynchronous and the copy of a result to the host is the sync point, so
dispatching batch i+1 before pulling batch i's result overlaps the host's
work for the next batch (staging, launches) with this batch's compute,
with the same results in the same order.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def pipelined_inference(loader: Iterable[dict], dispatch: Callable[[dict], object],
                        ) -> Iterator[tuple[np.ndarray, dict]]:
    """Yield ``(numpy(dispatch(batch)), batch)`` for every batch, one
    dispatch ahead of the sync point."""
    pend = None
    for batch in loader:
        dev = dispatch(batch)
        if pend is not None:
            yield _to_numpy(pend[0]), pend[1]
        pend = (dev, batch)
    if pend is not None:
        yield _to_numpy(pend[0]), pend[1]


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
