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
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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
