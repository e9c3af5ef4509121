"""Host input pipeline: threaded decode/transform workers feeding
fixed-shape numpy batches.

The counterpart of ``mvlpt_tpu/data/loader.py`` (the reference's torch
DataLoader + Dassl DatasetWrapper, mvlpt.py:661-720): seeded shuffling,
worker threads for JPEG decode and PIL transforms (PIL releases the GIL
for the heavy ops), static batch shapes (train loaders drop the tail,
eval loaders pad the tail batch and report the pad so metrics can mask
it). Batches are numpy; the trainer stages them on the device. The JAX
package's multi-host row sharding and its ``prefetch_to_device`` are
not ported (ROADMAP.md Queue 1, items 7-8).
"""

from __future__ import annotations

import concurrent.futures as cf
import random
from typing import Callable, Iterator, Sequence

import numpy as np
from PIL import Image

from mvlpt_torch.data.datum import Datum


def _load_image(impath: str) -> Image.Image:
    from mvlpt_torch.data.zipio import open_image

    return open_image(impath)  # plain path or zip@member reference


class _TransformedDataset:
    """items + transform -> (image HWC f32, label, domain)."""

    def __init__(self, items: Sequence[Datum], transform: Callable,
                 label_transform: Callable | None = None):
        self.items = items
        self.transform = transform
        self.label_transform = label_transform

    def __len__(self):
        return len(self.items)

    def _transform_takes_rng(self) -> bool:
        """Signature-inspected (never by catching TypeError, which would
        swallow real errors raised inside the transform). Cached per
        transform object — this sits in the per-item hot loop."""
        if getattr(self, "_rng_ok_for", None) is not self.transform:
            import inspect

            try:
                ok = "rng" in inspect.signature(self.transform).parameters
            except (TypeError, ValueError):
                ok = False
            self._rng_ok_for, self._rng_ok = self.transform, ok
        return self._rng_ok

    def __getitem__(self, idx: int, rng: random.Random | None = None):
        d = self.items[idx]
        img = _load_image(d.impath)
        if rng is not None and self._transform_takes_rng():
            img = self.transform(img, rng=rng)
        else:
            img = self.transform(img)
        label = d.label if self.label_transform is None else self.label_transform(d.label)
        return img, label, d.domain


class DataLoader:
    """Deterministic batched iterator with a thread pool.

    Train mode: infinite-epoch semantics are left to the caller; each
    ``__iter__`` yields one epoch of full batches (tail dropped when
    ``drop_last``, matching torch's default for Dassl train loaders).
    Eval mode: tail batch is padded to the static batch size and
    ``n_valid`` marks real rows.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = False,
                 multitask: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.multitask = multitask
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> list[int]:
        idxs = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idxs)
        return idxs

    def __iter__(self) -> Iterator[dict]:
        idxs = self._order()
        epoch_seed = (self.seed * 1000003 + self.epoch) if self.shuffle else None
        self.epoch += 1
        bs = self.batch_size

        import inspect

        supports_rng = False
        try:
            supports_rng = "rng" in inspect.signature(
                self.dataset.__getitem__).parameters
        except (TypeError, ValueError):
            pass

        def fetch(i):
            if epoch_seed is None or not supports_rng:
                return self.dataset[i]
            # deterministic per-(seed, epoch, index) augmentation draws,
            # independent of thread interleaving
            return self.dataset.__getitem__(
                i, rng=random.Random(epoch_seed * 1000003 + i))

        pool = cf.ThreadPoolExecutor(self.num_workers) if self.num_workers else None
        try:
            for start in range(0, len(idxs), bs):
                chunk = idxs[start : start + bs]
                if len(chunk) < bs and self.drop_last:
                    break
                if pool is not None:
                    rows = list(pool.map(fetch, chunk))
                else:
                    rows = [fetch(i) for i in chunk]
                n_valid = len(rows)
                while len(rows) < bs:  # pad eval tail to static shape
                    rows.append(rows[-1])
                imgs = np.stack([r[0] for r in rows])
                if imgs.dtype != np.uint8:
                    # uint8 = TPU.DEVICE_NORMALIZE staging (normalized on
                    # the device); everything else ships fp32
                    imgs = imgs.astype(np.float32)
                labels = np.asarray([r[1] for r in rows])
                batch = {"image": imgs, "label": labels, "n_valid": n_valid}
                if self.multitask:
                    batch["task"] = np.asarray([r[2] for r in rows], np.int32)
                yield batch
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)


def build_data_loader(cfg, data_source, batch_size, tfm, is_train: bool,
                      multitask: bool = False, label_transform=None):
    """Dassl build_data_loader equivalent (the reference's mvlpt.py:661-720).
    Train loaders shuffle and drop their tail batch, so every train batch
    has the same shape (the trainer's windows stack them)."""
    ds = _TransformedDataset(data_source, tfm, label_transform)
    return DataLoader(
        ds, batch_size=batch_size, shuffle=is_train,
        num_workers=cfg.DATALOADER.NUM_WORKERS, seed=max(cfg.SEED, 0),
        drop_last=is_train, multitask=multitask,
    )


def eval_mode(loader):
    """Switch a loader to a deterministic full pass (no shuffle, no
    augmentation, keep tail batches), for feature extraction over loaders
    built for training."""
    loader.shuffle = False
    loader.drop_last = False
    # Swap a training transform for its eval counterpart so the "no
    # augmentation" promise holds.
    ds = getattr(loader, "dataset", None)
    tfm = getattr(ds, "transform", None)
    from mvlpt_torch.data.transforms import EvalTransform, TrainTransform

    if isinstance(tfm, TrainTransform):
        ds.transform = EvalTransform(
            size=tfm.size, interpolation=tfm.interpolation, mean=tfm.mean,
            std=tfm.std, to_uint8=tfm.to_uint8)
    return loader
