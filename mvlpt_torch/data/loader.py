"""Host input pipeline: threaded decode/transform workers feeding
fixed-shape numpy batches, and their staging on the device.

The counterpart of ``mvlpt_tpu/data/loader.py`` (the reference's torch
DataLoader + Dassl DatasetWrapper, mvlpt.py:661-720): seeded shuffling,
worker threads for JPEG decode and PIL transforms (PIL and the native
core release the GIL for the heavy ops), static batch shapes (train
loaders drop the tail, eval loaders pad the tail batch and report the
pad so metrics can mask it). Batches are numpy. ``DeviceStager`` and
``prefetch_to_device`` put them on the device: pinned host buffers from
a ring, copied without blocking on a side stream, PyTorch's form of the
JAX package's asynchronous ``jax.device_put``. The JAX package's
multi-host row sharding is not ported (ROADMAP.md Queue 1, item 8).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import random
import time
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
from PIL import Image

from mvlpt_torch.data.datum import Datum
from mvlpt_torch.utils.device import resolve_device


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
        if getattr(self.transform, "wants_bytes", False):
            # native backend: raw encoded bytes to the C core
            from mvlpt_torch.data.zipio import read_bytes

            img = read_bytes(d.impath)
        else:
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
    built for training. A training transform, ``NativeTrainTransform``
    too, becomes a plain (PIL) ``EvalTransform``, as in the JAX package:
    a train split extracted this way decodes through PIL whatever
    DATALOADER.BACKEND says."""
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


class _Staged:
    """One batch on its way to the device: the device tensors, the event
    its copies recorded on the side stream (None on the CPU), and the
    values that stay on the host."""

    __slots__ = ("tensors", "event", "host")

    def __init__(self, tensors: dict, event, host: dict):
        self.tensors, self.event, self.host = tensors, event, host


class DeviceStager:
    """Stages host batches on ``device`` (the card unless the caller asks
    for the CPU).

    On the card each array is copied into a pinned host buffer, then to
    a new device tensor with ``non_blocking=True`` on a side stream,
    which records an event. ``ready`` makes the consuming (current)
    stream wait on that event before first use and records the tensors
    on it (``Tensor.record_stream``), so the caching allocator cannot
    hand their memory back while the consumer's work is queued. The
    pinned buffers come from a ring of ``depth`` a (shape, dtype); a
    buffer is reused only after the event of the copy that last read it
    has completed (``cudaHostAlloc`` costs milliseconds, so a buffer is
    never allocated a batch). ``host_s`` adds up the host's time in
    ``stage``: the copies into pinned memory and the waits for a
    buffer. On the CPU the arrays become tensors with the same values.

    Numpy arrays and tensors are staged, each keeping its dtype; any
    other value (``n_valid``, Python numbers) stays on the host."""

    def __init__(self, device=None, depth: int = 3):
        self.device = resolve_device(device)
        self.depth = max(1, int(depth))
        self.stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                       else None)
        self._ring: dict[tuple, collections.deque] = {}
        self.host_s = 0.0

    def _pinned(self, arr: np.ndarray, taken: list) -> tuple[torch.Tensor, list]:
        """A pinned buffer holding ``arr`` and the slot of its ring entry,
        whose event the caller sets after the copy it enqueues; never one
        of ``taken``, the slots of the batch being staged."""
        ring = self._ring.setdefault((arr.shape, arr.dtype.str), collections.deque())
        if len(ring) >= self.depth and not any(ring[0] is s for s in taken):
            slot = ring.popleft()
            if slot[1] is not None:
                slot[1].synchronize()  # the copy that last read it is done
        else:
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            slot = [torch.empty(arr.shape, dtype=dtype, pin_memory=True), None]
        ring.append(slot)
        taken.append(slot)
        np.copyto(slot[0].numpy(), arr, casting="no")
        return slot[0], slot

    def stage(self, batch: dict) -> _Staged:
        """Enqueue ``batch``'s copies; ``ready`` hands it to the consumer."""
        arrays = {k: v for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}
        host = {k: v for k, v in batch.items() if k not in arrays}
        if self.stream is None:
            return _Staged({k: torch.as_tensor(v).to(self.device) for k, v in arrays.items()},
                           None, host)
        t0 = time.perf_counter()
        pinned, taken = {}, []
        for k, v in arrays.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            pinned[k] = self._pinned(np.ascontiguousarray(v), taken)
        self.host_s += time.perf_counter() - t0
        out = {}
        with torch.cuda.stream(self.stream):
            for k, (buf, _) in pinned.items():
                out[k] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        for _, slot in pinned.values():
            slot[1] = event
        return _Staged(out, event, host)

    def ready(self, staged: _Staged) -> dict:
        """The staged batch, safe to use on the current stream."""
        if staged.event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(staged.event)
            for t in staged.tensors.values():
                t.record_stream(consumer)
        return {**staged.tensors, **staged.host}

    def __call__(self, batch: dict) -> dict:
        """``batch`` on the device, for use on the current stream now."""
        return self.ready(self.stage(batch))


def prefetch_to_device(iterator, size: int = 2, device=None, sharding=None,
                       stager: DeviceStager | None = None):
    """Keep ``size`` batches of ``iterator`` staged ahead on ``device``
    (the card unless the caller asks for the CPU) and yield them in order,
    the counterpart of ``mvlpt_tpu/data/loader.py:prefetch_to_device``.
    ``n_valid`` stays a host int; every array keeps its dtype (uint8
    images stay uint8 under TPU.DEVICE_NORMALIZE). ``stager`` (a
    ``DeviceStager`` on ``device``) keeps its pinned ring across calls;
    by default each call makes its own. A ``sharding`` raises: the port
    runs on one device (ROADMAP.md Queue 1, item 8)."""
    if sharding is not None:
        raise NotImplementedError("prefetch_to_device with a sharding is not ported yet: the "
                                  "port stages on one device (ROADMAP.md Queue 1, item 8)")
    stager = stager or DeviceStager(device, depth=size + 1)
    queue = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(stager.stage(batch))
        if len(queue) >= size:
            break
    while queue:
        out = queue.popleft()
        try:
            queue.append(stager.stage(next(it)))
        except StopIteration:
            pass
        yield stager.ready(out)
