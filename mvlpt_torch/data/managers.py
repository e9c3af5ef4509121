"""Data managers: the multitask machinery (SURVEY.md §2.4, the MVLPT
core contribution).

The counterpart of ``mvlpt_tpu/data/managers.py``:

  * CoopMultitaskDataManager rebuilds MVLPTCOOPDataManager (the
    reference's mvlpt.py:585-735): per-task CoOp dataset build, label
    offsetting by running class count, task-id stamping, split
    concatenation, and ``task_class_idx`` ranges.
  * ElevaterDataManager rebuilds MVLPTDataManager (mvlpt.py:740-770)
    over the local manifests of ``data.elevater`` (construct_dataloader,
    feature.py:538-619).
  * ElevaterMultitaskDataManager rebuilds MVLPTMTDataManager
    (mvlpt.py:772-825) and construct_multitask_dataset
    (feature.py:782-862): merged manifests, global contiguous class ids,
    k-hot targets over the global class space, a task id on every item.

DATALOADER.BACKEND "python" and "native" run; "tf" raises (ROADMAP.md
Queue 1: data/tfdata.py is not ported).
"""

from __future__ import annotations

import numpy as np

from mvlpt_torch.data import transforms as T
from mvlpt_torch.data.coop import datasets as coop_datasets  # noqa: F401  (registers loaders)
from mvlpt_torch.data.elevater import manifest as ev
from mvlpt_torch.data.loader import DataLoader, _load_image, build_data_loader, train_shard
from mvlpt_torch.data.zipio import read_bytes
from mvlpt_torch.evaluation.metrics import get_metric
from mvlpt_torch.utils.registry import DATASET_REGISTRY


class CoopMultitaskDataManager:
    """Concatenate CoOp datasets with offset labels and task domains."""

    def __init__(self, cfg, mesh=None):
        # --dataset sets DATASET.DATASET; a bare --dataset-config-file
        # (the CoOp/CoCoOp protocol scripts, Dassl style) sets only
        # DATASET.NAME: accept either.
        self._task_names = (cfg.DATASET.DATASET or cfg.DATASET.NAME).split(",")
        self._id2task = dict(enumerate(self._task_names))
        self._task_class_idx: dict[str, tuple[int, int]] = {}

        label_offset = 0
        train_x, val, test = [], [], []
        classnames: list[str] = []
        lab2cname: dict[int, str] = {}
        for domain, name in enumerate(self._task_names):
            sub = cfg.clone()
            sub.defrost()
            sub.DATASET.NAME = name
            dataset = DATASET_REGISTRY.get(name)(sub)
            # offset each Datum object once: some loaders alias splits
            # (ImageNet val=test, the test-only variants train=test), so
            # per-group offsetting would shift shared items twice
            seen_ids = set()
            for group, acc in ((dataset.train_x, train_x), (dataset.val, val),
                               (dataset.test, test)):
                for d in group:
                    if id(d) not in seen_ids:
                        d.label += label_offset
                        d.domain = domain
                        seen_ids.add(id(d))
                acc.extend(group)
            classnames.extend(dataset.classnames)
            lab2cname.update({k + label_offset: v for k, v in dataset.lab2cname.items()})
            self._task_class_idx[name] = (label_offset, label_offset + dataset.num_classes)
            label_offset += dataset.num_classes

        self._num_classes = label_offset
        self._classnames = classnames
        self._lab2cname = lab2cname

        multitask = cfg.DATASET.MULTITASK
        tfm_train = T.build_transform(cfg, is_train=True)
        tfm_test = T.build_transform(cfg, is_train=False)

        def mk(items, bs, is_train):
            return build_data_loader(cfg, items, bs, tfm_train if is_train else tfm_test,
                                     is_train=is_train, multitask=multitask, mesh=mesh)

        self.train_loader_x = mk(train_x, cfg.DATALOADER.TRAIN_X.BATCH_SIZE, True)
        self.val_loader = mk(val, cfg.DATALOADER.TEST.BATCH_SIZE, False) if val else None
        self.test_loader = mk(test, cfg.DATALOADER.TEST.BATCH_SIZE, False)
        self.train_loader_u = None

    # Dassl-compatible property surface (the reference's mvlpt.py:722-735)
    @property
    def num_classes(self):
        return self._num_classes

    @property
    def lab2cname(self):
        return self._lab2cname

    @property
    def classnames(self):
        return self._classnames


class _ElevaterDataset:
    """items -> (image, target, task_id) rows for DataLoader."""

    def __init__(self, items, transform, target_fn):
        self.items = items
        self.transform = transform
        self.target_fn = target_fn

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        it = self.items[idx]
        if getattr(self.transform, "wants_bytes", False):
            # native backend: raw encoded bytes to the C core
            img = self.transform(read_bytes(it.impath))
        else:
            img = self.transform(_load_image(it.impath))
        return img, self.target_fn(it), it.task_id


def _elevater_transform(cfg):
    """ELEVATER preprocessing: Resize+CenterCrop when DATASET.CENTER_CROP
    else a plain warp; no train-time augmentation (feature.py:539-553).
    On DATALOADER.BACKEND "native" the C++ core runs it."""
    size = cfg.INPUT.SIZE if not isinstance(cfg.INPUT.SIZE, int) else (
        cfg.INPUT.SIZE, cfg.INPUT.SIZE)
    _, eval_cls = T._transform_classes(cfg)
    kw = {}
    if cfg.DATALOADER.BACKEND == "native":
        kw["fast_jpeg"] = bool(cfg.DATALOADER.NATIVE_FAST_JPEG)
    return eval_cls(
        size=tuple(size), interpolation="bicubic",
        mean=tuple(cfg.INPUT.PIXEL_MEAN), std=tuple(cfg.INPUT.PIXEL_STD),
        center_crop_mode=bool(cfg.DATASET.CENTER_CROP),
        to_uint8=bool(cfg.TPU.DEVICE_NORMALIZE), **kw)


def _make_loader(cfg, items, transform, target_fn, batch_size, shuffle, multitask, mesh=None):
    """The threaded loader over ELEVATER items: train loaders shuffle and
    drop their tail batch (and decode this rank's rows under ``mesh``,
    ``loader.train_shard``), eval loaders pad it."""
    ds = _ElevaterDataset(items, transform, target_fn)
    return DataLoader(
        ds, batch_size=batch_size, shuffle=shuffle,
        num_workers=cfg.DATALOADER.NUM_WORKERS,
        seed=max(cfg.SEED, 0), drop_last=shuffle, multitask=multitask,
        host_shard=train_shard(batch_size, shuffle, mesh))


_METRIC_DEFAULT_NOTED: set[str] = set()


def _metric_name_for(task: str, overrides: dict) -> str:
    """Metric for a task: override > metadata.json > 'accuracy'.

    Custom tasks (self-describing manifests) have no metadata.json
    metric row; a bare lookup would KeyError even for flows that never
    consult the metric (feature extraction). Default to accuracy with a
    note — eval flows can pick one with DATASET.METRIC_OVERRIDES. The
    note prints once per task, not on every manager construction
    (train/eval/extract each build one)."""
    metric = overrides.get(task)
    if metric is not None:
        return metric
    try:
        return ev.class_map_metric(task)
    except KeyError:
        if task not in _METRIC_DEFAULT_NOTED:
            _METRIC_DEFAULT_NOTED.add(task)
            print(f"[data] task {task!r} not in metadata.json: metric "
                  f"defaults to 'accuracy' (override with "
                  f"DATASET.METRIC_OVERRIDES '{task}=<metric>')")
        return "accuracy"


def _metric_overrides(cfg) -> dict:
    """Parse DATASET.METRIC_OVERRIDES ("task=metric" entries)."""
    out = {}
    for entry in cfg.DATASET.METRIC_OVERRIDES:
        task, _, metric = str(entry).partition("=")
        if not metric:
            raise ValueError(
                f"DATASET.METRIC_OVERRIDES entry {entry!r} is not "
                "'task=metric'")
        out[task] = metric
    return out


class ElevaterDataManager:
    """Single ELEVATER task (mvlpt.py:740-770 + feature.py:538-619)."""

    def __init__(self, cfg, strict_classnames: bool = True, mesh=None):
        task = cfg.DATASET.DATASET
        root = cfg.DATASET.ROOT
        man = ev.load_task_manifest(
            root, task, train_set=cfg.DATASET.TRAIN_SET,
            val_set=cfg.DATASET.VAL_SET, test_set=cfg.DATASET.TEST_SET,
            strict_classnames=strict_classnames)
        overrides = _metric_overrides(cfg)
        self._metric_name = _metric_name_for(task, overrides)
        self._metric = get_metric(self._metric_name)
        # classnames resolved by the manifest loader (manifest-declared >
        # metadata > placeholders) so counts always agree with targets
        names = man.classnames
        self._num_classes = man.num_classes
        self._lab2cname = {i: ev.first_classname(c) for i, c in enumerate(names)}

        shots = cfg.DATASET.NUM_SAMPLES_PER_CLASS
        seed = cfg.DATASET.RANDOM_SEED_SAMPLING
        train_items = ev.sample_few_shot_subset(
            man.train, shots, seed, man.num_classes)
        if man.val:
            # Explicit DATASET.VAL_SET: train is used whole
            # (feature.py:611-613).
            val_items = man.val
        elif shots == 1:
            # 1-shot: no split — val IS the train set (feature.py:602-605),
            # else the 20% split would empty the training set.
            val_items = list(train_items)
        else:
            train_items, val_items = ev.train_val_split(
                train_items, 0.2, seed, man.num_classes, man.is_multilabel)

        if man.is_multilabel:
            def target_fn(it, n=man.num_classes):
                vec = np.zeros(n, np.float32)
                vec[list(it.labels)] = 1.0
                return vec
        else:
            def target_fn(it):
                return it.labels[0]

        tfm = _elevater_transform(cfg)
        bs_train = cfg.DATALOADER.TRAIN_X.BATCH_SIZE
        bs_test = cfg.DATALOADER.TEST.BATCH_SIZE
        self.train_loader_x = _make_loader(
            cfg, train_items, tfm, target_fn, bs_train, True, False, mesh)
        self.val_loader = _make_loader(
            cfg, val_items, tfm, target_fn, bs_test, False, False) if val_items else None
        self.test_loader = _make_loader(
            cfg, man.test, tfm, target_fn, bs_test, False, False)
        self.train_loader_u = None

    @property
    def num_classes(self):
        return self._num_classes

    @property
    def lab2cname(self):
        return self._lab2cname

    @property
    def classnames(self):
        return [self._lab2cname[i] for i in range(self._num_classes)]


class ElevaterMultitaskDataManager:
    """Merged ELEVATER tasks (mvlpt.py:772-825 + feature.py:782-862):
    targets are k-hot over the GLOBAL class space, every item carries its
    task id (MultiTaskTorchDataset semantics, feature.py:709-756)."""

    def __init__(self, cfg, mesh=None):
        tasks = cfg.DATASET.DATASET.split(",")
        root = cfg.DATASET.ROOT
        mt = ev.load_multitask_manifest(root, tasks)
        self._task_names = mt.task_names
        self._task2id = {t: i for i, t in enumerate(tasks)}
        self._id2task = dict(enumerate(tasks))
        overrides = _metric_overrides(cfg)
        self._metric_name = {
            t: _metric_name_for(t, overrides) for t in tasks}
        self._metric = {t: get_metric(self._metric_name[t]) for t in tasks}
        self._labelmap = {t: mt.manifests[t].classnames for t in tasks}
        self._task_class_idx = mt.task_class_idx()
        self._num_classes = mt.num_classes
        self._lab2cname = {}
        for t in tasks:
            for i, c in enumerate(mt.manifests[t].classnames):
                self._lab2cname[mt.get_cid(i, t)] = ev.first_classname(c)

        shots = cfg.DATASET.NUM_SAMPLES_PER_CLASS
        seed = cfg.DATASET.RANDOM_SEED_SAMPLING
        train_items, test_items = [], []
        for tid, t in enumerate(tasks):
            man = mt.manifests[t]
            off = mt.class_offset[t]
            for src, dst in ((man.train, train_items), (man.test, test_items)):
                for it in src:
                    dst.append(ev.ElevaterItem(
                        it.impath,
                        tuple(l + off for l in it.labels),
                        task_id=tid))
        # few-shot sample the MERGED manifest, then 80/20 split
        # (feature.py:843-852)
        train_items = ev.sample_few_shot_subset(
            train_items, shots, seed, mt.num_classes)
        if shots == 1:
            # the greedy class-cover split would consume the single item
            # of every class; mirror the single-task 1-shot rule
            # (feature.py:602-605): no split, val IS the train set
            val_items = list(train_items)
        else:
            train_items, val_items = ev.train_val_split(
                train_items, 0.2, seed, mt.num_classes, multilabel=True)

        n_global = mt.num_classes

        def target_fn(it):
            vec = np.zeros(n_global, np.float32)
            vec[list(it.labels)] = 1.0
            return vec

        tfm = _elevater_transform(cfg)
        bs_train = cfg.DATALOADER.TRAIN_X.BATCH_SIZE
        bs_test = cfg.DATALOADER.TEST.BATCH_SIZE
        self.train_loader_x = _make_loader(
            cfg, train_items, tfm, target_fn, bs_train, True, True, mesh)
        self.val_loader = _make_loader(
            cfg, val_items, tfm, target_fn, bs_test, False, True) if val_items else None
        self.test_loader = _make_loader(
            cfg, test_items, tfm, target_fn, bs_test, False, True)
        self.train_loader_u = None

    @property
    def num_classes(self):
        return self._num_classes

    @property
    def lab2cname(self):
        return self._lab2cname

    @property
    def classnames(self):
        return [self._lab2cname[i] for i in range(self._num_classes)]


def build_data_manager(cfg, strict_classnames: bool = True, mesh=None):
    """Universe dispatch (the reference's mvlpt.py:892-897): DATASET.COOP
    -> CoopMultitaskDataManager, else MULTITASK -> ElevaterMultitask,
    else a single ELEVATER task. ``strict_classnames=False`` relaxes the
    single-task manifest vs metadata class-count guard for flows that
    never read classnames (``manifest._resolve_classnames``). Under
    ``mesh`` (a ``parallel.Mesh``) the train loader decodes this rank's
    rows of each global batch."""
    if cfg.DATASET.COOP:
        return CoopMultitaskDataManager(cfg, mesh=mesh)
    if cfg.DATASET.MULTITASK:
        return ElevaterMultitaskDataManager(cfg, mesh=mesh)
    return ElevaterDataManager(cfg, strict_classnames=strict_classnames, mesh=mesh)
