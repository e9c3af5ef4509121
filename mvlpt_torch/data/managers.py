"""Data managers: the multitask machinery (SURVEY.md §2.4, the MVLPT
core contribution).

The counterpart of ``mvlpt_tpu/data/managers.py`` for the CoOp universe:
``CoopMultitaskDataManager`` rebuilds MVLPTCOOPDataManager (the
reference's mvlpt.py:585-735): per-task CoOp dataset build, label
offsetting by running class count, task-id stamping, split
concatenation, and ``task_class_idx`` ranges. The ELEVATER managers are
not ported yet (ROADMAP.md Queue 1, item 11).
"""

from __future__ import annotations

from mvlpt_torch.data import transforms as T
from mvlpt_torch.data.coop import datasets as coop_datasets  # noqa: F401  (registers loaders)
from mvlpt_torch.data.loader import build_data_loader
from mvlpt_torch.utils.registry import DATASET_REGISTRY

_ELEVATER = ("ELEVATER datasets (ElevaterDataManager, ElevaterMultitaskDataManager) are not "
             "ported yet (ROADMAP.md Queue 1, item 11); pass --dataset-coop for a CoOp dataset")


class CoopMultitaskDataManager:
    """Concatenate CoOp datasets with offset labels and task domains."""

    def __init__(self, cfg):
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
                                     is_train=is_train, multitask=multitask)

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


class ElevaterDataManager:
    """Single ELEVATER task: not ported yet."""

    def __init__(self, cfg, strict_classnames: bool = True):
        raise NotImplementedError(_ELEVATER)


class ElevaterMultitaskDataManager:
    """Merged ELEVATER tasks: not ported yet."""

    def __init__(self, cfg):
        raise NotImplementedError(_ELEVATER)


def build_data_manager(cfg, strict_classnames: bool = True):
    """Universe dispatch (the reference's mvlpt.py:892-897): DATASET.COOP
    -> CoopMultitaskDataManager, else MULTITASK -> ElevaterMultitask,
    else a single ELEVATER task."""
    if cfg.DATASET.COOP:
        return CoopMultitaskDataManager(cfg)
    if cfg.DATASET.MULTITASK:
        return ElevaterMultitaskDataManager(cfg)
    return ElevaterDataManager(cfg, strict_classnames=strict_classnames)
