"""The port's ELEVATER data layer (``mvlpt_torch.data.elevater``, the
ELEVATER managers of ``mvlpt_torch.data.managers``) against the JAX
package's on tmp datasets: the metadata file byte for byte, the task
tables, manifests (manifest.json, ImageFolder by name and by number, own
classnames, an explicit val split), few-shot subsets and val splits item
for item over several seeds, the same errors, and the managers' loader
batches (images, k-hot labels, task ids) bit for bit."""

import filecmp
from pathlib import Path

import numpy as np
import pytest

from mvlpt_tpu.config import get_cfg_default as j_defaults
from mvlpt_tpu.data.elevater import manifest as jman
from mvlpt_tpu.data.managers import build_data_manager as j_manager

from mvlpt_torch.config import get_cfg_default
from mvlpt_torch.data.elevater import manifest as tman
from mvlpt_torch.data.managers import build_data_manager
from tests.torch_port_util import write_elevater_task
from tests.util_fixtures import _write_image

ROOT = Path(__file__).resolve().parent.parent


def test_metadata_is_a_byte_copy():
    assert filecmp.cmp(ROOT / "mvlpt_torch/data/elevater/metadata.json",
                       ROOT / "mvlpt_tpu/data/elevater/metadata.json", shallow=False)


def test_task_tables_match_jax():
    assert tman.ELEVATER_20_TASKS == jman.ELEVATER_20_TASKS
    assert tman.load_metadata() == jman.load_metadata()
    for task in jman.load_metadata():
        assert tman.class_map(task) == jman.class_map(task)
        assert tman.class_map_metric(task) == jman.class_map_metric(task)
        assert tman.template_map(task) == jman.template_map(task)
        assert ([tman.first_classname(c) for c in tman.class_map(task)]
                == [jman.first_classname(c) for c in jman.class_map(task)])
    with pytest.raises(KeyError, match="unknown ELEVATER task"):
        tman.class_map("no-such-task")


def _tuples(items) -> list:
    return [(it.impath, tuple(it.labels), it.task_id) for it in items]


def _same_manifest(t, j):
    assert (t.task, t.dataset_type, t.num_classes, t.classnames) == (
        j.task, j.dataset_type, j.num_classes, j.classnames)
    for split in ("train", "test", "val"):
        assert _tuples(getattr(t, split)) == _tuples(getattr(j, split)), split


def _image_folder(root: Path, task: str, folders, per_class: int = 3,
                  splits=("train", "test")):
    seed = 0
    for split in splits:
        for label, folder in enumerate(folders):
            for i in range(per_class):
                _write_image(str(root / task / split / folder / f"{i}.jpg"), seed=seed,
                             class_signal=label)
                seed += 1


def _layouts(root: Path):
    """(task, load kwargs) of each layout under ``root``."""
    write_elevater_task(root, "cifar-10", 10, seed=1, n_train=4)
    write_elevater_task(root, "voc-2007-classification", 20, seed=2, n_train=3,
                        multilabel=True)
    write_elevater_task(root, "kitti-distance", 4, seed=3, n_train=5,
                        splits=("train", "val", "holdout"))
    write_elevater_task(root, "my-task", 3, seed=4, classnames=["x", "y", "z"])
    # ImageFolder named by class (sorted folder order differs from the
    # metadata's), and by class number; and a task outside metadata.json.
    names = list(tman.class_map("kitti-distance"))
    _image_folder(root / "by_name", "kitti-distance", list(reversed(names)))
    _image_folder(root / "by_number", "kitti-distance", ["3", "0", "2", "1"])
    _image_folder(root / "by_name", "custom-folders", ["b", "a"], splits=("train", "val"))
    return [
        (root, "cifar-10", {}),
        (root, "voc-2007-classification", {}),
        (root, "kitti-distance", dict(val_set="holdout")),
        (root, "kitti-distance", dict(test_set="holdout")),
        (root, "my-task", {}),
        (root / "by_name", "kitti-distance", {}),
        (root / "by_number", "kitti-distance", {}),
        (root / "by_name", "custom-folders", {}),
    ]


def test_manifests_subsets_and_splits_match_jax(tmp_path):
    """Each layout loads to the same manifest; the few-shot subset (1, 2
    and 3 shots, every shot, four seeds) and the 20% val split of each
    are the JAX package's item for item."""
    for root, task, kw in _layouts(tmp_path):
        t = tman.load_task_manifest(str(root), task, **kw)
        j = jman.load_task_manifest(str(root), task, **kw)
        _same_manifest(t, j)
        for shots in (1, 2, 3, -1):
            for seed in (0, 1, 2, 7):
                ts = tman.sample_few_shot_subset(t.train, shots, seed, t.num_classes)
                js = jman.sample_few_shot_subset(j.train, shots, seed, j.num_classes)
                assert _tuples(ts) == _tuples(js), (task, shots, seed)
                split = [tman.train_val_split(ts, 0.2, seed, t.num_classes, t.is_multilabel),
                         jman.train_val_split(js, 0.2, seed, j.num_classes, j.is_multilabel)]
                assert [_tuples(x) for x in split[0]] == [_tuples(x) for x in split[1]]


def test_multitask_manifest_matches_jax(tmp_path):
    _layouts(tmp_path)
    tasks = ["cifar-10", "voc-2007-classification", "my-task"]
    t = tman.load_multitask_manifest(str(tmp_path), tasks)
    j = jman.load_multitask_manifest(str(tmp_path), tasks)
    assert (t.task_names, t.class_offset, t.num_classes, t.task_class_idx()) == (
        j.task_names, j.class_offset, j.num_classes, j.task_class_idx())
    assert t.get_cid(3, "my-task") == j.get_cid(3, "my-task") == 33
    for task in tasks:
        _same_manifest(t.manifests[task], j.manifests[task])


@pytest.mark.parametrize("case", ["no-task", "no-val-split", "count-mismatch", "folder-count",
                                  "no-test-dir"])
def test_the_same_errors_as_jax(tmp_path, case):
    if case == "no-task":
        args, exc = ((str(tmp_path), "cifar-10"), {}), FileNotFoundError
    elif case == "no-val-split":
        write_elevater_task(tmp_path, "cifar-10", 10, seed=0)
        args, exc = ((str(tmp_path), "cifar-10"), dict(val_set="holdout")), FileNotFoundError
    elif case == "count-mismatch":
        write_elevater_task(tmp_path, "cifar-10", 3, seed=0)
        args, exc = ((str(tmp_path), "cifar-10"), {}), ValueError
    elif case == "folder-count":
        _image_folder(tmp_path, "mnist", ["0", "1"])
        args, exc = ((str(tmp_path), "mnist"), {}), ValueError
    else:
        _image_folder(tmp_path, "mnist", [str(i) for i in range(10)], per_class=1,
                      splits=("train",))
        args, exc = ((str(tmp_path), "mnist"), dict(test_set="holdout")), FileNotFoundError
    for module in (tman, jman):
        with pytest.raises(exc):
            module.load_task_manifest(*args[0], **args[1])
    if case == "count-mismatch":
        # flows that never read classnames get placeholders in both
        t = tman.load_task_manifest(str(tmp_path), "cifar-10", strict_classnames=False)
        j = jman.load_task_manifest(str(tmp_path), "cifar-10", strict_classnames=False)
        _same_manifest(t, j)


def _cfgs(root, dataset: str, shots: int, multitask: bool, opts=()):
    out = []
    for make in (get_cfg_default, j_defaults):
        cfg = make()
        cfg.merge_from_list(["DATASET.ROOT", str(root), "DATASET.DATASET", dataset,
                             "DATASET.NUM_SAMPLES_PER_CLASS", str(shots),
                             "DATASET.RANDOM_SEED_SAMPLING", "3", "SEED", "2",
                             "DATASET.MULTITASK", str(multitask), "INPUT.SIZE", "(24, 24)",
                             "DATALOADER.NUM_WORKERS", "0",
                             "DATALOADER.TRAIN_X.BATCH_SIZE", "3",
                             "DATALOADER.TEST.BATCH_SIZE", "4", *opts])
        out.append(cfg)
    return out


@pytest.mark.parametrize("dataset,shots,multitask,opts", [
    ("cifar-10", 2, False, ()),
    ("voc-2007-classification", 2, False, ("TPU.DEVICE_NORMALIZE", "True")),
    ("cifar-10", 1, False, ("DATASET.CENTER_CROP", "True")),
    ("kitti-distance", 3, False, ("DATASET.VAL_SET", "holdout")),
    ("cifar-10,voc-2007-classification,my-task", 2, True, ("TPU.DEVICE_NORMALIZE", "True")),
    ("cifar-10,kitti-distance", 1, True, ()),
], ids=["multiclass", "multilabel-uint8", "1-shot-crop", "val-set", "multitask", "multitask-1-shot"])
def test_elevater_managers_match_jax(tmp_path, dataset, shots, multitask, opts):
    """Two epochs of each loader: the same batches bit for bit (images,
    int or k-hot labels, task ids, n_valid), and the same metric
    tables, class names and ranges."""
    _layouts(tmp_path)
    t_cfg, j_cfg = _cfgs(tmp_path, dataset, shots, multitask, opts)
    tm, jm = build_data_manager(t_cfg), j_manager(j_cfg)
    assert tm.num_classes == jm.num_classes
    assert tm.classnames == jm.classnames and tm.lab2cname == jm.lab2cname
    assert tm._metric_name == jm._metric_name
    if multitask:
        assert tm._task_class_idx == jm._task_class_idx and tm._id2task == jm._id2task
        assert tm._task_names == jm._task_names and tm._labelmap == jm._labelmap
    for name in ("train_loader_x", "val_loader", "test_loader"):
        tl, jl = getattr(tm, name), getattr(jm, name)
        assert (tl is None) == (jl is None)
        if tl is None:
            continue
        assert _tuples(tl.dataset.items) == _tuples(jl.dataset.items), name
        assert len(tl) == len(jl)
        for _ in range(2):
            n = 0
            for a, b in zip(tl, jl):
                assert a.keys() == b.keys()
                for k in b:
                    x, y = np.asarray(a[k]), np.asarray(b[k])
                    assert x.dtype == y.dtype and np.array_equal(x, y), (name, k)
                n += 1
            assert n == len(jl)


def test_metric_overrides_and_defaults(tmp_path, capsys):
    """DATASET.METRIC_OVERRIDES and a task outside metadata.json pick
    the same metric in both packages; a malformed entry raises."""
    _layouts(tmp_path)
    opts = ("DATASET.METRIC_OVERRIDES", "('cifar-10=macro_f1',)")
    t_cfg, j_cfg = _cfgs(tmp_path, "cifar-10,my-task", 2, True, opts)
    tm, jm = build_data_manager(t_cfg), j_manager(j_cfg)
    assert tm._metric_name == jm._metric_name == {"cifar-10": "macro_f1",
                                                    "my-task": "accuracy"}
    t_cfg, _ = _cfgs(tmp_path, "cifar-10", 2, False, ("DATASET.METRIC_OVERRIDES", "('x',)"))
    with pytest.raises(ValueError, match="task=metric"):
        build_data_manager(t_cfg)
