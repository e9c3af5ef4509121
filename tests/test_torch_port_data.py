"""The port's data layer and evaluator against the JAX package's: the
train and eval transforms bit for bit, the DataLoader's batches (order,
padding, n_valid) over two epochs, the CoOp readers, the few-shot sampler
and the multitask manager on tmp datasets, macro-F1 against scikit-learn,
and the device-side normalisation's constants made once."""

import random

import numpy as np
import pytest
import torch
from PIL import Image

from mvlpt_tpu.config import get_cfg_default as j_defaults
from mvlpt_tpu.data import loader as jloader
from mvlpt_tpu.data import transforms as jT
from mvlpt_tpu.data.datum import DatasetBase as JBase
from mvlpt_tpu.data.datum import Datum as JDatum
from mvlpt_tpu.data.managers import build_data_manager as j_manager
from mvlpt_tpu.evaluation import ClassificationEvaluator as JEvaluator

from mvlpt_torch.config import get_cfg_default
from mvlpt_torch.data import loader as tloader
from mvlpt_torch.data import transforms as tT
from mvlpt_torch.data.datum import DatasetBase, Datum
from mvlpt_torch.data.managers import build_data_manager
from mvlpt_torch.evaluation import ClassificationEvaluator, macro_f1
from tests.util_fixtures import make_coop_dataset


def _image(seed: int, w: int, h: int, mode="RGB") -> Image.Image:
    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img = Image.fromarray(arr)
    return img.convert(mode) if mode != "RGB" else img


SIZES = [(256, 256), (300, 200), (97, 311), (224, 224), (40, 30), (640, 480)]


@pytest.mark.parametrize("wh", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
@pytest.mark.parametrize("to_uint8", [False, True], ids=["float", "uint8"])
def test_transforms_bit_equal(wh, to_uint8):
    """Eval (resize shorter side + center crop, and the ELEVATER warp) and
    train (random resized crop + flip) at several sizes and seeds."""
    kw = dict(size=224, interpolation="bicubic", to_uint8=to_uint8)
    for seed in range(4):
        img = _image(seed, *wh)
        for cc in (True, False):
            got = tT.EvalTransform(center_crop_mode=cc, **kw)(img)
            want = jT.EvalTransform(center_crop_mode=cc, **kw)(img)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        got = tT.TrainTransform(**kw)(img, rng=random.Random(seed))
        want = jT.TrainTransform(**kw)(img, rng=random.Random(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    grey = _image(9, *wh, mode="L")
    assert np.array_equal(tT.TrainTransform(**kw)(grey, rng=random.Random(1)),
                          jT.TrainTransform(**kw)(grey, rng=random.Random(1)))


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_build_transform_matches(interp):
    for make, mod in ((get_cfg_default, tT), (j_defaults, jT)):
        cfg = make()
        cfg.INPUT.INTERPOLATION = interp
        cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip", "normalize")
        cfg.INPUT.SIZE = (64, 64)
        cfg.TPU.DEVICE_NORMALIZE = True
        tr, ev = mod.build_transform(cfg, True), mod.build_transform(cfg, False)
        if mod is tT:
            t_tr, t_ev = tr, ev
        else:
            j_tr, j_ev = tr, ev
    img = _image(3, 150, 90)
    assert np.array_equal(t_tr(img, rng=random.Random(2)), j_tr(img, rng=random.Random(2)))
    assert np.array_equal(t_ev(img), j_ev(img))
    assert type(t_tr).__name__ == "TrainTransform" and t_ev.to_uint8


def _items(tmp_path, n: int, classes: int):
    items = []
    for i in range(n):
        path = tmp_path / f"img_{i}.png"
        _image(100 + i, 40 + (i % 3) * 7, 36 + (i % 5) * 3).save(path)
        items.append((str(path), i % classes, i % 2))
    return items


@pytest.mark.parametrize("workers", [0, 3])
def test_loader_batches_bit_equal_over_two_epochs(tmp_path, workers):
    """Train (shuffled, augmented, tail dropped) and eval (in order, tail
    padded, n_valid) loaders of both packages on the same files."""
    items = _items(tmp_path, 23, 5)
    t_items = [Datum(p, y, domain=d) for p, y, d in items]
    j_items = [JDatum(p, y, domain=d) for p, y, d in items]
    for is_train, bs in ((True, 4), (False, 6)):
        kw = dict(size=32, to_uint8=not is_train)
        t_tfm = (tT.TrainTransform if is_train else tT.EvalTransform)(**kw)
        j_tfm = (jT.TrainTransform if is_train else jT.EvalTransform)(**kw)
        t = tloader.DataLoader(tloader._TransformedDataset(t_items, t_tfm), bs, shuffle=is_train,
                               num_workers=workers, seed=7, drop_last=is_train, multitask=True)
        j = jloader.DataLoader(jloader._TransformedDataset(j_items, j_tfm), bs, shuffle=is_train,
                               num_workers=workers, seed=7, drop_last=is_train, multitask=True)
        assert len(t) == len(j)
        for _ in range(2):
            tb, jb = list(t), list(j)
            assert len(tb) == len(jb) == len(t)
            for a, b in zip(tb, jb):
                assert a.keys() == b.keys()
                for k in a:
                    assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
                    assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        if not is_train:
            assert tb[-1]["n_valid"] == 23 - bs * (len(tb) - 1)


def test_eval_mode_matches(tmp_path):
    items = _items(tmp_path, 7, 3)
    t = tloader.DataLoader(tloader._TransformedDataset(
        [Datum(p, y) for p, y, _ in items], tT.TrainTransform(size=32)), 3, shuffle=True,
        num_workers=0, seed=1, drop_last=True)
    j = jloader.DataLoader(jloader._TransformedDataset(
        [JDatum(p, y) for p, y, _ in items], jT.TrainTransform(size=32)), 3, shuffle=True,
        num_workers=0, seed=1, drop_last=True)
    for a, b in zip(tloader.eval_mode(t), jloader.eval_mode(j)):
        assert np.array_equal(a["image"], b["image"]) and a["n_valid"] == b["n_valid"]
    assert len(t) == 3


def _datum_tuples(items):
    return [(d.impath, d.label, d.classname, d.domain) for d in items]


def test_datum_helpers_match(tmp_path):
    rng = random.Random(0)
    t_items = [Datum(f"/x/{i}.jpg", rng.randrange(6), f"c{i % 6}") for i in range(60)]
    j_items = [JDatum(d.impath, d.label, d.classname) for d in t_items]
    for shots, repeat in ((1, False), (4, False), (30, True), (30, False), (-1, False)):
        got = DatasetBase.generate_fewshot_dataset(t_items, shots, seed=3, repeat=repeat)
        want = JBase.generate_fewshot_dataset(j_items, shots, seed=3, repeat=repeat)
        assert _datum_tuples(got) == _datum_tuples(want)
    t_trval = [Datum(d.impath, d.label, d.classname) for d in t_items]
    got = DatasetBase.split_trainval(t_trval, p_val=0.25, seed=2)
    want = JBase.split_trainval(j_items, p_val=0.25, seed=2)
    assert [_datum_tuples(g) for g in got] == [_datum_tuples(w) for w in want]
    for sub in ("all", "base", "new"):
        got = DatasetBase.subsample_classes(t_items, t_items[:10], subsample=sub)
        want = JBase.subsample_classes(j_items, j_items[:10], subsample=sub)
        assert [_datum_tuples(g) for g in got] == [_datum_tuples(w) for w in want]
    path = str(tmp_path / "split.json")
    JBase.save_split(j_items[:10], j_items[10:20], j_items[20:], path, "/x")
    got = DatasetBase.read_split(path, "/y")
    want = JBase.read_split(path, "/y")
    assert [_datum_tuples(g) for g in got] == [_datum_tuples(w) for w in want]


def test_fewshot_cache_reads_the_other_packages_pickle(tmp_path):
    """The few-shot cache the JAX package wrote is read back as the same
    items (the same file names, split_fewshot/shot_N-seed_S.pkl)."""
    items = [JDatum(f"/x/{i}.jpg", i % 3, f"c{i % 3}") for i in range(12)]
    want = JBase.load_fewshot_cached(str(tmp_path), 2, 1, lambda: (items[:6], items[6:]))
    got = DatasetBase.load_fewshot_cached(str(tmp_path), 2, 1,
                                          lambda: pytest.fail("the cache was not read"))
    assert [_datum_tuples(g) for g in got] == [_datum_tuples(w) for w in want]


def _cfgs(root, dataset: str, shots: int, multitask: bool):
    out = []
    for make in (get_cfg_default, j_defaults):
        cfg = make()
        cfg.DATASET.ROOT = str(root)
        cfg.DATASET.DATASET = dataset
        cfg.DATASET.NAME = dataset
        cfg.DATASET.COOP = True
        cfg.DATASET.MULTITASK = multitask
        cfg.DATASET.NUM_SHOTS = shots
        cfg.SEED = 1
        cfg.INPUT.SIZE = (32, 32)
        cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip", "normalize")
        cfg.DATALOADER.NUM_WORKERS = 0
        cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 3
        cfg.DATALOADER.TEST.BATCH_SIZE = 5
        out.append(cfg)
    return out


@pytest.mark.parametrize("dataset,shots,multitask", [
    ("OxfordPets", 2, False), ("OxfordPets", -1, False), ("OxfordPets,Caltech101", 3, True)])
def test_coop_readers_and_manager_match(tmp_path, dataset, shots, multitask):
    make_coop_dataset(tmp_path / "data")
    make_coop_dataset(tmp_path / "data", "caltech-101", ("face", "leopard", "bonsai"),
                      split_name="split_zhou_Caltech101.json",
                      image_subdir="101_ObjectCategories")
    t_cfg, j_cfg = _cfgs(tmp_path / "data", dataset, shots, multitask)
    tm = build_data_manager(t_cfg)
    jm = j_manager(j_cfg)
    assert tm.num_classes == jm.num_classes
    assert tm.classnames == jm.classnames and tm.lab2cname == jm.lab2cname
    assert tm._task_class_idx == jm._task_class_idx and tm._id2task == jm._id2task
    for name in ("train_loader_x", "val_loader", "test_loader"):
        tl, jl = getattr(tm, name), getattr(jm, name)
        assert (tl is None) == (jl is None)
        if tl is None:
            continue
        assert _datum_tuples(tl.dataset.items) == _datum_tuples(jl.dataset.items)
        for a, b in zip(tl, jl):
            for k in b:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (name, k)


def test_elevater_managers_raise(tmp_path):
    """The ELEVATER managers raise where a task has no manifest or
    ImageFolder, and on a data backend other than "python" (ROADMAP.md
    Queue 1, item 9)."""
    from tests.torch_port_util import write_elevater_task

    cfg = get_cfg_default()
    cfg.DATASET.ROOT = str(tmp_path)
    cfg.DATASET.DATASET = "cifar-10"
    with pytest.raises(FileNotFoundError, match="cifar-10"):
        build_data_manager(cfg)
    cfg.DATASET.MULTITASK = True
    with pytest.raises(FileNotFoundError, match="cifar-10"):
        build_data_manager(cfg)
    write_elevater_task(tmp_path, "cifar-10", 10, seed=0)
    cfg.DATALOADER.BACKEND = "native"
    for multitask in (True, False):
        cfg.DATASET.MULTITASK = multitask
        with pytest.raises(NotImplementedError, match="Queue 1, item 9"):
            build_data_manager(cfg)


@pytest.mark.parametrize("n,k,seed", [(50, 5, 0), (7, 20, 1), (300, 3, 2), (1, 1, 3),
                                      (40, 40, 4)])
def test_macro_f1_matches_sklearn(n, k, seed):
    from sklearn.metrics import f1_score

    rng = np.random.RandomState(seed)
    t, p = rng.randint(0, k, n), rng.randint(0, k, n)
    p[: n // 2] = t[: n // 2]
    want = f1_score(t, p, average="macro", zero_division=0)
    assert macro_f1(t, p) == pytest.approx(want, rel=1e-12, abs=1e-15)


def test_evaluator_matches_jax():
    rng = np.random.RandomState(0)
    t, j = ClassificationEvaluator(per_class=True), JEvaluator(per_class=True)
    for _ in range(3):
        logits = rng.randn(17, 6).astype(np.float32)
        labels = rng.randint(0, 6, 17)
        t.process(logits, labels)
        j.process(logits, labels)
    got, want = t.evaluate(), j.evaluate()
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    onehot = np.eye(6)[labels]
    a, b = t.clone(), j.clone()
    a.process(logits, onehot)
    b.process(logits, onehot)
    assert a.evaluate()["accuracy"] == b.evaluate()["accuracy"]


def test_device_normalize_constants_made_once():
    """The normalisation's constants are made once for each (values,
    device) and shared; the values are those of the JAX package."""
    from mvlpt_tpu.data.transforms import device_normalize as j_norm

    u8 = np.random.RandomState(0).randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    mean, std = list(tT.CLIP_PIXEL_MEAN), list(tT.CLIP_PIXEL_STD)
    first = tT.device_normalize(torch.from_numpy(u8), mean, std)
    again = tT.device_normalize(torch.from_numpy(u8), tuple(mean), tuple(std))
    assert torch.equal(first, again)
    np.testing.assert_array_equal(first.numpy(), np.asarray(j_norm(u8, mean, std)))
    c1 = tT.device_constant(tuple(mean), torch.device("cpu"), 255.0)
    c2 = tT.device_constant(tuple(mean), torch.device("cpu"), 255.0)
    assert c1 is c2
