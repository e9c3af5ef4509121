"""The CoOp-universe dataset loaders (the 16+ loaders of the
reference's datasets/, SURVEY.md §2.8).

The counterpart of ``mvlpt_tpu/data/coop/datasets.py``.

All datasets share one flow: load (or build+persist) a
``split_zhou_*.json`` split, seeded few-shot subsampling cached per
(shots, seed), base/new class subsetting. On-disk layouts and split/
cache file formats match the reference's exactly, so existing CoOp data
directories (DATASETS.md recipes) work unchanged.

Each class cites its reference counterpart; the shared machinery lives
in data/datum.py rather than being repeated per dataset.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict, defaultdict

from mvlpt_torch.data.datum import DatasetBase, Datum
from mvlpt_torch.utils.registry import DATASET_REGISTRY


def _standard_flow(cfg, dataset_dir, train, val, test, trainval_only=False):
    """few-shot cache + class subsample (oxford_pets.py:33-53)."""
    num_shots = cfg.DATASET.NUM_SHOTS
    if num_shots >= 1:
        fewshot_dir = os.path.join(dataset_dir, "split_fewshot")

        def build():
            t = DatasetBase.generate_fewshot_dataset(train, num_shots, seed=cfg.SEED)
            v = (val if trainval_only else
                 DatasetBase.generate_fewshot_dataset(val, min(num_shots, 4),
                                                      seed=cfg.SEED))
            return t, v

        train, val = DatasetBase.load_fewshot_cached(
            fewshot_dir, num_shots, cfg.SEED, build)
    subsample = cfg.DATASET.SUBSAMPLE_CLASSES
    train, val, test = DatasetBase.subsample_classes(
        train, val, test, subsample=subsample)
    return train, val, test


def read_and_split_image_folder(image_dir, p_trn=0.5, p_val=0.2,
                                ignored=(), new_cnames=None, seed=0):
    """Build a 50/20/30 split from an images/<class>/ tree
    (dtd.py read_and_split_data semantics)."""
    import random

    rng = random.Random(seed)
    categories = sorted(
        c for c in os.listdir(image_dir)
        if not c.startswith(".") and os.path.isdir(os.path.join(image_dir, c))
        and c not in ignored
    )
    train, val, test = [], [], []
    for label, category in enumerate(categories):
        cdir = os.path.join(image_dir, category)
        images = [os.path.join(cdir, f) for f in sorted(os.listdir(cdir))
                  if not f.startswith(".")]
        rng.shuffle(images)
        n_train = round(len(images) * p_trn)
        n_val = round(len(images) * p_val)
        cname = category
        if new_cnames and category in new_cnames:
            cname = new_cnames[category]
        for i, impath in enumerate(images):
            d = Datum(impath=impath, label=label, classname=cname)
            (train if i < n_train else
             val if i < n_train + n_val else test).append(d)
    return train, val, test


class _SplitJsonDataset(DatasetBase):
    """Shared base: split json (or one built from the raw files) + standard flow."""

    dataset_dir = ""
    split_filename = ""
    image_subdir = "images"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, self.image_subdir)
        split_path = os.path.join(self.dataset_dir, self.split_filename)
        if os.path.exists(split_path):
            train, val, test = self.read_split(split_path, self.image_dir)
        else:
            train, val, test = self.build_split(cfg)
            self.save_split(train, val, test, split_path, self.image_dir)
        train, val, test = _standard_flow(cfg, self.dataset_dir, train, val, test)
        super().__init__(train_x=train, val=val, test=test)

    def build_split(self, cfg):
        raise FileNotFoundError(
            f"{self.split_filename} not found and no split to build for "
            f"{type(self).__name__}")


@DATASET_REGISTRY.register()
class OxfordPets(_SplitJsonDataset):
    """datasets/oxford_pets.py:11-186"""

    dataset_dir = "oxford_pets"
    split_filename = "split_zhou_OxfordPets.json"

    def build_split(self, cfg):
        def read(split_file):
            items = []
            with open(os.path.join(self.dataset_dir, "annotations", split_file)) as f:
                for line in f:
                    imname, label, _species, _ = line.strip().split(" ")
                    breed = "_".join(imname.split("_")[:-1]).lower()
                    items.append(Datum(
                        impath=os.path.join(self.image_dir, imname + ".jpg"),
                        label=int(label) - 1, classname=breed))
            return items

        trainval = read("trainval.txt")
        test = read("test.txt")
        train, val = self.split_trainval(trainval)
        return train, val, test


@DATASET_REGISTRY.register()
class OxfordFlowers(_SplitJsonDataset):
    """datasets/oxford_flowers.py (imagelabels.mat + cat_to_name.json)"""

    dataset_dir = "oxford_flowers"
    split_filename = "split_zhou_OxfordFlowers.json"
    image_subdir = "jpg"

    def build_split(self, cfg):
        import json
        import random
        from scipy.io import loadmat

        labels = loadmat(os.path.join(self.dataset_dir, "imagelabels.mat"))["labels"][0]
        with open(os.path.join(self.dataset_dir, "cat_to_name.json")) as f:
            lab2cname = json.load(f)
        by_label = defaultdict(list)
        for i, label in enumerate(labels, start=1):
            by_label[int(label)].append(f"image_{str(i).zfill(5)}.jpg")
        train, val, test = [], [], []
        rng = random.Random(0)
        for label, imnames in sorted(by_label.items()):
            rng.shuffle(imnames)
            n_total = len(imnames)
            n_train = round(n_total * 0.5)
            n_val = round(n_total * 0.2)
            cname = lab2cname[str(label)]
            for i, imname in enumerate(imnames):
                d = Datum(impath=os.path.join(self.image_dir, imname),
                          label=label - 1, classname=cname)
                (train if i < n_train else
                 val if i < n_train + n_val else test).append(d)
        return train, val, test


@DATASET_REGISTRY.register()
class FGVCAircraft(DatasetBase):
    """datasets/fgvc_aircraft.py (variants.txt + images_variant_*.txt)"""

    dataset_dir = "fgvc_aircraft"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        with open(os.path.join(self.dataset_dir, "variants.txt")) as f:
            classnames = [l.strip() for l in f]
        cname2lab = {c: i for i, c in enumerate(classnames)}

        def read(split):
            items = []
            with open(os.path.join(self.dataset_dir,
                                   f"images_variant_{split}.txt")) as f:
                for line in f:
                    parts = line.strip().split(" ")
                    cname = " ".join(parts[1:])
                    items.append(Datum(
                        impath=os.path.join(self.image_dir, parts[0] + ".jpg"),
                        label=cname2lab[cname], classname=cname))
            return items

        train, val, test = read("train"), read("val"), read("test")
        train, val, test = _standard_flow(cfg, self.dataset_dir, train, val, test)
        super().__init__(train_x=train, val=val, test=test)


@DATASET_REGISTRY.register()
class DescribableTextures(_SplitJsonDataset):
    """datasets/dtd.py"""

    dataset_dir = "dtd"
    split_filename = "split_zhou_DescribableTextures.json"

    def build_split(self, cfg):
        return read_and_split_image_folder(self.image_dir)


EUROSAT_NEW_CNAMES = {
    "AnnualCrop": "Annual Crop Land",
    "Forest": "Forest",
    "HerbaceousVegetation": "Herbaceous Vegetation Land",
    "Highway": "Highway or Road",
    "Industrial": "Industrial Buildings",
    "Pasture": "Pasture Land",
    "PermanentCrop": "Permanent Crop Land",
    "Residential": "Residential Buildings",
    "River": "River",
    "SeaLake": "Sea or Lake",
}


@DATASET_REGISTRY.register()
class EuroSAT(_SplitJsonDataset):
    """datasets/eurosat.py (classname remap :10-21)"""

    dataset_dir = "eurosat"
    split_filename = "split_zhou_EuroSAT.json"
    image_subdir = "2750"

    def build_split(self, cfg):
        return read_and_split_image_folder(
            self.image_dir, new_cnames=EUROSAT_NEW_CNAMES)


@DATASET_REGISTRY.register()
class StanfordCars(_SplitJsonDataset):
    """datasets/stanford_cars.py (devkit .mat fallback; year-first names)"""

    dataset_dir = "stanford_cars"
    split_filename = "split_zhou_StanfordCars.json"
    image_subdir = ""

    def build_split(self, cfg):
        from scipy.io import loadmat

        meta = loadmat(os.path.join(self.dataset_dir, "devkit", "cars_meta.mat"))
        names = [str(x[0]) for x in meta["class_names"][0]]

        def classname(label):
            parts = names[label].split(" ")
            return " ".join([parts[-1]] + parts[:-1])  # year first

        def read(image_dir, anno_path):
            annos = loadmat(anno_path)["annotations"][0]
            return [
                Datum(
                    impath=os.path.join(self.dataset_dir, image_dir,
                                        str(a["fname"][0])),
                    label=int(a["class"][0, 0]) - 1,
                    classname=classname(int(a["class"][0, 0]) - 1))
                for a in annos
            ]

        trainval = read("cars_train",
                        os.path.join(self.dataset_dir, "devkit", "cars_train_annos.mat"))
        test = read("cars_test",
                    os.path.join(self.dataset_dir, "cars_test_annos_withlabels.mat"))
        train, val = self.split_trainval(trainval)
        return train, val, test


@DATASET_REGISTRY.register()
class Food101(_SplitJsonDataset):
    """datasets/food101.py"""

    dataset_dir = "food-101"
    split_filename = "split_zhou_Food101.json"

    def build_split(self, cfg):
        # food101.py:27-28 falls back to DTD.read_and_split_data when
        # the split json is absent
        return read_and_split_image_folder(self.image_dir)


@DATASET_REGISTRY.register()
class SUN397(_SplitJsonDataset):
    """datasets/sun397.py (nested class dirs, reversed word order)"""

    dataset_dir = "sun397"
    split_filename = "split_zhou_SUN397.json"
    image_subdir = "SUN397"

    def build_split(self, cfg):
        with open(os.path.join(self.image_dir, "ClassName.txt")) as f:
            classnames = [l.strip()[1:] for l in f]  # strip leading /
        cname2lab = {c: i for i, c in enumerate(classnames)}

        def read(text_file):
            items = []
            with open(os.path.join(self.image_dir, text_file)) as f:
                for line in f:
                    imname = line.strip()[1:]
                    cdir = os.path.dirname(imname)
                    names = cdir.split("/")[1:][::-1]
                    items.append(Datum(
                        impath=os.path.join(self.image_dir, imname),
                        label=cname2lab[cdir], classname=" ".join(names)))
            return items

        trainval = read("Training_01.txt")
        test = read("Testing_01.txt")
        train, val = self.split_trainval(trainval)
        return train, val, test


CALTECH_IGNORED = ["BACKGROUND_Google", "Faces_easy"]
CALTECH_NEW_CNAMES = {
    "airplanes": "airplane",
    "Faces": "face",
    "Leopards": "leopard",
    "Motorbikes": "motorbike",
}


@DATASET_REGISTRY.register()
class Caltech101(_SplitJsonDataset):
    """datasets/caltech101.py (IGNORED dirs :10-16)"""

    dataset_dir = "caltech-101"
    split_filename = "split_zhou_Caltech101.json"
    image_subdir = "101_ObjectCategories"

    def build_split(self, cfg):
        return read_and_split_image_folder(
            self.image_dir, ignored=CALTECH_IGNORED, new_cnames=CALTECH_NEW_CNAMES)


@DATASET_REGISTRY.register()
class UCF101(_SplitJsonDataset):
    """datasets/ucf101.py (mid-frame jpgs, CamelCase -> underscore names)"""

    dataset_dir = "ucf101"
    split_filename = "split_zhou_UCF101.json"
    image_subdir = "UCF-101-midframes"

    def build_split(self, cfg):
        with open(os.path.join(self.dataset_dir, "ucfTrainTestlist",
                               "classInd.txt")) as f:
            cname2lab = {l.split(" ")[1].strip(): int(l.split(" ")[0]) - 1
                         for l in f}

        def read(text_file):
            items = []
            with open(os.path.join(self.dataset_dir, "ucfTrainTestlist",
                                   text_file)) as f:
                for line in f:
                    path = line.strip().split(" ")[0]
                    action, filename = path.split("/")
                    renamed = "_".join(re.findall("[A-Z][^A-Z]*", action))
                    items.append(Datum(
                        impath=os.path.join(self.image_dir, renamed,
                                            filename.replace(".avi", ".jpg")),
                        label=cname2lab[action], classname=renamed))
            return items

        trainval = read("trainlist01.txt")
        test = read("testlist01.txt")
        train, val = self.split_trainval(trainval)
        return train, val, test


def read_wnid_classnames(text_file):
    """classnames.txt: '<wnid> <name words...>' per line
    (imagenet.py read_classnames)."""
    classnames = OrderedDict()
    with open(text_file) as f:
        for line in f:
            parts = line.strip().split(" ")
            classnames[parts[0]] = " ".join(parts[1:])
    return classnames


def _read_image_folder_by_wnid(split_dir, classnames):
    items = []
    folders = sorted(f.name for f in os.scandir(split_dir) if f.is_dir())
    for label, folder in enumerate(folders):
        cname = classnames[folder]
        fdir = os.path.join(split_dir, folder)
        for imname in sorted(os.listdir(fdir)):
            if imname.startswith("."):
                continue
            items.append(Datum(impath=os.path.join(fdir, imname),
                               label=label, classname=cname))
    return items


@DATASET_REGISTRY.register()
class ImageNet(DatasetBase):
    """datasets/imagenet.py: train/ + val/ wnid folders, classnames.txt,
    preprocessed.pkl cache. Test split = the val set (imagenet.py:43)."""

    dataset_dir = "imagenet"

    def __init__(self, cfg):
        import pickle

        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        if not os.path.isdir(self.image_dir):
            self.image_dir = self.dataset_dir
        preprocessed = os.path.join(self.dataset_dir, "preprocessed.pkl")
        if os.path.exists(preprocessed):
            # reference-written caches hold Dassl Datum objects —
            # load_foreign_pickle stubs the dassl module (as Bamboo does)
            from mvlpt_torch.data.datum import load_foreign_pickle

            cache = load_foreign_pickle(preprocessed)
            train = DatasetBase._coerce_items(cache["train"])
            test = DatasetBase._coerce_items(cache["test"])
        else:
            classnames = read_wnid_classnames(
                os.path.join(self.dataset_dir, "classnames.txt"))
            train = _read_image_folder_by_wnid(
                os.path.join(self.image_dir, "train"), classnames)
            test = _read_image_folder_by_wnid(
                os.path.join(self.image_dir, "val"), classnames)
            with open(preprocessed, "wb") as f:
                pickle.dump({"train": train, "test": test}, f,
                            protocol=pickle.HIGHEST_PROTOCOL)

        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots >= 1:
            fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")

            def build():
                # cache stores only the train subset (imagenet.py:58-63)
                return (DatasetBase.generate_fewshot_dataset(
                    train, num_shots, seed=cfg.SEED), [])

            train, _ = DatasetBase.load_fewshot_cached(
                fewshot_dir, num_shots, cfg.SEED, build)
        subsample = cfg.DATASET.SUBSAMPLE_CLASSES
        train, test = DatasetBase.subsample_classes(train, test, subsample=subsample)
        super().__init__(train_x=train, val=test, test=test)


class _ImageNetVariant(DatasetBase):
    """Test-only ImageNet shift variants (imagenetv2.py, imagenet_sketch.py,
    imagenet_a.py, imagenet_r.py)."""

    dataset_dir = ""
    image_subdir = "images"
    # imagenet_a.py:8 / imagenet_r.py:8 skip stray non-class entries
    ignored = ("README.txt",)

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, self.image_subdir)
        classnames = read_wnid_classnames(
            os.path.join(self.dataset_dir, "classnames.txt"))
        data = self.read_data(classnames)
        super().__init__(train_x=data, test=data)

    def read_data(self, classnames):
        """Labels enumerate the PRESENT folders densely (imagenet_a.py:38
        `for label, folder in enumerate(folders)`): ImageNet-A/R ship 200
        of the 1000 classnames.txt wnids, and the reference scores them
        as a dense 200-way problem, not sparse 1000-way labels."""
        items = []
        folders = sorted(
            f.name for f in os.scandir(self.image_dir)
            if f.is_dir() and not f.name.startswith(".")
            and f.name not in self.ignored)
        for label, folder in enumerate(folders):
            cname = classnames[folder]
            fdir = os.path.join(self.image_dir, folder)
            for imname in sorted(os.listdir(fdir)):
                if imname.startswith("."):  # listdir_nohidden parity
                    continue
                items.append(Datum(impath=os.path.join(fdir, imname),
                                   label=label, classname=cname))
        return items


@DATASET_REGISTRY.register()
class ImageNetV2(_ImageNetVariant):
    """datasets/imagenetv2.py — folders are label ints 0..999."""

    dataset_dir = "imagenetv2"
    image_subdir = "imagenetv2-matched-frequency-format-val"

    def read_data(self, classnames):
        items = []
        wnids = list(classnames.keys())
        for label in range(1000):
            cdir = os.path.join(self.image_dir, str(label))
            cname = classnames[wnids[label]]
            for imname in sorted(os.listdir(cdir)):
                if imname.startswith("."):  # listdir_nohidden parity
                    continue
                items.append(Datum(impath=os.path.join(cdir, imname),
                                   label=label, classname=cname))
        return items


@DATASET_REGISTRY.register()
class ImageNetSketch(_ImageNetVariant):
    """datasets/imagenet_sketch.py"""

    dataset_dir = "imagenet-sketch"


@DATASET_REGISTRY.register()
class ImageNetA(_ImageNetVariant):
    """datasets/imagenet_a.py (200-class subset, folder wnids; images
    under imagenet-adversarial/imagenet-a/, imagenet_a.py:23)"""

    dataset_dir = "imagenet-adversarial"
    image_subdir = "imagenet-a"


@DATASET_REGISTRY.register()
class ImageNetR(_ImageNetVariant):
    """datasets/imagenet_r.py (200-class subset; images under
    imagenet-rendition/imagenet-r/, imagenet_r.py:23)"""

    dataset_dir = "imagenet-rendition"
    image_subdir = "imagenet-r"


@DATASET_REGISTRY.register()
class ImageNet21k(DatasetBase):
    """datasets/imagenet_21k.py: folder tree + classnames file; 80/20
    train/test split, val = test."""

    dataset_dir = "imagenet21k"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        if not os.path.isdir(self.dataset_dir):
            self.dataset_dir = root
        self.image_dir = self.dataset_dir
        cn_file = os.path.join(self.dataset_dir, "classnames.txt")
        new_cnames = read_wnid_classnames(cn_file) if os.path.exists(cn_file) else None
        train, test, _ = read_and_split_image_folder(
            self.image_dir, p_trn=0.8, p_val=0.2, new_cnames=new_cnames)
        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots >= 1:
            train = DatasetBase.generate_fewshot_dataset(
                train, num_shots, seed=cfg.SEED)
        train, test = DatasetBase.subsample_classes(
            train, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES)
        super().__init__(train_x=train, val=test, test=test)


@DATASET_REGISTRY.register()
class Bamboo(ImageNet21k):
    """datasets/bamboo.py:17-78 faithful flow over a real Bamboo dump:
    classnames come from ``bamboo_id_map_sample.json`` (folder id ->
    name, lists collapsed to their first entry, bamboo.py:80-101),
    images live at ``<root>/images`` (the reference hardcodes root as
    the dataset dir, bamboo.py:27-30), the 80/20 split is cached in
    ``preprocessed.pkl`` and few-shot subsets in ``split_fewshot/`` —
    caches written by the reference (Dassl Datum pickles) load via the
    tolerant unpickler."""

    dataset_dir = "bamboo"

    def __init__(self, cfg):
        import json
        import pickle

        from mvlpt_torch.data.datum import load_foreign_pickle

        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        ddir = os.path.join(root, type(self).dataset_dir)
        self.dataset_dir = ddir if os.path.isdir(ddir) else root
        image_dir = os.path.join(self.dataset_dir, "images")
        self.image_dir = image_dir if os.path.isdir(image_dir) \
            else self.dataset_dir

        preprocessed = os.path.join(self.dataset_dir, "preprocessed.pkl")
        if os.path.exists(preprocessed):
            data = load_foreign_pickle(preprocessed)
            train = DatasetBase._coerce_items(data["train"])
            test = DatasetBase._coerce_items(data["test"])
        else:
            id_map = os.path.join(self.dataset_dir,
                                  "bamboo_id_map_sample.json")
            if os.path.exists(id_map):
                with open(id_map) as f:
                    raw = json.load(f)
                new_cnames = {k: (v[0] if isinstance(v, list) else v)
                              for k, v in raw.items()}
            else:  # classnames.txt fallback (shared with ImageNet21k)
                cn_file = os.path.join(self.dataset_dir, "classnames.txt")
                new_cnames = read_wnid_classnames(cn_file) \
                    if os.path.exists(cn_file) else None
            train, test, _ = read_and_split_image_folder(
                self.image_dir, p_trn=0.8, p_val=0.2,
                new_cnames=new_cnames)
            with open(preprocessed, "wb") as f:
                pickle.dump({"train": train, "test": test}, f,
                            protocol=pickle.HIGHEST_PROTOCOL)

        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots >= 1:
            fewshot_dir = os.path.join(self.dataset_dir, "split_fewshot")
            train, _ = DatasetBase.load_fewshot_cached(
                fewshot_dir, num_shots, cfg.SEED,
                lambda: (DatasetBase.generate_fewshot_dataset(
                    train, num_shots, seed=cfg.SEED), []))
        train, test = DatasetBase.subsample_classes(
            train, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES)
        DatasetBase.__init__(self, train_x=train, val=test, test=test)
