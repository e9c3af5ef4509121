"""ELEVATER (ICinW) dataset pipeline over local files.

The counterpart of ``mvlpt_tpu/data/elevater/manifest.py``, with the same
``random`` and ``np.random`` draws in the same order, so manifests,
few-shot subsets and val splits equal the JAX package's item for item.

The reference drives ELEVATER through the Azure-hosted
``vision_datasets`` hub (feature.py:538-619): resolve a manifest,
adapt labels (multiclass -> int, multilabel -> k-hot), few-shot
subsample with ``sample_few_shot_subset(shots, random_seed)``,
class-balanced 20% val split, and, for multitask, merge per-task
manifests into one global class space (feature.py:758-862).

This module reads a local manifest format instead (nothing is
downloaded):

  <root>/<task>/manifest.json
      {"type": "classification_multiclass" | "classification_multilabel",
       "splits": {"train": [["rel/path.jpg", [label, ...]], ...],
                   "test": [...]}}

with an ImageFolder fallback (<root>/<task>/{train,test}/<class>/*.jpg),
mirroring the reference's torchvision.ImageFolder fallback
(feature.py:609-617). Task metadata (classnames, templates, metric)
comes from this package's copy of metadata.json.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import re
from collections import Counter, defaultdict
from functools import lru_cache

import numpy as np

MULTICLASS = "classification_multiclass"
MULTILABEL = "classification_multilabel"

_META_PATH = os.path.join(os.path.dirname(__file__), "metadata.json")

# The 20-task ELEVATER benchmark list
# (scripts/mvlpt/main_mt_elevater_cut.sh:24).
ELEVATER_20_TASKS = [
    "hateful-memes", "cifar-10", "mnist", "oxford-flower-102",
    "oxford-iiit-pets", "resisc45_clip", "country211", "food-101",
    "stanford-cars", "caltech-101", "dtd", "voc-2007-classification",
    "cifar-100", "fgvc-aircraft-2013b-variants102", "patch-camelyon",
    "rendered-sst2", "gtsrb", "eurosat_clip", "fer-2013", "kitti-distance",
]


@lru_cache()
def load_metadata() -> dict:
    with open(_META_PATH) as f:
        return json.load(f)["tasks"]


def class_map(task: str) -> list:
    meta = load_metadata()
    if task not in meta:
        raise KeyError(
            f"unknown ELEVATER task {task!r} — prompts/classnames come "
            f"from data/elevater/metadata.json (the reference's "
            f"prompts.py:3221 tables); known tasks: {sorted(meta)}")
    return meta[task]["classes"]


def class_map_metric(task: str) -> str:
    return load_metadata()[task]["metric"]


def template_map(task: str) -> list[str]:
    return load_metadata()[task]["templates"]


def first_classname(entry) -> str:
    """class_map values may be synonym lists; take the first
    (mvlpt.py:754-758)."""
    return entry[0] if isinstance(entry, list) else entry


@dataclasses.dataclass
class ElevaterItem:
    impath: str
    labels: tuple[int, ...]   # one id for multiclass, many for multilabel
    task_id: int = 0


@dataclasses.dataclass
class TaskManifest:
    task: str
    dataset_type: str                    # MULTICLASS / MULTILABEL
    num_classes: int
    train: list[ElevaterItem]
    test: list[ElevaterItem]
    # Populated only when DATASET.VAL_SET names an explicit val split
    # (feature.py:611-613); empty means "carve val out of train".
    val: list[ElevaterItem] = dataclasses.field(default_factory=list)
    # Classname table resolved at load time (manifest-declared >
    # metadata.json > placeholders); entries may be synonym lists
    # like class_map's (mvlpt.py:754-758).
    classnames: list = dataclasses.field(default_factory=list)

    @property
    def is_multilabel(self) -> bool:
        return self.dataset_type == MULTILABEL


def _load_image_folder_split(split_dir: str, classnames) -> list[ElevaterItem]:
    items = []
    folders = sorted(f.name for f in os.scandir(split_dir) if f.is_dir())
    for label, folder in enumerate(folders):
        fdir = os.path.join(split_dir, folder)
        for name in sorted(os.listdir(fdir)):
            if name.startswith("."):
                continue
            items.append(ElevaterItem(os.path.join(fdir, name), (label,)))
    return items


def _align_meta_to_folders(folders: list[str], meta_names: list) -> list:
    """Place metadata classnames at the labels ImageFolder actually
    assigns. Labels come from SORTED folder order
    (_load_image_folder_split); metadata.json lists classes in its own
    canonical label order — using the metadata list positionally would
    silently pair every prompt with the wrong label whenever the two
    orders differ (e.g. folders 'cat','dog' sort to cat=0 while the
    metadata lists ['dog','cat']).

    Resolution order: (a) all-numeric folders index the metadata table
    directly ('3/' means metadata class 3); (b) name-keyed folders
    match their metadata entry (case/space/underscore-insensitive,
    synonym lists included); (c) anything unmatchable keeps the folder
    names themselves — label-aligned by construction, just less pretty
    than the metadata spellings."""
    if all(f.isdigit() for f in folders):
        idx = [int(f) for f in folders]
        if sorted(idx) == list(range(len(meta_names))):
            return [meta_names[i] for i in idx]
        return list(folders)

    def norm(s):
        return re.sub(r"[\s_-]+", " ", str(s)).strip().lower()

    table = {}
    for entry in meta_names:
        for name in (entry if isinstance(entry, list) else [entry]):
            table.setdefault(norm(name), entry)
    aligned = [table.get(norm(f)) for f in folders]
    if all(a is not None for a in aligned):
        return aligned
    return list(folders)


def _resolve_classnames(task: str, declared: int | None, own,
                        strict: bool):
    """Pick the classname table for a task (manifest-declared >
    metadata.json > placeholders) and enforce count agreement.

    The guard exists because prompt-tuning flows build prompts / label
    offsets from the classname table but k-hot targets from the
    manifest count — a silent disagreement surfaces later as an opaque
    logit / target shape mismatch inside the train step. It is scoped
    to flows that actually consume classnames: a manifest carrying its
    own ``classnames`` is authoritative for its local data, and pure
    feature-extraction flows (``strict=False`` — e.g. the non-CLIP
    model-zoo branch of extract_features, where no text tower ever
    reads a classname) get positional placeholders instead of a hard
    fail."""
    if own is not None:
        if declared is not None and len(own) != declared:
            raise ValueError(
                f"task {task!r}: manifest.json declares "
                f"num_classes={declared} but carries "
                f"{len(own)} classnames — counts must agree.")
        return list(own), len(own)
    try:
        meta_names = class_map(task)
    except KeyError:
        if declared is None:
            raise  # nothing to fall back on: no own names, no count
        if strict:
            raise ValueError(
                f"task {task!r}: not in data/elevater/metadata.json and "
                f"the manifest carries no 'classnames' — prompt/label "
                f"flows need a real classname table. Add a 'classnames' "
                f"list to the manifest (authoritative for local data) or "
                f"register the task in metadata.json. Flows that never "
                f"read classnames (feature extraction) load with "
                f"strict_classnames=False and get positional "
                f"placeholders.") from None
        return [f"{task} class {i}" for i in range(declared)], declared
    if declared is not None and declared != len(meta_names):
        if strict:
            raise ValueError(
                f"task {task!r}: manifest.json declares "
                f"num_classes={declared} but the metadata classname "
                f"table has {len(meta_names)} classes "
                f"(data/elevater/metadata.json). Rebuild the manifest "
                f"add a 'classnames' "
                f"list to the manifest, or register the task's real "
                f"classnames — counts must agree.")
        return [f"{task} class {i}" for i in range(declared)], declared
    return list(meta_names), len(meta_names)


def load_task_manifest(root: str, task: str, train_set: str = "train",
                       val_set: str = "", test_set: str = "val", *,
                       strict_classnames: bool = True) -> TaskManifest:
    """Load one task, honoring DATASET.TRAIN_SET/VAL_SET/TEST_SET
    (feature.py:609-617: the local ImageFolder path reads
    ROOT/<TRAIN_SET> and ROOT/<TEST_SET>, plus ROOT/<VAL_SET> when set).
    With the reference default TEST_SET='val', a ``test`` directory (our
    canonical layout) is also accepted.

    ``strict_classnames=False`` relaxes the manifest/metadata
    class-count guard for flows that never consume classnames (see
    _resolve_classnames)."""
    task_dir = os.path.join(root, task)
    manifest_path = os.path.join(task_dir, "manifest.json")
    test_candidates = [test_set, "test", "val"] if test_set == "val" \
        else [test_set]
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            m = json.load(f)
        classnames, n_classes = _resolve_classnames(
            task, m.get("num_classes"), m.get("classnames"),
            strict_classnames)
        splits = {}
        for split, rows in m["splits"].items():
            splits[split] = [
                ElevaterItem(os.path.join(task_dir, rel), tuple(int(l) for l in labels))
                for rel, labels in rows
            ]
        test_items = next(
            (splits[c] for c in test_candidates if c in splits), [])
        if train_set != "train" and train_set not in splits:
            raise FileNotFoundError(
                f"DATASET.TRAIN_SET={train_set!r} not in manifest splits "
                f"{sorted(m['splits'])} for task {task!r}")
        if val_set and val_set not in splits:
            raise FileNotFoundError(
                f"DATASET.VAL_SET={val_set!r} not in manifest splits "
                f"{sorted(m['splits'])} for task {task!r}")
        return TaskManifest(
            task=task,
            dataset_type=m.get("type", MULTICLASS),
            num_classes=n_classes,
            train=splits.get(train_set, []),
            test=test_items,
            val=splits.get(val_set, []) if val_set else [],
            classnames=classnames,
        )
    # ImageFolder fallback
    train_dir = os.path.join(task_dir, train_set)
    if os.path.isdir(train_dir):
        # Folder names are natural classnames; prefer the metadata
        # table (richer names) only when the counts agree AND each
        # metadata entry can be placed at the folder-derived label it
        # actually describes (_align_meta_to_folders) — labels come
        # from SORTED folder order (_load_image_folder_split), while
        # metadata.json lists classes in canonical label order, and the
        # two orders need not coincide.
        folders = sorted(f.name for f in os.scandir(train_dir) if f.is_dir())
        meta_names = load_metadata().get(task, {}).get("classes")
        if meta_names is not None and len(folders) != len(meta_names):
            if strict_classnames:
                raise ValueError(
                    f"task {task!r}: ImageFolder layout under {train_dir} "
                    f"has {len(folders)} class folders but the metadata "
                    f"classname table has {len(meta_names)} classes "
                    f"(data/elevater/metadata.json) — counts must agree.")
            classnames = folders
        elif meta_names is not None:
            classnames = _align_meta_to_folders(folders, meta_names)
        else:
            classnames = folders
        n_classes = len(classnames)
        test_dir = next(
            (d for c in test_candidates
             if os.path.isdir(d := os.path.join(task_dir, c))), None)
        if test_dir is None and test_set != "val":
            raise FileNotFoundError(
                f"DATASET.TEST_SET={test_set!r} not found under {task_dir}")
        val_dir = os.path.join(task_dir, val_set) if val_set else None
        if val_set and not os.path.isdir(val_dir):
            raise FileNotFoundError(
                f"DATASET.VAL_SET={val_set!r} not found under {task_dir}")
        return TaskManifest(
            task=task, dataset_type=MULTICLASS, num_classes=n_classes,
            train=_load_image_folder_split(train_dir, None),
            test=_load_image_folder_split(test_dir, None) if test_dir else [],
            val=_load_image_folder_split(val_dir, None) if val_set else [],
            classnames=classnames,
        )
    raise FileNotFoundError(
        f"No manifest.json or {train_set}/ ImageFolder for ELEVATER task "
        f"{task!r} under {task_dir}")


def sample_few_shot_subset(items: list[ElevaterItem], shots: int, seed: int,
                           num_classes: int) -> list[ElevaterItem]:
    """Per-class few-shot sampling; multilabel items count toward every
    class they carry (vision_datasets' greedy semantics).

    PROTOCOL-equal, not SUBSET-equal, to the hub library: the same
    greedy any-class-under-quota rule over a seeded shuffle, but
    ``random.Random(seed)`` here is a different RNG stream than
    ``vision_datasets.sample_few_shot_subset``'s, so a given (task,
    shots, seed) picks a different concrete subset than a reference run
    — per-seed numbers are not comparable run-for-run against reference
    logs; seed-averaged results are (both follow the same protocol).
    Deterministic within this framework."""
    if shots is None or shots <= 0:
        return list(items)
    rng = random.Random(seed)
    order = list(range(len(items)))
    rng.shuffle(order)
    counts = Counter()
    picked = []
    for idx in order:
        item = items[idx]
        if any(counts[l] < shots for l in item.labels):
            picked.append(item)
            counts.update(item.labels)
    picked.sort(key=lambda it: it.impath)
    return picked


def train_val_split(items: list[ElevaterItem], val_frac: float, seed: int,
                    num_classes: int, multilabel: bool):
    """Class-balanced val split (feature.py:109-176: per-class ceil count
    for single-label; greedy cover for multilabel)."""
    if not items:
        return [], []
    if not multilabel:
        by_class = defaultdict(list)
        for i, it in enumerate(items):
            by_class[it.labels[0]].append(i)
        val_idx = set()
        for label, idxs in by_class.items():
            n = math.ceil(len(idxs) * val_frac)
            val_idx.update(idxs[:n])
    else:
        labels = np.zeros((len(items), num_classes), np.int64)
        for i, it in enumerate(items):
            labels[i, list(it.labels)] = 1
        target = np.ceil(labels.sum(0) * val_frac)
        val_idx = set()
        remaining = labels.copy()
        next_targets = np.where(target > 0)[0]
        while next_targets.size > 0:
            cls = next_targets[0]
            cand = np.where(remaining[:, cls] > 0)[0]
            if cand.size == 0:
                target[cls] = 0
            else:
                i = int(cand[0])
                val_idx.add(i)
                target -= remaining[i]
                remaining[i] = 0
            next_targets = np.where(target > 0)[0]
    train = [it for i, it in enumerate(items) if i not in val_idx]
    val = [items[i] for i in sorted(val_idx)]
    return train, val


@dataclasses.dataclass
class MultitaskManifest:
    """Merged ELEVATER tasks with a global contiguous class space
    (create_multitask_manifest, feature.py:758-780)."""

    task_names: list[str]
    manifests: dict[str, TaskManifest]
    class_offset: dict[str, int]
    num_classes: int

    def get_cid(self, label_idx: int, task: str) -> int:
        return self.class_offset[task] + label_idx

    def task_class_idx(self) -> dict[str, tuple[int, int]]:
        out = {}
        for t in self.task_names:
            lo = self.class_offset[t]
            out[t] = (lo, lo + self.manifests[t].num_classes)
        return out


def load_multitask_manifest(root: str, tasks: list[str]) -> MultitaskManifest:
    manifests, offsets, off = {}, {}, 0
    for t in tasks:
        m = load_task_manifest(root, t)
        manifests[t] = m
        offsets[t] = off
        off += m.num_classes
    return MultitaskManifest(
        task_names=list(tasks), manifests=manifests,
        class_offset=offsets, num_classes=off)


def write_task_manifest(task_dir: str, num_classes: int, counts: dict, rng,
                        multilabel: bool = False, classnames=None) -> list[tuple[str, int]]:
    """Write ``task_dir/manifest.json`` in the local layout that
    :func:`load_task_manifest` reads, for a synthetic task: ``counts[split]``
    items a class in each split, in split, class and item order, named
    ``<split>/<label>_<i>.jpg`` with label ``label``; a multilabel item
    also carries one or two other classes drawn from ``rng`` (a
    ``np.random.RandomState``). Makes the split directories and returns
    each item's (path under ``task_dir``, class) in that order: the caller
    writes the images."""
    manifest = {"type": MULTILABEL if multilabel else MULTICLASS,
                "num_classes": num_classes, "splits": {}}
    if classnames is not None:
        manifest["classnames"] = list(classnames)
    items = []
    for split, count in counts.items():
        rows = []
        for label in range(num_classes):
            for i in range(count):
                labels = [label]
                if multilabel:
                    extra = rng.choice(num_classes, size=rng.randint(1, 3), replace=False)
                    labels = sorted({label, *(int(x) for x in extra)})
                rel = f"{split}/{label}_{i}.jpg"
                items.append((rel, label))
                rows.append([rel, labels])
        manifest["splits"][split] = rows
        os.makedirs(os.path.join(task_dir, split), exist_ok=True)
    with open(os.path.join(task_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return items
