"""Dataset item + base dataset with split/few-shot/subsample machinery.

The counterpart of ``mvlpt_tpu/data/datum.py``.

Functional equivalents of Dassl's Datum/DatasetBase as used by the CoOp
dataset loaders (the reference's datasets/oxford_pets.py:11-186):

  * persisted JSON splits (``split_zhou_*.json``) with the same
    [impath, label, classname] triplet format, so existing split files
    from CoOp data directories load unchanged;
  * seeded few-shot subsampling cached per (shots, seed) pickle under
    ``split_fewshot/`` with the same filenames;
  * base/new class subsetting (oxford_pets.py:140-186).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import random
from collections import defaultdict


@dataclasses.dataclass
class Datum:
    impath: str
    label: int
    classname: str = ""
    domain: int = 0


class _ForeignDatum:
    """Stand-in for Dassl's Datum in foreign pickles (reference caches
    store dassl.data.datasets.base_dataset.Datum with _impath/_label/
    _domain/_classname attributes; dassl itself is not installed here)."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)

    def _get(self, name, default=None):
        d = self.__dict__
        return d.get(name, d.get("_" + name, default))

    @property
    def impath(self):
        return self._get("impath")

    @property
    def label(self):
        return self._get("label", 0)

    @property
    def classname(self):
        return self._get("classname", "")

    @property
    def domain(self):
        return self._get("domain", 0)


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickle reference-written caches without their class imports:
    any unresolvable *.Datum maps to _ForeignDatum."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            if name == "Datum":
                return _ForeignDatum
            raise


def load_foreign_pickle(path: str):
    """pickle.load that tolerates Dassl Datum references in the stream."""
    with open(path, "rb") as f:
        return _TolerantUnpickler(f).load()


class DatasetBase:
    """A train/val/test triple of Datum lists with derived metadata."""

    def __init__(self, train_x=None, val=None, test=None, train_u=None):
        self.train_x = train_x or []
        self.val = val or []
        self.test = test or []
        self.train_u = train_u or []
        self._rebuild_metadata()

    def _rebuild_metadata(self):
        label2name = {}
        for d in self.train_x + self.val + self.test:
            label2name[d.label] = d.classname
        self.num_classes = (max(label2name) + 1) if label2name else 0
        self.lab2cname = {k: label2name.get(k, "") for k in sorted(label2name)}
        self.classnames = [label2name.get(i, "") for i in range(self.num_classes)]

    # ---------------------------------------------------------------- splits
    @staticmethod
    def read_split(filepath: str, path_prefix: str):
        """Load a split_zhou_*.json (same schema as the reference's)."""
        import json

        def _convert(rows):
            return [
                Datum(impath=os.path.join(path_prefix, imp), label=int(lab),
                      classname=cname)
                for imp, lab, cname in rows
            ]

        with open(filepath) as f:
            split = json.load(f)
        return _convert(split["train"]), _convert(split["val"]), _convert(split["test"])

    @staticmethod
    def save_split(train, val, test, filepath: str, path_prefix: str):
        import json

        def _extract(items):
            out = []
            for d in items:
                imp = d.impath
                if imp.startswith(path_prefix):
                    imp = imp[len(path_prefix):].lstrip("/")
                out.append((imp, d.label, d.classname))
            return out

        split = {"train": _extract(train), "val": _extract(val), "test": _extract(test)}
        os.makedirs(os.path.dirname(filepath), exist_ok=True)
        with open(filepath, "w") as f:
            json.dump(split, f, indent=4, separators=(",", ": "))

    @staticmethod
    def split_trainval(trainval, p_val: float = 0.2, seed: int = 0):
        """Class-stratified random train/val split (dtd.py-style)."""
        rng = random.Random(seed)
        by_label = defaultdict(list)
        for idx, item in enumerate(trainval):
            by_label[item.label].append(idx)
        train, val = [], []
        for label, idxs in by_label.items():
            n_val = round(len(idxs) * p_val)
            assert n_val > 0
            rng.shuffle(idxs)
            for n, idx in enumerate(idxs):
                item = trainval[idx]
                if n < n_val:
                    val.append(item)
                else:
                    train.append(item)
        return train, val

    # -------------------------------------------------------------- few-shot
    @staticmethod
    def generate_fewshot_dataset(items, num_shots: int, seed: int = 0,
                                 repeat: bool = False):
        """Sample num_shots items per class (Dassl semantics: classes with
        fewer than num_shots keep all their items, or repeat-sample)."""
        if num_shots < 1:
            return list(items)
        rng = random.Random(seed)
        by_class = defaultdict(list)
        for item in items:
            by_class[item.label].append(item)
        out = []
        for label in sorted(by_class):
            group = by_class[label]
            if len(group) >= num_shots:
                out.extend(rng.sample(group, num_shots))
            elif repeat:
                out.extend(rng.choices(group, k=num_shots))
            else:
                out.extend(group)
        return out

    @staticmethod
    def _coerce_items(items):
        """Accept Datum-like objects from foreign caches (e.g. Dassl's
        Datum with property accessors) by copying the public fields."""
        out = []
        for d in items:
            if isinstance(d, Datum):
                out.append(d)
            else:
                out.append(Datum(
                    impath=d.impath, label=int(d.label),
                    classname=getattr(d, "classname", "") or "",
                    domain=int(getattr(d, "domain", 0) or 0)))
        return out

    @staticmethod
    def load_fewshot_cached(preprocessed_dir: str, num_shots: int, seed: int,
                            build_fn):
        """Per-(shots, seed) pickle cache, same layout as
        oxford_pets.py:33-49 (split_fewshot/shot_{n}-seed_{s}.pkl).

        Caches written by the reference contain Dassl Datum objects and
        (for ImageNet) may lack the 'val' key; the tolerant unpickler
        shims those (fields are copied), and anything else unreadable
        falls back to a fresh (seeded, deterministic) rebuild without
        overwriting the foreign cache file."""
        os.makedirs(preprocessed_dir, exist_ok=True)
        path = os.path.join(preprocessed_dir, f"shot_{num_shots}-seed_{seed}.pkl")
        if os.path.exists(path):
            try:
                data = load_foreign_pickle(path)
                train = DatasetBase._coerce_items(data["train"])
                val = DatasetBase._coerce_items(data.get("val", []))
                return train, val
            except Exception as e:  # unreadable foreign pickle
                print(f"Could not load few-shot cache {path} ({e!r}); "
                      "rebuilding deterministically")
                return build_fn()
        train, val = build_fn()
        with open(path, "wb") as f:
            pickle.dump({"train": train, "val": val}, f, protocol=pickle.HIGHEST_PROTOCOL)
        return train, val

    # ------------------------------------------------------------- subsample
    @staticmethod
    def subsample_classes(*groups, subsample="all"):
        """Keep the first half ('base') or second half ('new') of classes,
        relabeling contiguously (oxford_pets.py:140-186)."""
        assert subsample in ("all", "base", "new")
        if subsample == "all":
            return list(groups)
        labels = sorted({d.label for d in groups[0]})
        m = (len(labels) + 1) // 2  # math.ceil(n/2), base gets the extra
        selected = labels[:m] if subsample == "base" else labels[m:]
        relabel = {y: i for i, y in enumerate(selected)}
        out = []
        for group in groups:
            out.append([
                dataclasses.replace(d, label=relabel[d.label])
                for d in group if d.label in relabel
            ])
        return out
