"""Data doctor: validate dataset directory layouts before training.

The reference documents download/untar recipes (DATASETS.md, data.sh);
this tool checks the result: for each requested dataset it verifies the
expected files/directories (docs/DATASETS.md layouts), reports what is
missing, and samples a few images to catch decode errors. The
counterpart of ``mvlpt_tpu/cli/check_data.py``, with the same flags and
report.

Usage:
    python -m mvlpt_torch.cli.check_data --root $DATA \\
        --dataset OxfordPets,Caltech101            # CoOp universe
    python -m mvlpt_torch.cli.check_data --root $ELEVATER \\
        --dataset cifar-10,mnist --elevater        # manifest universe
"""

from __future__ import annotations

import argparse
import os

_COOP_EXPECTATIONS = {
    "OxfordPets": ("oxford_pets", ["images"], ["split_zhou_OxfordPets.json",
                                               "annotations/trainval.txt"]),
    "OxfordFlowers": ("oxford_flowers", ["jpg"],
                      ["split_zhou_OxfordFlowers.json", "imagelabels.mat"]),
    "FGVCAircraft": ("fgvc_aircraft", ["images"],
                     ["variants.txt", "images_variant_train.txt"]),
    "DescribableTextures": ("dtd", ["images"],
                            ["split_zhou_DescribableTextures.json"]),
    "EuroSAT": ("eurosat", ["2750"], ["split_zhou_EuroSAT.json"]),
    "StanfordCars": ("stanford_cars", [], ["split_zhou_StanfordCars.json",
                                           "devkit/cars_meta.mat"]),
    "Food101": ("food-101", ["images"], ["split_zhou_Food101.json"]),
    "SUN397": ("sun397", ["SUN397"], ["split_zhou_SUN397.json"]),
    "Caltech101": ("caltech-101", ["101_ObjectCategories"],
                   ["split_zhou_Caltech101.json"]),
    "UCF101": ("ucf101", ["UCF-101-midframes"], ["split_zhou_UCF101.json"]),
    "ImageNet": ("imagenet", ["images/train", "images/val"],
                 ["classnames.txt"]),
    "ImageNetV2": ("imagenetv2",
                   ["imagenetv2-matched-frequency-format-val"],
                   ["classnames.txt"]),
    "ImageNetSketch": ("imagenet-sketch", ["images"], ["classnames.txt"]),
    "ImageNetA": ("imagenet-adversarial", ["imagenet-a"], ["classnames.txt"]),
    "ImageNetR": ("imagenet-rendition", ["imagenet-r"], ["classnames.txt"]),
}


def _check_coop(root: str, name: str) -> list[str]:
    problems = []
    if name not in _COOP_EXPECTATIONS:
        return [f"unknown CoOp dataset {name!r}"]
    ddir, want_dirs, want_any = _COOP_EXPECTATIONS[name]
    base = os.path.join(root, ddir)
    if not os.path.isdir(base):
        return [f"missing dataset dir {base}"]
    for d in want_dirs:
        if not os.path.isdir(os.path.join(base, d)):
            problems.append(f"missing directory {ddir}/{d}")
    # split json OR its builder inputs must exist
    if want_any and not any(
            os.path.exists(os.path.join(base, f)) for f in want_any):
        problems.append(
            f"none of {want_any} found under {ddir}/ "
            "(need the split json or the raw annotation files)")
    return problems


def _check_elevater(root: str, task: str) -> list[str]:
    from mvlpt_torch.data.elevater import load_metadata

    problems = []
    if task not in load_metadata():
        problems.append(f"{task!r} is not a known ELEVATER task "
                        "(see data/elevater/metadata.json)")
    tdir = os.path.join(root, task)
    manifest = os.path.join(tdir, "manifest.json")
    if os.path.exists(manifest):
        try:
            from mvlpt_torch.data.elevater import load_task_manifest

            m = load_task_manifest(root, task)

            def _exists(path):
                # hub-dump manifests keep images INSIDE the split zips
                # (`train.zip@1.jpg`, data/zipio.py) — check the zip
                # member, not the literal path.
                from mvlpt_torch.data import zipio

                if zipio.is_zip_path(path):
                    archive, member = zipio.split_zip_path(path)
                    if not os.path.exists(archive):
                        return False
                    try:
                        return member in zipio._handle(archive).namelist()
                    except Exception:
                        return False
                return os.path.exists(path)

            for split, items in (("train", m.train), ("test", m.test)):
                if not items:
                    problems.append(f"{task}: empty {split} split")
                    continue
                missing = [it.impath for it in items[:50]
                           if not _exists(it.impath)]
                if missing:
                    problems.append(
                        f"{task}: {len(missing)}/50 sampled {split} image "
                        f"paths missing (first: {missing[0]})")
        except Exception as e:
            problems.append(f"{task}: manifest unreadable: {e!r}")
    elif os.path.isdir(os.path.join(tdir, "train")):
        pass  # ImageFolder fallback
    else:
        problems.append(
            f"{task}: no manifest.json or train/ ImageFolder under {tdir} "
            "(build one with mvlpt-tpu's cli.build_manifest)")
    return problems


def _sample_decode(root: str) -> list[str]:
    problems = []
    from PIL import Image

    count = 0
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.lower().endswith((".jpg", ".jpeg", ".png")):
                try:
                    Image.open(os.path.join(dirpath, f)).load()
                except Exception as e:
                    problems.append(f"undecodable image {dirpath}/{f}: {e!r}")
                count += 1
                if count >= 20:
                    return problems
    if count == 0:
        # zip-backed hub dumps keep every image inside split zips —
        # sample members from those before declaring the root empty.
        import zipfile

        for dirpath, _, files in os.walk(root):
            for f in files:
                if not f.lower().endswith(".zip"):
                    continue
                zpath = os.path.join(dirpath, f)
                try:
                    with zipfile.ZipFile(zpath) as z:
                        names = [n for n in z.namelist() if n.lower()
                                 .endswith((".jpg", ".jpeg", ".png"))]
                        for n in names[:5]:
                            import io

                            Image.open(io.BytesIO(z.read(n))).load()
                            count += 1
                except Exception as e:
                    problems.append(f"bad zip {zpath}: {e!r}")
                if count >= 20:
                    return problems
    if count == 0:
        problems.append(f"no images found anywhere under {root}")
    return problems


def cli(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--dataset", required=True,
                   help="comma-separated dataset names / ELEVATER tasks")
    p.add_argument("--elevater", action="store_true")
    p.add_argument("--skip-decode", action="store_true")
    args = p.parse_args(argv)

    total = 0
    for name in args.dataset.split(","):
        probs = (_check_elevater(args.root, name) if args.elevater
                 else _check_coop(args.root, name))
        status = "OK" if not probs else f"{len(probs)} problem(s)"
        print(f"[{name}] {status}")
        for pr in probs:
            print(f"  - {pr}")
        total += len(probs)
    if not args.skip_decode:
        for pr in _sample_decode(args.root):
            print(f"  - {pr}")
            total += 1
    raise SystemExit(1 if total else 0)


if __name__ == "__main__":
    cli()
