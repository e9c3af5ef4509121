"""Build a local ELEVATER manifest from common dataset layouts.

The reference streams ELEVATER tasks from the Azure ``vision_datasets``
hub (feature.py:555-567); this framework consumes offline manifests
(docs/DATASETS.md). This tool generates them from:

  * a verbatim ``vision_datasets`` hub dump: ``vision_datasets.json``
    registry + per-task ``root_folder`` with split index files whose
    rows reference zip-backed images (``train.zip@1.jpg label[,label]``
    — the hub's "iris" classification format; the registry schema is
    mirrored at trainers/vision_benchmark/resources/datasets/
    vision_datasets.json in the reference). Images stay inside the
    zips — the input pipeline reads them via data/zipio.py.
  * an ImageFolder tree:  <src>/{train,test}/<class>/*.jpg
  * an index TSV per split: `relative/path.jpg<TAB>label[,label...]`

The counterpart of ``mvlpt_tpu/cli/build_manifest.py``, with the same flags
and the same manifests, byte for byte; the task tables and the
ImageFolder alignment are the port's ``data/elevater`` (``class_map``,
``load_metadata``, ``manifest._align_meta_to_folders``) and the type
names its ``manifest.MULTICLASS``/``MULTILABEL``.

Usage:
    # hub dump (src contains vision_datasets.json):
    python -m mvlpt_torch.cli.build_manifest --src /data/hub_dump \\
        --task voc-2007-classification --root /data/elevater
    # ImageFolder / TSV:
    python -m mvlpt_torch.cli.build_manifest --src /data/raw/cifar10 \\
        --task cifar-10 --root /data/elevater [--multilabel]
"""

from __future__ import annotations

import argparse
import json
import os


def from_image_folder(src: str, splits=("train", "test")):
    # Label ids come from the sorted UNION of class folders across all
    # splits — enumerating each split separately would silently shift
    # every label after a class that is missing from one split.
    present = {}
    for split in splits:
        sdir = os.path.join(src, split)
        if os.path.isdir(sdir):
            present[split] = sorted(
                f.name for f in os.scandir(sdir) if f.is_dir())
    classes = sorted({c for folders in present.values() for c in folders})
    label_of = {c: i for i, c in enumerate(classes)}
    rows = {}
    for split, folders in present.items():
        rows[split] = []
        for folder in folders:
            fdir = os.path.join(src, split, folder)
            for name in sorted(os.listdir(fdir)):
                if name.startswith("."):
                    continue
                rows[split].append(
                    [f"{split}/{folder}/{name}", [label_of[folder]]])
    return rows, classes


def from_index_tsv(src: str, splits=("train", "test")):
    rows = {}
    n_classes = 0
    for split in splits:
        path = os.path.join(src, f"{split}.tsv")
        if not os.path.exists(path):
            continue
        rows[split] = []
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 2:
                    continue
                labels = [int(x) for x in parts[1].split(",")]
                n_classes = max(n_classes, max(labels) + 1)
                rows[split].append([parts[0], labels])
    return rows, n_classes


def find_hub_registry(src: str) -> str | None:
    """Locate a vision_datasets registry json under a hub dump root."""
    for name in ("vision_datasets.json",
                 os.path.join("resources", "datasets", "vision_datasets.json")):
        path = os.path.join(src, name)
        if os.path.exists(path):
            return path
    return None


def from_hub(src: str, registry_path: str, task: str):
    """Convert one task of a vision_datasets hub dump.

    Registry entries carry root_folder + per-split {index_path,
    files_for_local_usage}; index rows are the hub's "iris" format:
    ``<zip>@<member> <label>`` (multiclass) or ``... <l0,l1,...>``
    (multilabel). Returns (rows, num_classes, dataset_type,
    root_folder_abs).
    """
    with open(registry_path) as f:
        registry = json.load(f)
    entries = [e for e in registry if e.get("name") == task]
    if not entries:
        names = sorted(e.get("name", "?") for e in registry)
        raise SystemExit(
            f"task {task!r} not in registry {registry_path} "
            f"(available: {', '.join(names)})")
    entry = max(entries, key=lambda e: e.get("version", 0))
    root_folder = os.path.join(src, entry.get("root_folder", ""))
    if not os.path.isdir(root_folder):
        raise SystemExit(f"hub root_folder missing on disk: {root_folder}")

    rows = {}
    for split in ("train", "val", "test"):
        info = entry.get(split)
        if not info:
            continue
        index_path = os.path.join(root_folder, info["index_path"])
        if not os.path.exists(index_path):
            raise SystemExit(f"index file missing: {index_path}")
        split_rows = []
        with open(index_path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                # Rows are "<image ref> <int[,int...]>". Validate the
                # label token instead of letting rsplit/int raise (hub
                # dumps with unlabeled prediction-only rows would crash,
                # and a filename whose last token is numeric would be
                # silently misparsed as its own label).
                parts = line.rsplit(maxsplit=1)
                if len(parts) != 2 or not all(
                        p.lstrip("-").isdigit()
                        for p in parts[1].split(",") if p):
                    raise SystemExit(
                        f"{index_path}:{lineno}: expected "
                        f"'<image> <label[,label...]>', got: {line!r} "
                        f"(unlabeled rows are not supported; drop them "
                        f"from the index or add labels)")
                img_ref, label_str = parts
                labels = [int(x) for x in label_str.split(",")]
                split_rows.append([img_ref, labels])
        want = info.get("num_images")
        if want is not None and want != len(split_rows):
            print(f"warning: {task}/{split}: registry says {want} images, "
                  f"index has {len(split_rows)}")
        rows[split] = split_rows
    n_classes = entry.get("num_classes", 0)
    if not n_classes:
        n_classes = 1 + max(l for r in rows.values() for _, ls in r for l in ls)
    return rows, n_classes, entry.get("type", "classification_multiclass"), \
        root_folder


def cli(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True, help="source dataset directory "
                   "(hub dump root, ImageFolder tree, or TSV directory)")
    p.add_argument("--task", required=True, help="ELEVATER task name")
    p.add_argument("--root", required=True, help="manifest output root")
    p.add_argument("--registry", default=None,
                   help="vision_datasets.json path (default: auto-detect "
                        "under --src)")
    p.add_argument("--multilabel", action="store_true")
    p.add_argument("--link", action="store_true",
                   help="symlink images instead of referencing src in place")
    args = p.parse_args(argv)

    registry = args.registry or find_hub_registry(args.src)
    if registry:
        rows, n_classes, dtype, root_folder = from_hub(
            args.src, registry, args.task)
        task_dir = os.path.join(args.root, args.task)
        os.makedirs(task_dir, exist_ok=True)
        rel = os.path.relpath(os.path.abspath(root_folder), task_dir)
        rows = {s: [[os.path.join(rel, p_), l] for p_, l in r]
                for s, r in rows.items()}
        manifest = {"type": dtype, "num_classes": n_classes, "splits": rows}
        out = os.path.join(task_dir, "manifest.json")
        with open(out, "w") as f:
            json.dump(manifest, f)
        print(f"wrote {out} (hub format): " + ", ".join(
            f"{s}={len(r)}" for s, r in rows.items()) +
            f", {n_classes} classes")
        return

    rows, folder_classes = from_image_folder(args.src)
    if rows:
        n_from_src = len(folder_classes)
    else:
        rows, n_from_src = from_index_tsv(args.src)
        folder_classes = None
    if not rows:
        raise SystemExit(f"no train/test ImageFolder or *.tsv found in {args.src}")

    from mvlpt_torch.data.elevater import class_map, load_metadata
    from mvlpt_torch.data.elevater.manifest import (
        MULTICLASS,
        MULTILABEL,
        _align_meta_to_folders,
    )

    n_classes, own_classnames = n_from_src, None
    known = args.task in load_metadata()
    n_meta = len(class_map(args.task)) if known else None
    if known and n_meta == n_from_src:
        n_classes = n_meta
        if folder_classes:
            # Row labels use SORTED folder order, but at load time a
            # classnames-free manifest resolves to class_map(task) in
            # metadata canonical order — every prompt would silently
            # pair with the wrong label whenever the two orders differ.
            # Align at build time and write the aligned list as the
            # manifest's authoritative classnames.
            own_classnames = _align_meta_to_folders(
                folder_classes, class_map(args.task))
    elif folder_classes:
        # Task unknown to metadata.json, or the source carries a
        # different class count (e.g. a local subset): make the manifest
        # self-describing so the loader's class-count guard doesn't bind
        # (manifest classnames are authoritative, docs/DATASETS.md).
        own_classnames = folder_classes
    elif known and n_from_src <= n_meta:
        # Known task, index-TSV source whose labels don't reach the last
        # classes (e.g. a few-shot subset): TSV labels index the task's
        # full class table, so the metadata count is the real one —
        # writing the observed max+1 would make every strict load refuse
        # on a count disagreement (data/elevater/manifest.py guard).
        print(f"note: source labels reach {n_from_src - 1} but "
              f"{args.task!r} has {n_meta} classes in metadata.json; "
              f"writing num_classes={n_meta} (TSV labels index the full "
              f"class table).")
        n_classes = n_meta
    elif known:
        # labels exceed the known task's class table: the label space
        # and the classname table genuinely disagree — a manifest built
        # from this could never load; fail at build time, with the fix.
        raise SystemExit(
            f"task {args.task!r}: source labels reach {n_from_src - 1} "
            f"but metadata.json lists only {n_meta} classes — the label "
            f"space and the classname table disagree. Rename the task "
            f"(making the manifest self-describing) or fix the source "
            f"labels.")
    elif args.task not in load_metadata():
        # Index-TSV source (no class folders to name from) for a task
        # metadata.json doesn't know: the manifest gets num_classes
        # only. Feature-extraction flows (strict_classnames=False) load
        # it as-is; prompt/label flows will refuse with instructions
        # until real classnames are added — say so NOW, at build time.
        print(f"WARNING: task {args.task!r} is not in metadata.json and "
              f"a TSV source carries no class names — wrote num_classes "
              f"only. Prompt flows need a 'classnames' list added to "
              f"{os.path.join(args.root, args.task, 'manifest.json')}; "
              f"feature extraction works as-is.")

    task_dir = os.path.join(args.root, args.task)
    os.makedirs(task_dir, exist_ok=True)
    if args.link:
        # Symlink every top-level directory the rows actually reference
        # (manifest paths resolve relative to the task dir). ImageFolder
        # rows start with the split name; index-TSV rows may reference
        # arbitrary dirs (e.g. ``images/1.jpg``) — linking only the
        # split dirs would leave those paths dangling.
        heads = {p_.split(os.sep, 1)[0].split("/", 1)[0]
                 for r in rows.values() for p_, _ in r}
        for head in sorted(heads | set(rows)):
            src_head = os.path.join(args.src, head)
            dst = os.path.join(task_dir, head)
            if os.path.isdir(src_head) and not os.path.exists(dst):
                os.symlink(os.path.abspath(src_head), dst)
        dangling = [h for h in heads
                    if not os.path.exists(os.path.join(task_dir, h))]
        if dangling:
            raise SystemExit(
                f"--link: row paths reference {sorted(dangling)} but no "
                f"matching directory exists under {args.src} to link; "
                f"rerun without --link to write relative paths instead")
    else:
        # reference images in place via relative-to-task paths
        rel = os.path.relpath(os.path.abspath(args.src), task_dir)
        rows = {s: [[os.path.join(rel, p_), l] for p_, l in r]
                for s, r in rows.items()}

    manifest = {
        "type": MULTILABEL if args.multilabel else MULTICLASS,
        "num_classes": n_classes,
        "splits": rows,
    }
    if own_classnames is not None:
        manifest["classnames"] = own_classnames
    out = os.path.join(task_dir, "manifest.json")
    with open(out, "w") as f:
        json.dump(manifest, f)
    print(f"wrote {out}: " + ", ".join(
        f"{s}={len(r)}" for s, r in rows.items()) + f", {n_classes} classes")


if __name__ == "__main__":
    cli()
