"""Few-shot accuracy curve plots — full rebuild of the reference's
``scripts/draw_curves.py`` (1-233).

Reference semantics reproduced:
  * reads the released results spreadsheet (``Results.xlsx``, sheet
    ``imcls_fewshot``) whose per-dataset columns hold, by row index:
    0 zero-shot; 2:7 CoOp end; 7:12 CoOp mid; 12:17 CoOp end+CSC;
    17:22 CoOp mid+CSC; 22:27 linear probe — one value per shot in
    (1, 2, 4, 8, 16) (scripts/draw_curves.py:44-60);
  * one figure per dataset plus an ``average.pdf`` over all datasets
    (scripts/draw_curves.py:81-148, 151-233): grey plot face, white
    x-grid and zero-shot hline, star marker + "Zero-shot CLIP" text at
    x=0, per-method colors/labels, 5% y-padding, lower-right legend.

The counterpart of ``mvlpt_tpu/cli/draw_curves.py``, with the same flags,
readers and figures. No pandas/openpyxl dependency: .xlsx is a zip of
XML and the tiny reader below covers the numeric/shared-string cells the
results sheet uses. A ``--csv`` mode (method,dataset,shots,accuracy
rows) is kept for spreadsheet-free pipelines. matplotlib is imported
when a figure is drawn, never at import, so the readers run on a host
without it; drawing there raises an ImportError that names it.
"""

from __future__ import annotations

import argparse
import os
import re
import xml.etree.ElementTree as ET
import zipfile

SHOTS = [1, 2, 4, 8, 16]

# method key -> (row slice in the sheet, matplotlib color, legend label,
# linestyle); colors/labels match scripts/draw_curves.py:22-29,104-140
METHODS = {
    "ours_v16_end": (slice(2, 7), "C0", "CLIP + CoOp ($M\\!=\\!16$, end)", "-"),
    "ours_v16_mid": (slice(7, 12), "C2", "CLIP + CoOp ($M\\!=\\!16$, mid)", "-"),
    "ours_v16_end_csc": (slice(12, 17), "C1",
                         "CLIP + CoOp ($M\\!=\\!16$, end, CSC)", "-"),
    "ours_v16_mid_csc": (slice(17, 22), "C3",
                         "CLIP + CoOp ($M\\!=\\!16$, mid, CSC)", "-"),
    "linear": (slice(22, 27), "C4", "Linear probe CLIP", "dotted"),
}
ZS_COLOR = "C4"
MS = 3

DEFAULT_DATASETS = [
    "OxfordPets", "Flowers102", "FGVCAircraft", "DTD",
    "EuroSAT", "StanfordCars", "Food101", "SUN397",
    "Caltech101", "UCF101", "ImageNet",
]

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}


def _col_to_idx(ref: str) -> int:
    """'B7' -> column index 1."""
    letters = re.match(r"[A-Z]+", ref).group(0)
    idx = 0
    for ch in letters:
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def read_xlsx_sheet(path: str, sheet_name: str) -> dict[str, list]:
    """Minimal .xlsx sheet reader: {header -> column values (list)}.

    Covers what the results workbook needs — shared strings, inline
    numbers, sparse cells (missing cells become None). First row is the
    header row, like ``pandas.read_excel(header=0)``."""
    with zipfile.ZipFile(path) as z:
        wb = ET.fromstring(z.read("xl/workbook.xml"))
        rels = ET.fromstring(z.read("xl/_rels/workbook.xml.rels"))
        rel_ns = {"r": "http://schemas.openxmlformats.org/package/2006/relationships"}
        rid_to_target = {
            rel.get("Id"): rel.get("Target")
            for rel in rels.findall("r:Relationship", rel_ns)}
        sheet_target = None
        for sh in wb.find("m:sheets", _NS):
            if sh.get("name") == sheet_name:
                rid = sh.get("{http://schemas.openxmlformats.org/"
                             "officeDocument/2006/relationships}id")
                sheet_target = rid_to_target[rid]
        if sheet_target is None:
            names = [sh.get("name") for sh in wb.find("m:sheets", _NS)]
            raise SystemExit(
                f"sheet {sheet_name!r} not in {path} (has: {names})")
        # Absolute OPC targets ("/xl/worksheets/sheet1.xml") are legal:
        # strip the leading slash BEFORE testing the prefix, else the
        # "xl/" prefix gets doubled.
        sheet_target = sheet_target.lstrip("/")
        if not sheet_target.startswith("xl/"):
            sheet_target = "xl/" + sheet_target

        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            ss = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in ss.findall("m:si", _NS):
                shared.append("".join(t.text or "" for t in si.iter(
                    "{%s}t" % _NS["m"])))

        sheet = ET.fromstring(z.read(sheet_target))
        # Index rows by their 1-based ``r`` attribute, not XML document
        # order: Excel omits <row> elements for blank rows, and the
        # reference layout (scripts/draw_curves.py row slices) depends
        # on blank separator rows keeping their positions.
        rows: list[dict[int, object]] = []
        for row in sheet.iter("{%s}row" % _NS["m"]):
            r_attr = row.get("r")
            row_idx = int(r_attr) - 1 if r_attr else len(rows)
            while len(rows) <= row_idx:
                rows.append({})
            cells: dict[int, object] = {}
            for c in row.findall("m:c", _NS):
                v = c.find("m:v", _NS)
                if v is None or v.text is None:
                    continue
                if c.get("t") == "s":
                    val: object = shared[int(v.text)]
                elif c.get("t") == "str":
                    val = v.text
                else:
                    try:
                        val = float(v.text)
                    except ValueError:
                        val = v.text
                cells[_col_to_idx(c.get("r"))] = val
            rows[row_idx] = cells

    if not rows:
        return {}
    header_cells = rows[0]
    n_cols = max(header_cells) + 1 if header_cells else 0
    out: dict[str, list] = {}
    for col in range(n_cols):
        name = header_cells.get(col)
        if name is None:
            continue
        out[str(name)] = [r.get(col) for r in rows[1:]]
    return out


def _style_axes(ax, zs, val_bot, val_top, title, title_bold=False):
    ax.set_facecolor("#EBEBEB")
    ax.set_xticks([0] + SHOTS)
    ax.set_xticklabels([0] + SHOTS)
    ax.set_xlabel("Number of labeled training examples per class")
    ax.set_ylabel("Score (%)")
    ax.grid(axis="x", color="white", linewidth=1)
    ax.axhline(zs, color="white", linewidth=1)
    ax.set_title(title, fontweight="bold" if title_bold else "normal")
    ax.set_ylim(val_bot, val_top)


def _plot_one(plt, zs: float, curves: dict[str, list[float]], title: str,
              out_path: str, title_bold: bool = False):
    """One dataset (or average) figure, reference styling."""
    values = [zs] + [v for c in curves.values() for v in c]
    val_min, val_max = min(values), max(values)
    diff = val_max - val_min
    fig, ax = plt.subplots()
    _style_axes(ax, zs, val_min - diff * 0.05, val_max + diff * 0.05,
                title, title_bold)
    ax.plot(0, zs, marker="*", markersize=MS * 1.5, color=ZS_COLOR)
    for key, (_, color, label, ls) in METHODS.items():
        if key not in curves:
            continue
        ax.plot(SHOTS, curves[key], marker="o", markersize=MS, color=color,
                label=label, linestyle=ls)
    ax.text(-0.5, zs - diff * 0.11, "Zero-shot\nCLIP", color=ZS_COLOR)
    ax.legend(loc="lower right")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out_path}")


def draw_from_sheet(path: str, sheet_name: str, save_dir: str,
                    datasets: list[str] | None = None,
                    fmt: str = "pdf") -> None:
    """Reference mode: released results workbook -> per-dataset figures
    + average figure (scripts/draw_curves.py:1-233)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update({"font.size": 12})
    columns = read_xlsx_sheet(path, sheet_name)
    if datasets is None:
        datasets = [d for d in DEFAULT_DATASETS if d in columns]
        if not datasets:  # arbitrary workbooks: every numeric column
            datasets = [k for k, v in columns.items()
                        if v and isinstance(v[0], float)]
    if not datasets:
        raise SystemExit(
            f"no dataset columns found in sheet {sheet_name!r} of {path} "
            f"(looked for {DEFAULT_DATASETS[:3]}... and numeric columns); "
            f"available columns: {sorted(columns)[:12]}")
    os.makedirs(save_dir, exist_ok=True)

    import numpy as np

    def _cell(v):
        # blank cells read as None; the reference (pandas read_excel)
        # yields NaN there and still plots — match that.
        return float("nan") if v is None else float(v)

    avg_zs = 0.0
    avg = {k: np.zeros(len(SHOTS)) for k in METHODS}
    for dataset in datasets:
        print(f"Processing {dataset} ...")
        col = columns[dataset]
        zs = _cell(col[0])
        curves = {}
        for key, (rows, *_rest) in METHODS.items():
            vals = [_cell(v) for v in col[rows]]
            if len(vals) != len(SHOTS):
                raise SystemExit(
                    f"{dataset}: rows {rows} hold {len(vals)} values, "
                    f"need {len(SHOTS)} (one per shot)")
            curves[key] = vals
            avg[key] += np.asarray(vals)
        avg_zs += zs
        _plot_one(plt, zs, curves, dataset,
                  os.path.join(save_dir, f"{dataset}.{fmt}"))

    n = len(datasets)
    _plot_one(plt, avg_zs / n, {k: list(v / n) for k, v in avg.items()},
              f"Average over {n} datasets",
              os.path.join(save_dir, f"average.{fmt}"), title_bold=True)


def draw_from_csv(csv_path: str, save_dir: str) -> None:
    """CSV mode (method,dataset,shots,accuracy): free-form methods, one
    log-x curve figure per dataset."""
    import csv
    from collections import defaultdict

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = list(csv.DictReader(open(csv_path)))
    by_dataset: dict = defaultdict(lambda: defaultdict(list))
    for r in rows:
        by_dataset[r["dataset"]][r["method"]].append(
            (int(r["shots"]), float(r["accuracy"])))

    os.makedirs(save_dir, exist_ok=True)
    for dataset, methods in by_dataset.items():
        fig, ax = plt.subplots(figsize=(4, 3))
        for method, pts in sorted(methods.items()):
            pts.sort()
            ax.plot([s for s, _ in pts], [a for _, a in pts],
                    marker="o", label=method)
        ax.set_xscale("log", base=2)
        ax.set_xlabel("shots per class")
        ax.set_ylabel("accuracy (%)")
        ax.set_title(dataset)
        ax.legend(fontsize=7)
        fig.tight_layout()
        out = os.path.join(save_dir, f"{dataset}_curve.png")
        fig.savefig(out, dpi=150)
        plt.close(fig)
        print(f"wrote {out}")


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--xlsx", help="results workbook (reference layout: "
                     "Results.xlsx)")
    src.add_argument("--csv",
                     help="csv with columns: method,dataset,shots,accuracy")
    p.add_argument("--sheet", default="imcls_fewshot",
                   help="worksheet name (reference: imcls_fewshot)")
    p.add_argument("--datasets", default=None,
                   help="comma-separated dataset columns (default: the "
                   "11 reference datasets present in the sheet)")
    p.add_argument("--output-dir", default="main_curves")
    p.add_argument("--format", default="pdf", choices=("pdf", "png"))
    args = p.parse_args(argv)

    if args.xlsx:
        datasets = args.datasets.split(",") if args.datasets else None
        draw_from_sheet(args.xlsx, args.sheet, args.output_dir, datasets,
                        args.format)
    else:
        draw_from_csv(args.csv, args.output_dir)


if __name__ == "__main__":
    cli()
