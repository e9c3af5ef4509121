"""Result aggregation: scrape `results {...}` lines from run logs and
report mean/std/CI95 across seed directories. The counterpart of
``mvlpt_tpu/cli/parse_test_res.py``, with the same flags, tables and CSV.

Rebuild of the reference's log-scraping harness
(scripts/parse_test_res.py:1-174 and scripts/read_record.py:50-96),
which depends on the exact `results {...}` print format our trainer
preserves (mvlpt.py:1062, 1083).

Usage:
    python -m mvlpt_torch.cli.parse_test_res <run_dir>            # one run
    python -m mvlpt_torch.cli.parse_test_res <dir> --multi-exp    # seed dirs
    python -m mvlpt_torch.cli.parse_test_res <root> --grid \\
        --datasets cifar-10,mnist --setting vit_b16_5shots/nctx16_csc_ctp \\
        --seeds 1,2,3 --out grid.csv                # dataset x seed CSV

Grid mode mirrors read_record.py:50-96's sweep artifact: one CSV with
a header row of dataset names and one row per seed, scraping
``<root>/<dataset>/<setting>/seed<seed>/log.txt*`` with missing-run
tolerance (blank cell + a "missed" note, like read_record.py:88-93 —
its plotting flows consume exactly this shape).
"""

from __future__ import annotations

import argparse
import ast
import csv
import glob as _glob
import math
import os
import re
import sys

_RESULTS_RE = re.compile(r"^results (\{.*\})\s*$")
_EVAL_RE = re.compile(r"Evaluate on the \*(\w+)\* set")


def parse_log_with_split(fpath: str) -> list[tuple[dict, str | None]]:
    """All `results {...}` dicts in a log, in order, each paired with
    the split of the most recent ``Evaluate on the *<split>* set``
    marker above it (None if the log never printed one)."""
    out: list[tuple[dict, str | None]] = []
    split = None
    with open(fpath, errors="replace") as f:
        for line in f:
            sm = _EVAL_RE.search(line)
            if sm:
                split = sm.group(1)
                continue
            m = _RESULTS_RE.match(line.strip())
            if m:
                try:
                    out.append((ast.literal_eval(m.group(1)), split))
                except (ValueError, SyntaxError):
                    pass
    return out


def parse_log(fpath: str) -> list[dict]:
    """All `results {...}` dicts in a log, in order."""
    return [r for r, _ in parse_log_with_split(fpath)]


def final_metrics(directory: str) -> dict | None:
    fpath = os.path.join(directory, "log.txt")
    if not os.path.exists(fpath):
        return None
    all_results = parse_log(fpath)
    return all_results[-1] if all_results else None


def aggregate(dirs: list[str]) -> dict:
    rows = [r for d in dirs if (r := final_metrics(d)) is not None]
    if not rows:
        return {}
    keys = set(rows[0])
    for r in rows[1:]:
        keys &= set(r)
    out = {}
    for k in sorted(keys):
        vals = [float(r[k]) for r in rows]
        n = len(vals)
        mean = sum(vals) / n
        std = math.sqrt(sum((v - mean) ** 2 for v in vals) / n) if n > 1 else 0.0
        ci95 = 1.96 * std / math.sqrt(n) if n > 1 else 0.0
        out[k] = {"mean": mean, "std": std, "ci95": ci95, "n": n}
    return out


def _pick_metric(results: dict, keyword: str | None):
    """One scalar from a results dict. With an explicit ``keyword`` the
    key must be present — NO silent fallback, or a sweep over mixed
    metric zoos would quietly blend accuracy into (say) an mAP column.
    Without one: the conventional accuracy keys, else the only key
    (read_record takes the first float on the results line — same
    outcome for the single-metric logs it scrapes)."""
    if keyword:
        return float(results[keyword]) if keyword in results else None
    for k in ("accuracy", "average"):
        if k in results:
            return float(results[k])
    if len(results) == 1:
        return float(next(iter(results.values())))
    return None


def grid_cell(root: str, dataset: str, setting: str, seed: str,
              keyword: str | None):
    """Final metric for one (dataset, seed) run, or None if the run is
    missing/unfinished — read_record.py:69-93 semantics: glob log.txt*
    so rotated/suffixed logs count, and a log only counts when its LAST
    results line came from a *test*-set eval (read_record requires
    "test" two lines above the scraped line; a crashed best_val run
    whose log ends in a per-epoch *val* results line is 'missed', not
    reported). Logs are tried newest-mtime-first — this repo's logger
    rotates the OLD run to log.txt-<ts> while Dassl timestamps the NEW
    one, so name order is ambiguous across the two conventions; when an
    older log supplies the cell, a note is printed so a superseded run
    can't slip in silently (printed only when that log gives the
    metric: a log whose results lack ``keyword`` leaves the cell missed,
    and the note would name a log the cell does not use)."""
    pattern = os.path.join(root, dataset, setting, f"seed{seed}", "log.txt*")
    log_files = sorted(_glob.glob(pattern), key=os.path.getmtime,
                       reverse=True)
    for i, log_file in enumerate(log_files):
        results = parse_log_with_split(log_file)
        if not results:
            continue
        final, split = results[-1]
        if split is not None and split != "test":
            continue  # unfinished: ended on a val (or other) eval
        # This log IS the run's newest finished test eval — the cell is
        # decided on it alone. No falling through to an older log when
        # the metric can't be extracted here (e.g. an explicit
        # --keyword absent from this run's metric zoo): that would
        # resurrect a superseded run's number.
        value = _pick_metric(final, keyword)
        if i > 0 and value is not None:
            print(f"note: {dataset} seed{seed}: newest log has no "
                  f"final test result; using older "
                  f"{os.path.basename(log_file)}", file=sys.stderr)
        return value
    return None


def grid_rows(root: str, datasets: list[str], setting: str,
              seeds: list[str], keyword: str | None = None):
    """read_record's dataset x seed sweep: header row + one row per
    seed; missing runs become blank cells (returned with the miss
    list so callers can report them)."""
    rows = [[" "] + list(datasets)]
    missed = []
    for seed in seeds:
        row = [f"seed {seed}"]
        for ds in datasets:
            val = grid_cell(root, ds, setting, seed, keyword)
            if val is None:
                row.append(" ")
                missed.append((ds, seed))
            else:
                row.append(val)
        rows.append(row)
    return rows, missed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("directory")
    p.add_argument("--multi-exp", action="store_true",
                   help="directory contains one subdir per seed/run")
    p.add_argument("--keyword", default=None,
                   help="only report this metric key")
    p.add_argument("--grid", action="store_true",
                   help="dataset x seed CSV sweep (read_record.py mode); "
                        "directory is the checkpoint root")
    p.add_argument("--datasets", default="",
                   help="grid mode: comma-separated dataset dir names")
    p.add_argument("--setting", default="",
                   help="grid mode: run subpath under each dataset, e.g. "
                        "vit_b16_5shots/nctx16_csc_ctp")
    p.add_argument("--seeds", default="1,2,3",
                   help="grid mode: comma-separated seeds")
    p.add_argument("--out", default="",
                   help="grid mode: output CSV path (default: stdout)")
    return p


def cli(argv=None):
    p = build_parser()
    args = p.parse_args(argv)

    if args.grid:
        if not args.datasets:
            p.error("--grid requires --datasets")
        datasets = [d for d in args.datasets.split(",") if d]
        seeds = [s for s in args.seeds.split(",") if s]
        rows, missed = grid_rows(args.directory, datasets, args.setting,
                                 seeds, args.keyword)
        # Diagnostics go to stderr so `--grid > grid.csv` yields a
        # clean CSV (stdout carries ONLY the rows in no---out mode).
        for ds, seed in missed:
            print("missed", ds, "seed", seed, file=sys.stderr)
        if args.out:
            with open(args.out, "w", newline="", encoding="UTF8") as f:
                csv.writer(f).writerows(rows)
            print(f"wrote {args.out}")
        else:
            for row in rows:
                print(",".join(str(c) for c in row))
        print(f"okay we missed {len(missed)} entries", file=sys.stderr)
        return

    if args.multi_exp:
        dirs = sorted(
            os.path.join(args.directory, d) for d in os.listdir(args.directory)
            if os.path.isdir(os.path.join(args.directory, d)))
    else:
        dirs = [args.directory]
    print(f"Parsing {len(dirs)} run dir(s)")
    for d in dirs:
        r = final_metrics(d)
        print(f"  {d}: {r}")
    summary = aggregate(dirs)
    print("===")
    print("Summary of directory:", args.directory)
    for k, s in summary.items():
        if args.keyword and k != args.keyword:
            continue
        print(f"* {k}: {s['mean']:.2f}% +- {s['ci95']:.2f}% "
              f"(std {s['std']:.2f}, n={s['n']})")


if __name__ == "__main__":
    cli()
