"""The post-run CLIs (``mvlpt_torch.cli.avg_ckpt``, ``export_ckpt``,
``parse_test_res``) against the JAX package's, on the same directories:
the averaged and exported checkpoints array-equal, the same printed
resolution and warnings, and equal aggregates, tables and CSV over the
logs both training CLIs write. Plus the two fixes the port's copies carry
(ADVICE.md): parse_test_res's "using older <log>" note only when that log
gives the metric, and export_ckpt's warning on an epoch-checkpoint
fallback."""

import io
import os
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from tests.test_torch_port_trainer import (  # noqa: F401 (fixtures)
    _argv, _run, env, init_dir, synthetic_vocab, world)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"coop": {"ctx": rng.randn(2, 8).astype(np.float32)},
            "vpt": {"embeddings": rng.randn(1, 2, 16).astype(np.float32),
                    "embeddings_deep": rng.randn(1, 2, 16).astype(np.float32)}}


@pytest.fixture
def seed_dirs(tmp_path):
    """Three seeds' run directories: seeds 1 and 2 with model-best.pth.tar
    (and an epoch checkpoint), seed 3 with epoch checkpoints only (a
    best_val run that never improved)."""
    from mvlpt_torch.checkpoint import prompt_io

    dirs = []
    for seed in (1, 2, 3):
        d = tmp_path / f"seed{seed}"
        tree = _tree(seed)
        for epoch in (1, 2):
            prompt_io.save_prompt_checkpoint(prompt_io.checkpoint_path(str(d), epoch), tree,
                                             epoch, 0.5 + seed)
        if seed < 3:
            prompt_io.save_prompt_checkpoint(prompt_io.checkpoint_path(str(d)), _tree(10 + seed),
                                             2, 60.0 + seed)
        dirs.append(str(d))
    return dirs


def _call(package: str, name: str, argv: list, monkeypatch) -> tuple[str, str]:
    """(stdout, stderr) of one CLI's ``cli()`` under ``argv``."""
    import importlib

    mod = importlib.import_module(f"{'mvlpt_tpu' if package == 'jax' else 'mvlpt_torch'}"
                                  f".cli.{name}")
    out, err = io.StringIO(), io.StringIO()
    with monkeypatch.context() as mp:
        mp.setattr(sys, "argv", [name, *argv])
        with redirect_stdout(out), redirect_stderr(err):
            mod.cli()
    return out.getvalue(), err.getvalue()


def _same(got: str, want: str, paths: dict):
    for a, b in paths.items():
        want = want.replace(a, b)
    assert got == want


@pytest.mark.parametrize("fmt", ["numpy", "torch"])
def test_avg_ckpt_matches_jax(seed_dirs, tmp_path, monkeypatch, fmt):
    from mvlpt_tpu.checkpoint import prompt_io as j_io

    outs = {}
    for package in ("jax", "port"):
        out_dir = str(tmp_path / f"avg_{package}")
        printed, _ = _call(package, "avg_ckpt", ["--dirs", *seed_dirs, "--output-dir", out_dir,
                                                 "--format", fmt], monkeypatch)
        outs[package] = (out_dir, printed)
    (j_dir, j_out), (t_dir, t_out) = outs["jax"], outs["port"]
    _same(t_out, j_out, {j_dir: t_dir})
    assert "WARNING: " + seed_dirs[2] + " has no model-best.pth.tar" in t_out
    path = j_io.checkpoint_path
    with open(path(t_dir), "rb") as f, open(path(j_dir), "rb") as g:
        if fmt == "numpy":
            assert f.read() == g.read()  # the same pickle, byte for byte
    want, got = (j_io.load_prompt_checkpoint(path(d)) for d in (j_dir, t_dir))
    assert got["epoch"] == want["epoch"] and got["val_result"] == want["val_result"]
    assert got["state_dict"].keys() == want["state_dict"].keys()
    for k in want["state_dict"]:
        np.testing.assert_array_equal(got["state_dict"][k], want["state_dict"][k], err_msg=k)
    # --epoch 1 averages the epoch checkpoints
    for package in ("jax", "port"):
        _call(package, "avg_ckpt", ["--dirs", *seed_dirs, "--output-dir",
                                    str(tmp_path / f"e1_{package}"), "--epoch", "1"], monkeypatch)
    with open(path(str(tmp_path / "e1_jax")), "rb") as f, \
            open(path(str(tmp_path / "e1_port")), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("source", ["dir", "file", "epoch"])
def test_export_ckpt_matches_jax(seed_dirs, tmp_path, monkeypatch, source):
    from mvlpt_torch.checkpoint import prompt_io

    src = {"dir": ["--input", seed_dirs[0]],
           "file": ["--input", prompt_io.checkpoint_path(seed_dirs[1], 2)],
           "epoch": ["--input", seed_dirs[0], "--epoch", "1"]}[source]
    for package in ("jax", "port"):
        _call(package, "export_ckpt", [*src, "--output", str(tmp_path / f"{package}.pth.tar")],
              monkeypatch)
    want, got = (torch.load(str(tmp_path / f"{p}.pth.tar"), weights_only=False)
                 for p in ("jax", "port"))
    assert got.keys() == want.keys() == {"state_dict", "epoch", "val_result"}
    assert (got["epoch"], got["val_result"]) == (want["epoch"], want["val_result"])
    assert got["state_dict"].keys() == want["state_dict"].keys()
    for k in want["state_dict"]:
        assert torch.equal(got["state_dict"][k], want["state_dict"][k]), k


def test_export_ckpt_warns_on_epoch_fallback(seed_dirs, tmp_path, monkeypatch):
    """A run directory without model-best.pth.tar exports its newest epoch
    checkpoint, with a warning (the JAX CLI prints none)."""
    out = {}
    for package in ("jax", "port"):
        out[package], _ = _call(package, "export_ckpt",
                                ["--input", seed_dirs[2], "--output",
                                 str(tmp_path / f"{package}.pth.tar")], monkeypatch)
    assert "WARNING: no model-best.pth.tar" in out["port"] and "model.pth.tar-2" in out["port"]
    assert "WARNING" not in out["jax"]
    # with model-best.pth.tar, or an explicit epoch, no warning
    for argv in (["--input", seed_dirs[0]], ["--input", seed_dirs[2], "--epoch", "2"]):
        printed, _ = _call("port", "export_ckpt", [*argv, "--output", str(tmp_path / "x.pth.tar")],
                           monkeypatch)
        assert "WARNING" not in printed


def test_parse_test_res_matches_jax_on_both_clis_logs(env, init_dir, tmp_path, monkeypatch):
    """--eval-only runs of both training CLIs for seeds 1 and 2 (a
    dataset x setting x seed tree); parse_test_res's aggregates, its
    --multi-exp table and its --grid CSV, of the JAX package and the port,
    over each package's logs and over both together."""
    from mvlpt_tpu.cli import parse_test_res as j_parse

    from mvlpt_torch.cli import parse_test_res as t_parse

    root = tmp_path / "runs"
    for package in ("jax", "port"):
        for seed in (1, 2):
            out = root / f"OxfordPets_{package}" / "setting" / f"seed{seed}"
            argv = _argv(env, out, "--eval-only", "--model-dir", init_dir)
            argv[argv.index("--seed") + 1] = str(seed)
            _run(package, argv, monkeypatch)
    for package in ("jax", "port"):
        dirs = sorted(str(p) for p in (root / f"OxfordPets_{package}" / "setting").iterdir())
        assert t_parse.aggregate(dirs) == j_parse.aggregate(dirs) != {}
        assert t_parse.final_metrics(dirs[0]) == j_parse.final_metrics(dirs[0])
        multi = [str(root / f"OxfordPets_{package}" / "setting"), "--multi-exp"]
        assert _call("port", "parse_test_res", multi, monkeypatch) == \
            _call("jax", "parse_test_res", multi, monkeypatch)
    grid = [str(root), "--grid", "--datasets", "OxfordPets_jax,OxfordPets_port,Missing",
            "--setting", "setting", "--seeds", "1,2,3"]
    outs = {p: _call(p, "parse_test_res", grid, monkeypatch) for p in ("jax", "port")}
    assert outs["port"] == outs["jax"]
    assert "missed Missing seed 1" in outs["port"][1]
    for package in ("jax", "port"):
        csv_path = tmp_path / f"{package}.csv"
        _call(package, "parse_test_res", [*grid, "--out", str(csv_path)], monkeypatch)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()


def test_parse_test_res_older_log_note_only_when_used(tmp_path, capsys):
    """The newest log ended on a val pass, so the cell comes from an older
    log; the note names that log only when it gives the metric asked for
    (the JAX package prints it either way)."""
    from mvlpt_tpu.cli import parse_test_res as j_parse

    from mvlpt_torch.cli import parse_test_res as t_parse

    run = tmp_path / "ds" / "setting" / "seed1"
    run.mkdir(parents=True)
    (run / "log.txt-old").write_text("Evaluate on the *test* set\nresults {'accuracy': 71.5}\n")
    os.utime(run / "log.txt-old", (1, 1))
    (run / "log.txt").write_text("Evaluate on the *val* set\nresults {'accuracy': 60.0}\n")
    for keyword, value, note in (("accuracy", 71.5, True), ("macro_f1", None, False)):
        for mod, prints in ((t_parse, note), (j_parse, True)):
            capsys.readouterr()
            assert mod.grid_cell(str(tmp_path), "ds", "setting", "1", keyword) == value
            assert ("using older log.txt-old" in capsys.readouterr().err) is prints
