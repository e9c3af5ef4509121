"""The linear probe through both CLIs (``mvlpt_tpu.cli.lpclip`` and
``mvlpt_torch.cli.lpclip``), on the CPU.

Both extract features from one tmp ELEVATER task (cifar-10's 10 classes,
3 train and 2 test JPEGs a class, batch 4 so the last batch is padded)
with one tiny OpenAI-layout RN checkpoint at 224 px (``MVLPT_TPU_CLIP_CKPT``),
in bf16 as both CLIs extract. Holds: the splits, labels and row order
equal; the features within the bf16 bound BF16_REL x max|ref| of the JAX
package's, each row's cosine at least BF16_COS. Then ``probe`` of both
packages on the same npz files (2 runs, 2 binary-search steps, shots 1
and 2): the summary accuracies within one test sample, and the two
report files line for line in the same format.
"""

import argparse
import os
import re

import numpy as np
import pytest
import torch

from tests.torch_port_util import openai_rn_state_dict, write_elevater_task

TASK = "cifar-10"
# Both packages round every conv, BatchNorm and attention-pool output of
# the bf16 tower to bf16 (8 bits of mantissa, 2^-9 relative); the two sum
# in different orders, so a value near a rounding boundary rounds
# differently, and such a flip moves later layers by up to 2^-8 relative.
# A tower of 11 rounding stages stays well inside 5e-2 x max|ref|, with
# each feature row's direction held to a cosine of 0.999.
BF16_REL, BF16_COS = 5e-2, 0.999
RN_TINY = dict(layers=(1, 1, 1, 1), width=8, resolution=224, embed=16)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpclip")
    write_elevater_task(root / "data", TASK, 10, seed=3, n_train=3, n_test=2)
    ckpt = root / "RN-tiny.pt"
    torch.save(openai_rn_state_dict(0, **RN_TINY), str(ckpt))
    return {"root": root, "data": str(root / "data"), "ckpt": str(ckpt)}


def _extract_args(world, out, backbone="RN50"):
    return argparse.Namespace(root=world["data"], dataset=TASK, dataset_coop=False,
                              backbone=backbone, config_file="", output_dir=str(out),
                              batch_size=4, num_workers=0, seed=1)


@pytest.fixture(scope="module")
def features(world):
    from mvlpt_tpu.cli import lpclip as j_lpclip

    from mvlpt_torch.cli import lpclip as t_lpclip

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MVLPT_TPU_RANDOM_CLIP", raising=False)
        mp.setenv("MVLPT_TPU_CLIP_CKPT", world["ckpt"])
        j_lpclip.extract_features(_extract_args(world, world["root"] / "j" / TASK))
        t_lpclip.extract_features(_extract_args(world, world["root"] / "t" / TASK), device="cpu")
    return {side: str(world["root"] / side / TASK) for side in ("j", "t")}


def _load(d, split):
    with np.load(os.path.join(d, f"{split}.npz")) as z:
        return z["feature_list"], z["label_list"]


def test_features_match_jax(features):
    splits = sorted(p for p in os.listdir(features["j"]) if p.endswith(".npz"))
    assert splits == sorted(p for p in os.listdir(features["t"]) if p.endswith(".npz"))
    assert "train.npz" in splits and "test.npz" in splits
    for split in (s[:-4] for s in splits):
        (fj, lj), (ft, lt) = _load(features["j"], split), _load(features["t"], split)
        assert ft.dtype == np.float32 and ft.shape == fj.shape and fj.shape[1] == 16
        assert np.array_equal(lt, lj), split  # labels in the same row order
        assert np.isfinite(ft).all()
        np.testing.assert_allclose(ft, fj, rtol=0, atol=BF16_REL * np.abs(fj).max(),
                                   err_msg=split)
        cos = (ft * fj).sum(1) / (np.linalg.norm(ft, axis=1) * np.linalg.norm(fj, axis=1))
        assert cos.min() >= BF16_COS, (split, cos.min())
    assert len(_load(features["t"], "test")[1]) == 10 * 2  # the padded tail cut at n_valid


def _summary(report_dir) -> list[str]:
    name = next(p for p in os.listdir(report_dir) if not p.endswith("_details.txt"))
    with open(os.path.join(report_dir, name)) as f:
        return f.read().splitlines()


def test_probe_matches_jax(features, tmp_path, capsys):
    from mvlpt_tpu.cli import lpclip as j_lpclip

    from mvlpt_torch.cli import lpclip as t_lpclip

    def args(report):
        return argparse.Namespace(feature_dir=features["t"], dataset=TASK,
                                  report_dir=str(tmp_path / report), num_step=2, num_run=2,
                                  shots=[1, 2])

    j_lpclip.probe(args("j"))
    stats = t_lpclip.probe(args("t"), device="cpu")
    # each shot: 2 runs x (7 grid points + 2 steps x 2 sides)
    assert sorted(stats) == [1, 2]
    assert all(s["fits"] == 2 * (7 + 2 * 2) and s["iterations"] > 0 for s in stats.values())
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t")) == [
        f"{TASK}_s2r2.txt", f"{TASK}_s2r2_details.txt"]
    n_test = len(_load(features["t"], "test")[1])
    pat = re.compile(rf"^{TASK}, (\d+) Shot, Test acc stat: (\d+\.\d\d) \((\d+\.\d\d)\)$")
    j_lines, t_lines = _summary(tmp_path / "j"), _summary(tmp_path / "t")
    assert len(j_lines) == len(t_lines) == 2
    for a, b in zip(t_lines, j_lines):
        ma, mb = pat.match(a), pat.match(b)
        assert ma and mb, (a, b)
        assert ma.group(1) == mb.group(1)
        assert abs(float(ma.group(2)) - float(mb.group(2))) <= 100.0 / n_test + 0.01, (a, b)
    detail = re.compile(rf"^{TASK}, seed \d, \d+ shot, weight [0-9.e+-]+, test_acc \d+\.\d\d$")
    for side in ("j", "t"):
        with open(tmp_path / side / f"{TASK}_s2r2_details.txt") as f:
            lines = f.read().splitlines()
        assert len(lines) == 4 and all(detail.match(line) for line in lines), lines
    assert "Test acc stat" in capsys.readouterr().out


def test_lpclip_cli_parses_as_the_jax_one():
    """Same subcommands, flags and defaults (RN50, batch 128, 8 steps, 10
    runs, shots 1 2 4 8 16)."""
    from mvlpt_torch.cli.lpclip import VAL_SHOTS, build_parser

    p = build_parser()
    fe = p.parse_args(["extract-features", "--root", "r", "--dataset", "d", "--output-dir", "o"])
    assert (fe.backbone, fe.batch_size, fe.num_workers, fe.seed, fe.dataset_coop) == (
        "RN50", 128, 4, 1, False)
    pr = p.parse_args(["probe", "--feature-dir", "f"])
    assert (pr.num_step, pr.num_run, pr.shots, pr.report_dir) == (8, 10, [1, 2, 4, 8, 16],
                                                                  "./report")
    assert VAL_SHOTS == {1: 1, 2: 2, 4: 4, 8: 4, 16: 4}


def test_lpclip_runs_on_the_card_unless_asked(world, tmp_path, monkeypatch):
    from mvlpt_torch.cli import lpclip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lpclip.extract_features(_extract_args(world, tmp_path / "x"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lpclip.probe(argparse.Namespace(feature_dir=str(tmp_path), dataset=TASK,
                                        report_dir=str(tmp_path), num_step=1, num_run=1,
                                        shots=[1]))
