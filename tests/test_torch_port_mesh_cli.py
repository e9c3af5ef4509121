"""The port's training CLI on two ranks under TPU.MESH_DATA 2, against
the JAX CLI under the same mesh and against the port's own single-rank
CLI, fp32 on the CPU (the model axis, ``TPU.MESH_MODEL 2 TPU.MESH_DATA
1``, is tests/test_torch_port_mesh_cli_model.py, on this file's set-up).

Two spawned gloo ranks (tests/torch_port_mesh_child.py, no JAX) each call
``mvlpt_torch.cli.train.main(args, device="cpu")`` with ``TPU.MESH_DATA 2``
(the data axis: each rank decodes and trains on its 2 rows of each batch
of 4, test() gathers the logits), windows on (3 steps and a tail window of 1 an epoch), on the tiny CoOp
dataset of tests/test_torch_port_trainer.py with a 128-wide OpenAI-layout
checkpoint, warm-started from a JAX-written prompt. Meanwhile this
process runs the JAX CLI with the same TPU.MESH_* on the virtual CPU
devices and the port's CLI on one rank. They hold, as
tests/test_torch_port_trainer.py holds the single-rank CLIs: per-step
losses within 1e-4 relative, the final prompts within 1e-4 x max|leaf|,
every ``results`` value within one test sample. Besides: both ranks'
``results`` lines equal; only rank 0 wrote files under the output
directory, and its checkpoint, evaluated by the single-rank port CLI and
by the JAX CLI (--eval-only), gives its ``results``. ZeroshotCLIP on
``TPU.MESH_DATA 2`` gives the single rank's results.
"""

import ast
import json
import os
import time

import numpy as np
import pytest
import torch

from tests import test_torch_port_checkpoint as ckpt_tests
from tests import torch_port_mesh_child as child
from tests.test_torch_port_trainer import CLASSES, _argv, _close_prompts, _flat, _results, _run
from tests.torch_port_util import collect_ranks, run_rank, spawn_ranks
from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)
from tests.util_fixtures import make_coop_dataset

MESH_OPTS = {"data": ("TPU.MESH_DATA", "2"),
             "model": ("TPU.MESH_MODEL", "2", "TPU.MESH_DATA", "1")}
WINDOWS = ("TRAIN.STEPS_PER_DISPATCH", "3", "TRAIN.WINDOW_MIN_TAIL", "1")
SPAWN_TIMEOUT_S = 300
N_TEST = 3 * len(CLASSES)


def _one_sample(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in b:
        assert abs(a[k] - b[k]) <= 100.0 / N_TEST + 1e-9, (k, a, b)


@pytest.fixture(scope="module")
def world(tmp_path_factory, synthetic_vocab):  # noqa: F811
    """The dataset, a 128-wide checkpoint (two heads a tower) and the
    JAX-written initial prompt."""
    root = tmp_path_factory.mktemp("mesh_cli")
    make_coop_dataset(root / "data", classes=CLASSES, n_train=7, n_val=2, n_test=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ckpt_tests._OPENAI, "width", 128)
        sd = ckpt_tests._openai_state_dict(0)
    ckpt = root / "ViT-tiny-128.pt"
    torch.save(sd, str(ckpt))
    out = {"root": root, "data": str(root / "data"), "ckpt": str(ckpt), "vocab": synthetic_vocab}
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, out)
        trainer, _ = _run("jax", _argv(out, root / "init", "--no-train"), mp)
        trainer.save_checkpoint(best=True)
    out["init"] = str(root / "init")
    return out


def _env(mp, world):
    mp.delenv("MVLPT_TPU_RANDOM_CLIP", raising=False)
    mp.delenv("MVLPT_TPU_RANDOM_CLIP_ARCH", raising=False)
    mp.setenv("MVLPT_TPU_CLIP_CKPT", world["ckpt"])


def _train_argv(world, out, mesh):
    return _argv(world, out, "--model-dir", world["init"], "--shots", "4",
                 opts=(*WINDOWS, *MESH_OPTS[mesh]))


def _zs_argv(world, out, *opts):
    argv = _argv(world, out, opts=opts)
    argv[argv.index("MVLPT")] = "ZeroshotCLIP"
    return argv


def mesh_runs(world, mesh: str):
    """Two ranks' runs of the CLI under ``mesh`` (after the "data" run a
    ZeroshotCLIP run under ``TPU.MESH_DATA 2``, after the "model" run a
    FinetuneCLIP run), and this process's meanwhile: the JAX CLI under the
    same mesh and the port's single-rank CLI (for "data" also the
    single-rank zero-shot run, then --eval-only on rank 0's directory in
    both packages). Returns (the ranks' reports, this process's
    results)."""
    root, work = world["root"], world["root"] / f"ranks_{mesh}"
    work.mkdir()
    spec = [[mesh, _train_argv(world, root / f"{mesh}_axis", mesh), str(root / f"{mesh}_axis")]]
    if mesh == "data":
        spec.append(["zs", _zs_argv(world, root / "zs_mesh", *MESH_OPTS["data"]),
                     str(root / "zs_mesh")])
    else:
        ft = _argv(world, root / "ft_mesh", "--no-train")
        ft[ft.index("MVLPT")] = "FinetuneCLIP"
        spec.append(["ft", ft, str(root / "ft_mesh")])
    env = {"MVLPT_TPU_CLIP_CKPT": world["ckpt"]}
    procs = spawn_ranks(run_rank, 2, 2, str(work), child.cli, str(work), world["vocab"], env,
                        spec)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    here = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            _env(mp, world)
            trainer, losses = _run("jax", _train_argv(world, root / f"jax_{mesh}", mesh), mp)
            here["jax"] = (losses, _flat(trainer.state.prompt_params),
                           _results(root / f"jax_{mesh}"))
            single = root / f"single_{mesh}"
            trainer, losses = _run("port", _train_argv(world, single, "data"), mp)
            here["single"] = (losses, _flat(trainer.state.prompt_params), _results(single))
            if mesh == "data":
                _run("port", _zs_argv(world, root / "zs_single"), mp)
                here["zs_single"] = _results(root / "zs_single")
    finally:
        collect_ranks(procs, work, deadline)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    if mesh == "data":
        with pytest.MonkeyPatch.context() as mp:
            _env(mp, world)
            for package in ("port", "jax"):
                out = root / f"eval_{package}"
                _run(package, _argv(world, out, "--eval-only", "--model-dir",
                                    str(root / "data_axis")), mp)
                here[f"eval_{package}"] = _results(out)
    return ranks, here


@pytest.fixture(scope="module")
def runs(world):
    return mesh_runs(world, "data")


def _parsed(lines):
    return [ast.literal_eval(x) for x in lines]


def check_matches_jax(runs, mesh):
    """Per-step losses (two epochs of a window of 3 and a tail window of
    1), the final prompts and every results line against the JAX CLI
    under the same TPU.MESH_*."""
    ranks, here = runs
    j_losses, j_prompts, j_results = here["jax"]
    for rank in ranks:
        got = rank[mesh]
        assert "raised" not in got, got.get("raised")
        assert len(got["losses"]) == len(j_losses) == 8
        np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-4)
        _close_prompts({k: np.asarray(v, np.float32) for k, v in got["prompts"].items()},
                       j_prompts)
        assert len(got["results"]) == len(j_results) == 3  # val, val, test
        for a, b in zip(_parsed(got["results"]), j_results):
            _one_sample(a, b)


def check_matches_single(runs, mesh):
    """The same run on one rank: losses, prompts and results; and the two
    ranks print the same results lines."""
    ranks, here = runs
    s_losses, s_prompts, s_results = here["single"]
    for rank in ranks:
        got = rank[mesh]
        np.testing.assert_allclose(got["losses"], s_losses, rtol=1e-4)
        _close_prompts({k: np.asarray(v, np.float32) for k, v in got["prompts"].items()},
                       s_prompts)
        for a, b in zip(_parsed(got["results"]), s_results):
            _one_sample(a, b)
    assert ranks[0][mesh]["results"] == ranks[1][mesh]["results"]


def check_only_rank_0_writes(runs, world, mesh):
    ranks, _ = runs
    out = str(world["root"] / f"{mesh}_axis")
    assert ranks[1][mesh]["writes"] == []
    written = set(ranks[0][mesh]["writes"])
    for rel in ("log.txt", "tb/scalars.jsonl", "prompt_learner/model-best.pth.tar",
                "prompt_learner/model.pth.tar-2"):
        assert os.path.join(out, rel) in written, (rel, sorted(written))
        assert os.path.isfile(os.path.join(out, rel))


def test_mesh_cli_matches_jax_cli_on_the_same_mesh(runs):
    check_matches_jax(runs, "data")


def test_mesh_cli_matches_the_single_rank_cli(runs):
    check_matches_single(runs, "data")


def test_only_rank_0_writes(runs, world):
    check_only_rank_0_writes(runs, world, "data")


def test_rank_0_checkpoint_evaluates_to_its_results(runs):
    """--eval-only on the data-axis run's directory: the single-rank port
    CLI and the JAX CLI give rank 0's final results (its best-val prompt
    on the test split), within one test sample."""
    ranks, here = runs
    want = _parsed(ranks[0]["data"]["results"])[-1]
    for package in ("port", "jax"):
        got = here[f"eval_{package}"]
        assert len(got) == 1
        _one_sample(got[0], want)


def test_zeroshot_on_the_data_axis_matches_one_rank(runs):
    """ZeroshotCLIP under ``TPU.MESH_DATA 2``: each rank runs its rows of
    every test batch and prints the single rank's results."""
    ranks, here = runs
    for rank in ranks:
        got = _parsed(rank["zs"]["results"])
        assert got == here["zs_single"]
    assert ranks[1]["zs"]["writes"] == []
