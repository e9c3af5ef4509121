"""The port's training CLI on ELEVATER against the JAX package's, on the
CPU in fp32 (the shared set-up is tests/test_torch_port_trainer.py's: one
tiny OpenAI-layout checkpoint, the synthetic vocab, a JAX-written initial
prompt, per-step losses recorded by wrapping each package's step
factories).

- The multitask source run as scripts/mvlpt/main_mt_elevater_cut.sh runs
  it (--multi-task --multi-task-label_pertask --cut-contextlen --act-ckpt
  4, best_val, 'middle' class token, UPT), on three tasks: kitti-distance
  (multiclass, accuracy), voc-2007-classification (multilabel, 11-point
  mAP) and oxford-iiit-pets (mean-per-class), in windows of 3 with a tail
  window. Per-step losses within 1e-4 relative, prompt leaves within
  1e-4 x max|leaf|; the port's metrics fed the JAX run's per-task logits
  give the JAX run's results exactly; each result within one test
  sample's weight of the JAX run's (1e-3 for 11-point mAP).
- The single-task transfer of scripts/mvlpt/main_single_elevater_cut.sh:
  warm-started with --model-dir from the JAX multitask run.
- The zero-shot trainers of scripts/mvlpt/zeroshot.sh (--eval-only
  --no-train): ZeroshotCLIP on the CoOp dataset, ZeroshotCLIP2 on an
  ELEVATER task, accuracy within one sample.
"""

import numpy as np
import pytest

from tests.test_torch_port_trainer import (  # noqa: F401 (fixtures)
    TINY_OPTS, _close_prompts, _flat, _results, _run, env, synthetic_vocab, world)
from tests.torch_port_util import write_elevater_task

TASKS = {"kitti-distance": (4, False), "voc-2007-classification": (20, True),
         "oxford-iiit-pets": (37, False)}
MT_OPTS = ["TRAIN.STEPS_PER_DISPATCH", "3", "TRAIN.WINDOW_MIN_TAIL", "1",
           "TRAINER.MVLPT.COOP.CLASS_TOKEN_POSITION", "middle"]


@pytest.fixture(scope="module")
def elevater(world):
    root = world["root"] / "elevater"
    for seed, (task, (n_cls, multilabel)) in enumerate(TASKS.items()):
        write_elevater_task(root, task, n_cls, seed=seed + 1, n_train=2, n_test=1,
                            multilabel=multilabel)
    return str(root)


def _mt_argv(env, data, out, *extra, opts=()):
    return ["--root", data, "--output-dir", str(out), "--trainer", "MVLPT", "--multi-task",
            "--multi-task-label_pertask", "--dataset", ",".join(TASKS), "--shots", "2",
            "--seed", "1", "--cut-contextlen", "--act-ckpt", "4", *extra, *TINY_OPTS, *MT_OPTS,
            *opts]


@pytest.fixture
def mt_init(env, elevater, tmp_path, monkeypatch):
    """The JAX package's initial prompt for the multitask run."""
    trainer, _ = _run("jax", _mt_argv(env, elevater, tmp_path / "init", "--no-train"),
                      monkeypatch)
    trainer.save_checkpoint(best=True)
    return str(tmp_path / "init")


def _metric_recorder(trainer, calls: list):
    """Wraps each task's metric of a JAX trainer's manager: records
    (task, y_true, y_pred, value)."""
    for task, fn in list(trainer.dm._metric.items()):
        def rec(y_true, y_pred, _task=task, _fn=fn):
            value = _fn(y_true, y_pred)
            calls.append((_task, np.array(y_true), np.array(y_pred), value))
            return value
        trainer.dm._metric[task] = rec


def _one_sample(task: str, metric: str) -> float:
    n_cls = TASKS[task][0]
    return 1e-3 if metric == "11point_mAP" else 1.0 / n_cls + 1e-9  # one test item a class


def test_multitask_cli_matches_jax(env, elevater, mt_init, tmp_path, monkeypatch):
    from mvlpt_torch.evaluation.metrics import get_metric

    argv = ["--model-dir", mt_init]
    runs = {}
    for package in ("jax", "port"):
        calls: list = []
        trainer, losses = _run(package, _mt_argv(env, elevater, tmp_path / package, *argv),
                               monkeypatch, calls)
        runs[package] = (trainer, losses, calls)
    (jt, j_losses, j_calls), (tt, t_losses, t_calls) = runs["jax"], runs["port"]
    assert t_calls == j_calls and ("window", 3) in t_calls
    assert tt.model.remat and jt.model.remat
    assert tt.num_classes == jt.num_classes == sum(n for n, _ in TASKS.values())
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    _close_prompts(_flat(tt.state.prompt_params), _flat(jt.state.prompt_params))

    t_res, j_res = _results(tmp_path / "port"), _results(tmp_path / "jax")
    assert len(t_res) == len(j_res) == 2 * (len(TASKS) + 1) + len(TASKS) + 1  # val x 2, test
    metric_of = jt.dm._metric_name
    # each pass prints one result a task, in task order, then the average
    for (a, b), task in zip(zip(t_res, j_res), [*TASKS, "average"] * 3):
        assert a.keys() == b.keys()
        if task == "average":
            tol = sum(_one_sample(t, metric_of[t]) for t in TASKS) / len(TASKS)
        else:
            assert list(b) == [metric_of[task]]
            tol = _one_sample(task, metric_of[task])
        for k in b:
            assert abs(a[k] - b[k]) <= tol, (task, a, b)

    # the port's metrics fed the JAX run's per-task logits and targets
    # give the JAX run's per-task results exactly
    recorded: list = []
    _metric_recorder(jt, recorded)
    jt.writer = type(jt.writer)(str(tmp_path / "jax_retest"))  # train() closed the run's
    jt.test()
    assert {task for task, *_ in recorded} == set(TASKS)
    for task, y_true, y_pred, value in recorded:
        assert get_metric(metric_of[task])(y_true, y_pred) == value, task


def test_single_task_transfer_matches_jax(env, elevater, mt_init, tmp_path, monkeypatch):
    """main_single_elevater_cut.sh: one task warm-started from the
    multitask prompt (the JAX package's multitask run), one epoch."""
    _run("jax", _mt_argv(env, elevater, tmp_path / "source", "--model-dir", mt_init,
                         opts=("OPTIM.MAX_EPOCH", "1")), monkeypatch)
    runs = {p: _run(p, ["--root", elevater, "--output-dir", str(tmp_path / p), "--trainer",
                        "MVLPT", "--dataset", "oxford-iiit-pets", "--shots", "2", "--seed", "1",
                        "--cut-contextlen", "--act-ckpt", "4", "--model-dir",
                        str(tmp_path / "source"), *TINY_OPTS, *MT_OPTS, "OPTIM.MAX_EPOCH", "1"],
                    monkeypatch)
            for p in ("jax", "port")}
    (jt, j_losses), (tt, t_losses) = runs["jax"], runs["port"]
    assert len(t_losses) == len(j_losses) > 0
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    _close_prompts(_flat(tt.state.prompt_params), _flat(jt.state.prompt_params))
    t_res, j_res = _results(tmp_path / "port"), _results(tmp_path / "jax")
    assert len(t_res) == len(j_res) == 2 and list(j_res[-1]) == ["mean-per-class"]
    for a, b in zip(t_res, j_res):
        assert abs(a["mean-per-class"] - b["mean-per-class"]) <= 1 / 37 + 1e-9, (a, b)


@pytest.mark.parametrize("trainer,dataset", [("ZeroshotCLIP", "coop"),
                                             ("ZeroshotCLIP2", "voc-2007-classification"),
                                             ("ZeroshotCLIP", "oxford-iiit-pets")])
def test_zeroshot_trainers_match_jax(env, elevater, tmp_path, monkeypatch, trainer, dataset):
    if dataset == "coop":
        data = ["--root", env["data"], "--dataset-coop", "--dataset", "OxfordPets",
                "--dataset-config-file", "configs/datasets/oxford_pets.yaml"]
        n_test = 3 * 4
    else:
        data = ["--root", elevater, "--dataset", dataset]
        n_test = TASKS[dataset][0]
    res = {}
    for package in ("jax", "port"):
        out = tmp_path / package
        t, losses = _run(package, ["--trainer", trainer, *data, "--output-dir", str(out),
                                   "--eval-only", "--no-train", *TINY_OPTS,
                                   "TPU.PARAM_DTYPE", "float32"], monkeypatch)
        assert losses == [] and type(t).__name__ == trainer
        res[package] = _results(out)
    assert len(res["port"]) == len(res["jax"]) == 1
    a, b = res["port"][0], res["jax"][0]
    assert a.keys() == b.keys()
    for k in ("accuracy", "error_rate"):
        assert abs(a[k] - b[k]) <= 100.0 / n_test + 1e-9, (k, a, b)
