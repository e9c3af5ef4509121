"""The port's training CLI (``mvlpt_torch.cli.train``) against the JAX
package's (``mvlpt_tpu.cli.train``) on the CPU, in fp32.

Both runs share a tmp CoOp dataset, one tiny random OpenAI-layout
state_dict (``torch.save``, read by both through MVLPT_TPU_CLIP_CKPT), the
synthetic vocab, and the initial prompt: the JAX package writes it and
both warm-start from it with --model-dir. They hold: per-step losses
within 1e-4 relative, the final prompt leaves within 1e-4 x max|leaf|,
every ``results`` value within one test sample, and checkpoints that each
package loads from the other. Also: the windowed epoch (a tail window, a
short tail a step a call, a window clamped to the epoch), resume (from
either package's checkpoint), eval-only, the last_step checkpoint's
val_result, the load_model fallback warning, and Queue 3 item 4's
once-folded stem (bit-equal logits)."""

import ast
import os
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_checkpoint import _openai_state_dict
from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)
from tests.util_fixtures import make_coop_dataset

TINY_OPTS = [
    "OPTIM.MAX_EPOCH", "2", "OPTIM.LR", "0.05", "OPTIM.WARMUP_EPOCH", "0",
    "OPTIM.LR_SCHEDULER", "cosine",
    "DATALOADER.TRAIN_X.BATCH_SIZE", "4", "DATALOADER.TEST.BATCH_SIZE", "4",
    "DATALOADER.NUM_WORKERS", "0",
    "INPUT.SIZE", "(32, 32)",
    "INPUT.TRANSFORMS", "('random_resized_crop', 'random_flip', 'normalize')",
    "TRAINER.MVLPT.COOP.N_CTX", "2", "TRAINER.MVLPT.VPT.N_CTX", "2",
    "TRAINER.MVLPT.PROJECT_DIM", "8",
    "TEST.FINAL_MODEL", "best_val",
    "TRAIN.PRINT_FREQ", "1",
    "TRAINER.MVLPT.PREC", "fp32",
]
CLASSES = ("abyssinian", "beagle", "boxer", "pug")


class _Recorder:
    """Wraps a package's step factory: every step it makes appends its
    per-step losses (a window's K of them) to ``losses``, and the number
    of steps of each call, tagged with ``tag``, to ``calls``."""

    def __init__(self, make, losses: list, calls: list, tag: str):
        self.make, self.losses, self.calls, self.tag = make, losses, calls, tag

    def __call__(self, *args, **kw):
        step = self.make(*args, **kw)

        def call(*a, **k):
            state, metrics = step(*a, **k)
            loss = np.asarray(metrics["loss"].detach() if isinstance(metrics["loss"], torch.Tensor)
                              else metrics["loss"]).reshape(-1)
            self.losses.extend(float(x) for x in loss)
            self.calls.append((self.tag, len(loss)))
            return state, metrics
        return call


def _run(package: str, argv: list, monkeypatch, calls: list | None = None):
    """(trainer, per-step losses) of one CLI run of ``package`` ('jax' or
    'port'), in fp32 on the CPU; ``calls`` gets each step call's kind
    ('step' or 'window') and number of steps."""
    losses: list = []
    calls = [] if calls is None else calls
    saved = sys.stdout
    with monkeypatch.context() as mp:
        if package == "jax":
            from mvlpt_tpu.cli import train as cli
            from mvlpt_tpu.train import train_step as j_steps
            from mvlpt_tpu.train import trainer as j_trainer

            mp.setattr(j_trainer, "make_train_step",
                       _Recorder(j_trainer.make_train_step, losses, calls, "step"))
            mp.setattr(j_steps, "make_train_step_multi",
                       _Recorder(j_steps.make_train_step_multi, losses, calls, "window"))
            run = lambda args: cli.main(args)  # noqa: E731
        else:
            from mvlpt_torch.cli import train as cli
            from mvlpt_torch.train import trainer as t_trainer

            for name, tag in (("make_train_step", "step"), ("make_train_step_multi", "window")):
                mp.setattr(t_trainer, name, _Recorder(getattr(t_trainer, name), losses, calls,
                                                      tag))
            run = lambda args: cli.main(args, device="cpu")  # noqa: E731
        try:
            trainer = run(cli.build_parser().parse_args(argv))
        finally:
            sys.stdout = saved  # both loggers tee stdout into log.txt
    return trainer, losses


def _results(out_dir) -> list[dict]:
    with open(os.path.join(out_dir, "log.txt")) as f:
        return [ast.literal_eval(line[len("results "):]) for line in f
                if line.startswith("results ")]


def _flat(tree) -> dict:
    from mvlpt_torch.checkpoint import flatten_params

    return flatten_params(jax.tree_util.tree_map(np.asarray, tree)
                          if not _is_torch(tree) else tree)


def _is_torch(tree) -> bool:
    return isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor)


def _close_prompts(a: dict, b: dict, rel: float = 1e-4):
    assert a.keys() == b.keys()
    for k in a:
        scale = max(np.abs(a[k]).max(), 1e-12)
        np.testing.assert_allclose(a[k], b[k], atol=rel * scale, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def world(tmp_path_factory, synthetic_vocab):  # noqa: F811
    """The dataset, the CLIP checkpoint and the JAX-written initial prompt."""
    root = tmp_path_factory.mktemp("trainer_cli")
    make_coop_dataset(root / "data", classes=CLASSES, n_train=7, n_val=2, n_test=3)
    ckpt = root / "ViT-tiny.pt"
    torch.save(_openai_state_dict(0), str(ckpt))
    return {"root": root, "data": str(root / "data"), "ckpt": str(ckpt)}


@pytest.fixture
def env(world, monkeypatch):
    monkeypatch.delenv("MVLPT_TPU_RANDOM_CLIP", raising=False)
    monkeypatch.delenv("MVLPT_TPU_RANDOM_CLIP_ARCH", raising=False)
    monkeypatch.setenv("MVLPT_TPU_CLIP_CKPT", world["ckpt"])
    return world


def _argv(world, out, *extra, opts=()):
    return ["--root", world["data"], "--output-dir", str(out), "--trainer", "MVLPT",
            "--dataset-coop", "--dataset", "OxfordPets", "--seed", "1", "--cut-contextlen",
            *extra, *TINY_OPTS, *opts]


@pytest.fixture
def init_dir(env, tmp_path, monkeypatch):
    """The JAX package's initial prompt for this dataset, as model-best.pth.tar."""
    trainer, _ = _run("jax", _argv(env, tmp_path / "init", "--no-train"), monkeypatch)
    trainer.save_checkpoint(best=True)
    return str(tmp_path / "init")


def test_cli_matches_jax(env, init_dir, tmp_path, monkeypatch):
    """Two epochs, one step a batch, warm-started from the same prompt,
    best-val selection and the final test; then each package loads the
    other's checkpoints."""
    argv = ["--model-dir", init_dir, "--shots", "4"]
    jt, j_losses = _run("jax", _argv(env, tmp_path / "jax", *argv), monkeypatch)
    tt, t_losses = _run("port", _argv(env, tmp_path / "port", *argv), monkeypatch)
    assert len(t_losses) == len(j_losses) == 2 * 4  # 16 images / batch 4, two epochs
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    _close_prompts(_flat(tt.state.prompt_params), _flat(jt.state.prompt_params))

    t_res, j_res = _results(tmp_path / "port"), _results(tmp_path / "jax")
    assert len(t_res) == len(j_res) == 3  # val, val, test
    n_test = 3 * len(CLASSES)
    for a, b in zip(t_res, j_res):
        assert a.keys() == b.keys()
        for k in b:
            assert abs(a[k] - b[k]) <= 100.0 / min(n_test, 2 * len(CLASSES)) + 1e-9, (k, a, b)
    for name in ("model-best.pth.tar", "model.pth.tar-2"):
        assert os.path.isfile(tmp_path / "port" / "prompt_learner" / name)

    # cross-load: the port loads the JAX run's checkpoint and the JAX
    # package the port's, each to the other's leaves exactly
    from mvlpt_tpu.checkpoint import prompt_io as j_io

    from mvlpt_torch.checkpoint import prompt_io as t_io

    for src, loader in (("jax", tt), ("port", jt)):
        loader.load_model(str(tmp_path / src), epoch=2)
        want = t_io.load_prompt_checkpoint(
            t_io.checkpoint_path(str(tmp_path / src), 2))["state_dict"]
        got = _flat(loader.state.prompt_params)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{src}: {k}")
    assert j_io.load_prompt_checkpoint(
        j_io.checkpoint_path(str(tmp_path / "port"), 2))["epoch"] == 2


def test_eval_only_matches_jax(env, init_dir, tmp_path, monkeypatch, capsys):
    """--eval-only from a run directory, in both packages; the port warns
    when it falls back to an epoch checkpoint (no model-best.pth.tar)."""
    jt, _ = _run("jax", _argv(env, tmp_path / "j", "--eval-only", "--model-dir", init_dir),
                 monkeypatch)
    tt, losses = _run("port", _argv(env, tmp_path / "t", "--eval-only", "--model-dir", init_dir),
                      monkeypatch)
    assert losses == []
    for a, b in zip(_results(tmp_path / "t"), _results(tmp_path / "j")):
        for k in b:
            assert abs(a[k] - b[k]) <= 100.0 / (3 * len(CLASSES)) + 1e-9, (k, a, b)

    epoch_only = tmp_path / "epoch_only" / "prompt_learner"
    epoch_only.mkdir(parents=True)
    os.replace(os.path.join(init_dir, "prompt_learner", "model-best.pth.tar"),
               epoch_only / "model.pth.tar-3")
    capsys.readouterr()
    _run("port", _argv(env, tmp_path / "t2", "--eval-only", "--model-dir",
                       str(tmp_path / "epoch_only")), monkeypatch)
    assert "WARNING: no model-best.pth.tar" in capsys.readouterr().out


def test_last_step_checkpoint_val_result_is_none(env, tmp_path, monkeypatch):
    from mvlpt_torch.checkpoint import prompt_io

    trainer, _ = _run("port", _argv(env, tmp_path / "ls", "--shots", "2",
                                    opts=("TEST.FINAL_MODEL", "last_step", "OPTIM.MAX_EPOCH",
                                          "1")), monkeypatch)
    payload = prompt_io.load_prompt_checkpoint(
        prompt_io.checkpoint_path(str(tmp_path / "ls"), 1))
    assert payload["val_result"] is None and payload["step"] == trainer.steps_per_epoch
    assert set(payload["momentum"]) == set(_flat(trainer.state.prompt_params))
    assert not os.path.exists(prompt_io.checkpoint_path(str(tmp_path / "ls")))


def test_trainers_the_port_lacks_raise(env, tmp_path, monkeypatch):
    from mvlpt_torch.cli.train import build_parser, main

    for name, item in (("FinetuneCLIP", "item 10"),):
        argv = _argv(env, tmp_path / name)
        argv[argv.index("MVLPT")] = name
        with pytest.raises(NotImplementedError, match=item):
            main(build_parser().parse_args(argv), device="cpu")
    monkeypatch.setattr(sys, "stdout", sys.stdout)


@pytest.mark.parametrize("path", ["train", "cached_text_eval", "zeroshot"])
def test_folded_stem_once_is_bit_equal(synthetic_vocab, path, monkeypatch):  # noqa: F811
    """Queue 3 item 4: the stem's folded normalisation is made once for
    each backbone (``vit.FoldedStems``); the logits equal, bit for bit,
    those of folding it on every call (the code before the repair)."""
    from mvlpt_torch.core import vit
    from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
    from mvlpt_torch.models.zsclip import make_zs_infer
    from mvlpt_torch.train import init_train_state, make_cached_text_eval, make_train_step
    from mvlpt_torch.config import optim_config
    from tests.torch_port_util import two_sides

    sides = two_sides(5)
    model, backbone, pp, consts = sides["t"]
    norm = (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)),
             "label": torch.from_numpy(rng.randint(0, 5, 3))}

    zs_text = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(5, model.clip_cfg.embed_dim).astype(np.float32)), dim=-1)

    def outputs():
        if path == "train":
            state = init_train_state(pp, optim_config(), 1)
            step = make_train_step(model, normalize=norm)
            return [step(state, backbone, consts, batch)[1]["loss"] for _ in range(2)]
        if path == "cached_text_eval":
            text_fn, eval_fn = make_cached_text_eval(model, normalize=norm)
            text = text_fn(backbone, pp, consts)
            return [eval_fn(backbone, pp, text, batch) for _ in range(2)]
        infer = make_zs_infer(model.clip_cfg, *norm)
        return [infer(backbone, zs_text, batch["image"]) for _ in range(2)]

    cached = outputs()
    folds = []
    with monkeypatch.context() as mp:
        mp.setattr(vit.FoldedStems, "get",
                   lambda self, kernel, p, n: folds.append(1) or vit.fold_normalize(kernel, p, n))
        every_call = outputs()
    assert len(folds) >= 2  # the old path folds on every call
    for a, b in zip(cached, every_call):
        assert torch.equal(a, b)
    stems = vit.FoldedStems()
    kernel = backbone["visual"]["patch_embed"]["kernel"]
    first = stems.get(kernel, 8, norm)
    assert stems.get(kernel, 8, norm) is first
