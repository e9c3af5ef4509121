"""FinetuneCLIP (``mvlpt_torch.train.finetune``) against the JAX package's
(``mvlpt_tpu.train.finetune``), fp32 on the CPU.

A tiny ViT (width 64, 2 layers, 32 px) and a head, carried from the JAX
tree by ``checkpoint.finetune_params_from_jax``: ``FinetuneModel`` logits
1e-4 and grads 1e-4 x max|grad|; three steps of each optimizer, with and
without STAGED_LR, params 1e-5 x max|param|. Both training CLIs on one
tiny ELEVATER task (the shared set-up of tests/test_torch_port_trainer.py:
one OpenAI-layout checkpoint, the synthetic vocab): per-step losses 1e-4
relative, results within one test sample, checkpoints that each package
loads from the other, the windowed-dispatch message; an RN backbone
raises the JAX package's ValueError."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_trainer import (  # noqa: F401 (fixtures)
    TINY_OPTS, _flat, _results, env, synthetic_vocab, world)
from tests.torch_port_util import TINY_DIMS, write_elevater_task

NORM = ((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711))
N_CLS = 5
TASK, TASK_CLASSES = "cifar-10", 10


def _trees(seed=0):
    """The JAX FinetuneCLIP tree (the tiny ViT tower in fp32 and a head
    drawn as the JAX trainer draws it) and the port's, carried across."""
    from mvlpt_tpu.core.clip import CLIPConfig as JCfg, init_clip_params

    from mvlpt_torch.checkpoint import finetune_params_from_jax

    visual = init_clip_params(jax.random.PRNGKey(seed), JCfg(**TINY_DIMS))["visual"]
    j_params = {"visual": jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), visual),
                "head": {"kernel": jax.random.normal(jax.random.PRNGKey(seed + 1),
                                                     (TINY_DIMS["embed_dim"], N_CLS)) * 0.01,
                         "bias": jnp.zeros((N_CLS,))}}
    t_params = finetune_params_from_jax(jax.tree_util.tree_map(np.asarray, j_params), "cpu")
    return j_params, t_params


def _models():
    from mvlpt_tpu.core.clip import CLIPConfig as JCfg
    from mvlpt_tpu.train.finetune import FinetuneModel as JModel

    from mvlpt_torch.core.clip import CLIPConfig
    from mvlpt_torch.train.finetune import FinetuneModel

    return (JModel(JCfg(**TINY_DIMS), compute_dtype=jnp.float32, normalize=NORM),
            FinetuneModel(CLIPConfig(**TINY_DIMS), compute_dtype=torch.float32, normalize=NORM))


def _batch(seed, uint8):
    rng = np.random.RandomState(seed)
    image = (rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8) if uint8
             else rng.randn(4, 32, 32, 3).astype(np.float32))
    return {"image": image, "label": rng.randint(0, N_CLS, 4)}


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12), err_msg=what)


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8-normalize"])
def test_model_logits_and_grads_match_jax(uint8):
    from mvlpt_tpu.train.train_step import soft_cross_entropy as j_ce

    from mvlpt_torch.train import soft_cross_entropy
    from mvlpt_torch.utils.tree import tree_leaves, tree_map

    j_params, t_params = _trees()
    j_model, t_model = _models()
    batch = _batch(0, uint8)

    def j_loss(p):
        logits = j_model({}, p, None, jnp.asarray(batch["image"]))
        return j_ce(logits, jnp.asarray(batch["label"])), logits

    (_, j_logits), j_grads = jax.value_and_grad(j_loss, has_aux=True)(j_params)
    params = tree_map(lambda t: t.requires_grad_(True), t_params)
    logits = t_model({}, params, None, torch.from_numpy(batch["image"]))
    grads = torch.autograd.grad(soft_cross_entropy(logits, torch.from_numpy(batch["label"])),
                                tree_leaves(params))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), atol=1e-4)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(j_grads)):
        _close(g.numpy(), jg, 1e-4)
    assert len(grads) == len(jax.tree_util.tree_leaves(j_grads))


@pytest.mark.parametrize("staged", [False, True], ids=["one-lr", "staged-lr"])
@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "rmsprop"])
def test_three_steps_match_jax(name, staged):
    """Three steps (two an epoch, one warmup epoch) from the same tree:
    every parameter within 1e-5 x its leaf's max|param|, and the metrics.

    Adam and AdamW divide each gradient by its own running magnitude, so
    an element whose gradient is small takes a step of O(lr) whatever its
    size, and the two packages' fp32 rounding of that gradient moves the
    step by lr x (rounding / |g|): the attention key biases' gradient is
    exactly 0 (softmax ignores a shift shared by a row's keys), so their
    steps' signs are the residue's, and on a leaf near 0 (a bias at
    init) a 1e-4 relative error of the step exceeds 1e-5 x max|param|.
    Under Adam the elements whose JAX gradient falls below 1e-4 x its
    leaf's max at some step are held to the steps' bound instead, |port -
    JAX| <= 2 x the sum of the steps' lrs, and every other element to 1e-5
    x max|param|; no more than 2% of the elements may be such."""
    import optax

    from mvlpt_tpu.config import get_cfg_default as j_defaults
    from mvlpt_tpu.train.finetune import build_finetune_optimizer as j_build
    from mvlpt_tpu.train.train_step import accuracy as j_acc, soft_cross_entropy as j_ce

    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train.finetune import build_finetune_optimizer, make_finetune_step
    from mvlpt_torch.utils.tree import tree_leaves

    opts = dict(NAME=name, LR=0.01, MAX_EPOCH=3, WARMUP_EPOCH=1, WARMUP_TYPE="constant",
                WARMUP_CONS_LR=1e-3, WEIGHT_DECAY=1e-3, STAGED_LR=staged, BASE_LR_MULT=0.1)
    ocfg = optim_config(**opts)
    jcfg = j_defaults().OPTIM
    for key, value in ocfg.items():
        setattr(jcfg, key, value)
    j_params, t_params = _trees(2)
    j_model, t_model = _models()
    tx, schedule = j_build(jcfg, 2)
    j_state = tx.init(j_params)
    state, _ = build_finetune_optimizer(t_params, ocfg, 2)
    step = make_finetune_step(t_model)

    @jax.jit
    def j_step(p, s, image, label):
        def loss_fn(p):
            logits = j_model({}, p, None, image)
            return j_ce(logits, label), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, j_acc(logits, label), grads

    residue = None
    for i in range(3):
        batch = _batch(10 + i, uint8=i == 1)
        j_params, j_state, j_loss, j_a, j_g = j_step(
            j_params, j_state, jnp.asarray(batch["image"]), jnp.asarray(batch["label"]))
        small = [np.abs(np.asarray(g)) < 1e-4 * np.abs(np.asarray(g)).max()
                 for g in jax.tree_util.tree_leaves(j_g)]
        residue = small if residue is None else [a | b for a, b in zip(residue, small)]
        _, m = step(state, {}, None, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(j_loss), rtol=1e-5)
        assert m["acc"].item() == pytest.approx(float(j_a))
    adam = name in ("adam", "adamw")
    steps_bound = 2 * sum(float(schedule(i)) for i in range(3))
    if adam:
        assert sum(int(r.sum()) for r in residue) <= 0.02 * sum(r.size for r in residue)
    for got, want, res in zip(tree_leaves(state.prompt_params),
                              jax.tree_util.tree_leaves(j_params), residue):
        got, want = got.detach().numpy(), np.asarray(want)
        held = ~res if adam else np.ones_like(res)
        tol = 1e-5 * max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(got[held], want[held], rtol=0, atol=tol)
        assert (np.abs(got - want)[~held] <= steps_bound).all()


@pytest.fixture(scope="module")
def task_root(world):
    root = world["root"] / "finetune_elevater"
    write_elevater_task(root, TASK, TASK_CLASSES, seed=3, n_train=2, n_test=1)
    return str(root)


FT_OPTS = ["OPTIM.NAME", "adamw", "OPTIM.STAGED_LR", "True", "OPTIM.BASE_LR_MULT", "0.1",
           "OPTIM.LR", "0.001", "TRAIN.STEPS_PER_DISPATCH", "3"]


def _ft_argv(root, out, *extra):
    return ["--root", root, "--output-dir", str(out), "--trainer", "FinetuneCLIP",
            "--dataset", TASK, "--shots", "2", "--seed", "1", *extra, *TINY_OPTS, *FT_OPTS]


def _ft_run(package: str, argv: list):
    """(trainer, per-step losses) of one FinetuneCLIP CLI run: the trainer
    built by the CLI with --no-train, its train_step wrapped to record the
    losses, then trained (on the CPU, in fp32)."""
    saved = sys.stdout
    try:
        if package == "jax":
            from mvlpt_tpu.cli import train as cli

            trainer = cli.main(cli.build_parser().parse_args(["--no-train", *argv]))
        else:
            from mvlpt_torch.cli import train as cli

            trainer = cli.main(cli.build_parser().parse_args(["--no-train", *argv]),
                               device="cpu")
        losses = []
        step = trainer.train_step

        def recorded(*args):
            state, metrics = step(*args)
            losses.append(float(np.asarray(metrics["loss"].detach()
                                           if isinstance(metrics["loss"], torch.Tensor)
                                           else metrics["loss"])))
            return state, metrics

        trainer.train_step = recorded
        trainer.train()
    finally:
        sys.stdout = saved  # both loggers tee stdout into log.txt
    return trainer, losses


def test_cli_matches_jax(env, task_root, tmp_path):
    """Two epochs with best-val selection and the final test, AdamW with
    STAGED_LR, from the same head (the port's carried from the JAX run's
    draw); then each package loads the other's checkpoint."""
    from mvlpt_torch.checkpoint import prompt_io as t_io
    from mvlpt_torch.train import finetune
    from mvlpt_torch.utils.tree import tree_map

    jt, j_losses = _ft_run("jax", _ft_argv(task_root, tmp_path / "jax"))
    # The JAX trainer's head draw (a normal under PRNGKey(SEED)), which
    # the port's run starts from in place of its own torch draw.
    out_dim = jt.state.prompt_params["head"]["kernel"].shape[0]
    head = {"kernel": np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                   (out_dim, TASK_CLASSES)) * 0.01),
            "bias": np.zeros(TASK_CLASSES, np.float32)}
    real_init = finetune.build_finetune_optimizer

    def from_jax_head(params, ocfg, spe):
        return real_init(dict(params, head=tree_map(torch.from_numpy, head)), ocfg, spe)

    finetune.build_finetune_optimizer = from_jax_head
    try:
        tt, t_losses = _ft_run("port", _ft_argv(task_root, tmp_path / "port"))
    finally:
        finetune.build_finetune_optimizer = real_init
    assert len(t_losses) == len(j_losses) == 2 * jt.steps_per_epoch > 2
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)

    t_res, j_res = _results(tmp_path / "port"), _results(tmp_path / "jax")
    assert len(t_res) == len(j_res) == 3  # val, val, test
    for a, b in zip(t_res, j_res):
        assert a.keys() == b.keys()
        for k in b:
            assert abs(a[k] - b[k]) <= 100.0 / TASK_CLASSES + 1e-9, (k, a, b)
    for package in ("jax", "port"):
        log = (tmp_path / package / "log.txt").read_text()
        assert "FinetuneCLIP: TRAIN.STEPS_PER_DISPATCH=3 ignored" in log
        assert "Finetuning" in log and "-way head)" in log

    # cross-load: each package's load_model takes the other's checkpoint
    for src, loader in (("jax", tt), ("port", jt)):
        loader.load_model(str(tmp_path / src), epoch=2)
        want = t_io.load_prompt_checkpoint(t_io.checkpoint_path(str(tmp_path / src), 2))
        got = _flat(loader.state.prompt_params)
        assert got.keys() == want["state_dict"].keys() and "head.kernel" in got
        for k in want["state_dict"]:
            np.testing.assert_array_equal(got[k], want["state_dict"][k], err_msg=f"{src}: {k}")


def test_rn_backbone_raises(world, task_root, tmp_path, monkeypatch):
    """Both packages refuse an RN backbone with the same ValueError."""
    from tests.torch_port_util import openai_rn_state_dict

    ckpt = tmp_path / "RN-tiny.pt"
    torch.save(openai_rn_state_dict(0), str(ckpt))
    monkeypatch.delenv("MVLPT_TPU_RANDOM_CLIP", raising=False)
    monkeypatch.setenv("MVLPT_TPU_CLIP_CKPT", str(ckpt))
    for package in ("jax", "port"):
        argv = _ft_argv(task_root, tmp_path / package, "--backbone", "RN50")
        with pytest.raises(ValueError, match="FinetuneCLIP currently finetunes the ViT tower"):
            _ft_run(package, argv)
    assert os.path.exists(ckpt)
