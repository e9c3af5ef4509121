"""``extract_features --model`` through both CLIs
(``mvlpt_tpu.cli.extract_features`` and ``mvlpt_torch.cli.extract_features``)
on the CPU, on one tmp ELEVATER task (tests/torch_port_util.
write_elevater_task).

Two zoo models from ``--model-checkpoint`` files in their libraries' key
layouts (tests/torch_port_util.py): a tiny torchvision ResNet (224 px,
the family's input size) and a tiny timm ViT (32 px, from its positional
embedding). Run as shipped (bf16 weights), each split's features are
held to PERF.md §2's bf16 rule against the JAX package's features with
``get_model`` held to fp32: the port's distance at most twice the JAX
package's bf16 distance, floor 5e-3 x max|ref|. Run with both packages'
``get_model`` held to fp32, they agree within 1e-4 x max|ref|. Labels and
row order are equal, neither writes ``text.npz``, the loader gets the
model's input size and ImageNet's statistics, and the CLI raises when
CUDA is asked for and absent.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tests.torch_port_util import timm_vit_state_dict, tv_resnet_state_dict, write_elevater_task

TASK = "cifar-10"
MODELS = {"resnet18": dict(size=224, dim=64), "vit_base_patch16_224": dict(size=32, dim=64)}
FLOOR, TWIN_FACTOR = 5e-3, 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_cli")
    write_elevater_task(root / "data", TASK, 10, seed=8, n_train=2, n_test=1)
    ckpt = {"resnet18": str(root / "resnet18.pth"),
            "vit_base_patch16_224": str(root / "vit.pth")}
    torch.save(tv_resnet_state_dict(9, layers=(1, 1, 1, 1), width=8, bottleneck=False),
               ckpt["resnet18"])
    torch.save(timm_vit_state_dict(10, width=64, layers=2, patch=16, resolution=32),
               ckpt["vit_base_patch16_224"])
    return {"data": str(root / "data"), "ckpt": ckpt, "runs": {}, "root": root}


def _run(package: str, model: str, fp32: bool, world, monkeypatch) -> str:
    """One CLI run (cached per package, model and dtype); returns its
    output directory. ``fp32`` holds get_model's dtype at fp32 where the
    CLI asks for bf16."""
    key = (package, model, fp32)
    if key in world["runs"]:
        return world["runs"][key]
    out = str(world["root"] / f"{package}-{model}-{'fp32' if fp32 else 'bf16'}")
    argv = ["--root", world["data"], "--dataset", TASK, "--model", model, "--model-checkpoint",
            world["ckpt"][model], "--output-dir", out, "--batch-size", "8"]
    with monkeypatch.context() as mp:
        if package == "jax":
            import jax.numpy as jnp

            from mvlpt_tpu.cli import extract_features as cli_mod
            from mvlpt_tpu.models import zoo

            if fp32:
                get = zoo.get_model
                mp.setattr(zoo, "get_model", lambda *a, **k: get(*a, **dict(k, dtype=jnp.float32)))
            mp.setattr(sys, "argv", ["extract_features", *argv])
            cli_mod.cli()
        else:
            from mvlpt_torch.cli import extract_features as cli_mod
            from mvlpt_torch.data import managers
            from mvlpt_torch.models import zoo

            if fp32:
                get = zoo.get_model
                mp.setattr(zoo, "get_model",
                           lambda *a, **k: get(*a, **dict(k, dtype=torch.float32)))
            seen, build = {}, managers.build_data_manager

            def spy(cfg, *a, **k):
                seen.update(size=tuple(cfg.INPUT.SIZE), mean=tuple(cfg.INPUT.PIXEL_MEAN),
                            std=tuple(cfg.INPUT.PIXEL_STD), strict=k.get("strict_classnames"))
                return build(cfg, *a, **k)

            mp.setattr(managers, "build_data_manager", spy)
            cli_mod.cli(argv, device="cpu")
            size = MODELS[model]["size"]
            assert seen == dict(size=(size, size), mean=(0.485, 0.456, 0.406),
                                std=(0.229, 0.224, 0.225), strict=False)
    assert not os.path.exists(os.path.join(out, "text.npz"))
    world["runs"][key] = out
    return out


def _splits(out: str) -> dict:
    names = sorted(p for p in os.listdir(out) if p.endswith(".npz"))
    assert names and "text.npz" not in names
    result = {}
    for name in names:
        with np.load(os.path.join(out, name)) as z:
            result[name] = (z["feature_list"], z["label_list"])
    return result


@pytest.mark.parametrize("model", sorted(MODELS))
def test_zoo_extract_fp32_matches_jax(world, monkeypatch, model):
    port = _splits(_run("port", model, True, world, monkeypatch))
    want = _splits(_run("jax", model, True, world, monkeypatch))
    assert list(port) == list(want)
    for split, (feats, labels) in port.items():
        ref, ref_labels = want[split]
        assert feats.dtype == np.float32 and feats.shape == (len(ref), MODELS[model]["dim"])
        assert np.array_equal(labels, ref_labels), split
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(feats, ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=split)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_zoo_extract_bf16_within_the_rule(world, monkeypatch, model):
    port = _splits(_run("port", model, False, world, monkeypatch))
    jax16 = _splits(_run("jax", model, False, world, monkeypatch))
    ref32 = _splits(_run("jax", model, True, world, monkeypatch))
    for split, (feats, labels) in port.items():
        ref = np.asarray(ref32[split][0], np.float32)
        assert np.array_equal(labels, ref32[split][1]) and np.isfinite(feats).all()
        d_port = float(np.abs(feats - ref).max())
        d_jax = float(np.abs(np.asarray(jax16[split][0], np.float32) - ref).max())
        bound = max(TWIN_FACTOR * d_jax, FLOOR * float(np.abs(ref).max()))
        assert d_port <= bound, (split, d_port, d_jax, bound)
        assert d_jax > 0


def test_zoo_extract_runs_on_the_card_unless_asked(world, tmp_path, monkeypatch):
    from mvlpt_torch.cli.extract_features import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli(["--root", world["data"], "--dataset", TASK, "--model", "resnet18",
             "--model-checkpoint", world["ckpt"]["resnet18"], "--output-dir", str(tmp_path)])
