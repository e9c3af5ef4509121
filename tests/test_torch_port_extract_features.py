"""ELEVATER feature extraction through both CLIs
(``mvlpt_tpu.cli.extract_features`` and ``mvlpt_torch.cli.extract_features``)
and the knowledge module, on the CPU in fp32.

Both CLIs read one tiny OpenAI-layout ViT checkpoint at 224 px in 32 px
patches (``MVLPT_TPU_CLIP_CKPT``) and the synthetic vocab; each package's
``load_clip_backbone`` is wrapped to load fp32 where the CLIs load bf16.
Holds, for a task with its real class names under ``--knowledge wiki
gpt3`` and ``--knowledge-tsv``, and for a custom task with the fallback
template: every split's image features and ``text.npz`` within 1e-4 x
max|ref|, the labels, row order and class names equal (``--model``, the
model zoo's branch, is held in tests/test_torch_port_zoo_cli.py);
``--backbone RN50`` writes the image
features (equal within 1e-4 x max|ref|) and fails at the text step in
both packages. The knowledge module: ``knowledge.json`` byte for byte,
``knowledge_texts`` string for string for every (task, class) in it under
every source set and both aggregations, and the knowledge-augmented text
features, their tail chunk padded, within 1e-4 x max|ref|.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_port_checkpoint import _openai_state_dict
from tests.torch_port_util import (  # noqa: F401 (fixture)
    openai_rn_state_dict,
    synthetic_vocab,
    write_elevater_task,
)

TASK = "kitti-distance"  # 4 classes, each with wiki and GPT-3 knowledge
CUSTOM = "my-custom-task"
SOURCES = ("wiki", "wordnet", "hierarchy", "gpt3")


def _vit_224_state_dict() -> dict:
    """The checkpoint test's tiny ViT (width 64, 2 layers a tower, embed 32)
    at 224 px in 32 px patches, the CLIP default input the CLI extracts at."""
    sd = _openai_state_dict(0)
    rng = np.random.RandomState(1)
    sd["visual.conv1.weight"] = torch.from_numpy(
        (rng.randn(64, 3, 32, 32) * 0.02).astype(np.float32))
    sd["visual.positional_embedding"] = torch.from_numpy(
        (rng.randn(50, 64) * 0.05).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def world(tmp_path_factory, synthetic_vocab):  # noqa: F811
    root = tmp_path_factory.mktemp("extract")
    write_elevater_task(root / "data", TASK, 4, seed=5, n_train=3, n_test=2)
    write_elevater_task(root / "data", CUSTOM, 3, seed=6, n_train=2, n_test=1,
                        classnames=["ant", "bee", "wasp"])
    torch.save(_vit_224_state_dict(), str(root / "vit.pt"))
    torch.save(openai_rn_state_dict(2, layers=(1, 1, 1, 1), width=8, resolution=224, embed=32),
               str(root / "rn.pt"))
    tsv = root / "extra.tsv"
    tsv.write_text("a photo i took of a car on my left or right side.\tleft or right\n"
                   "a photo i took with a car nearby.\tclose by\tignored column\n"
                   "no tab on this line\n")
    return {"root": root, "data": str(root / "data"), "tsv": str(tsv)}


def _run(package: str, argv: list, ckpt: str, monkeypatch):
    """One CLI run of ``package`` ('jax' or 'port') on the CPU, its backbone
    loaded in fp32."""
    with monkeypatch.context() as mp:
        mp.delenv("MVLPT_TPU_RANDOM_CLIP", raising=False)
        mp.setenv("MVLPT_TPU_CLIP_CKPT", ckpt)
        if package == "jax":
            import jax.numpy as jnp

            from mvlpt_tpu.cli import extract_features as cli_mod
            from mvlpt_tpu.train import trainer

            load, fp32 = trainer.load_clip_backbone, jnp.float32
            mp.setattr(trainer, "load_clip_backbone", lambda cfg, dtype: load(cfg, fp32))
            mp.setattr(sys, "argv", ["extract_features", *argv])
            cli_mod.cli()
        else:
            from mvlpt_torch.cli import extract_features as cli_mod
            from mvlpt_torch.train import trainer

            load = trainer.load_clip_backbone
            mp.setattr(trainer, "load_clip_backbone",
                       lambda cfg, dtype, device: load(cfg, torch.float32, device))
            cli_mod.cli(argv, device="cpu")


def _close(got, want, rel=1e-4, what=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def _same_images(out_t, out_j):
    splits = sorted(p for p in os.listdir(out_j) if p.endswith(".npz") and p != "text.npz")
    assert splits and splits == sorted(
        p for p in os.listdir(out_t) if p.endswith(".npz") and p != "text.npz")
    for split in splits:
        a, b = np.load(os.path.join(out_t, split)), np.load(os.path.join(out_j, split))
        assert a["feature_list"].dtype == np.float32
        assert np.array_equal(a["label_list"], b["label_list"]), split
        _close(a["feature_list"], np.asarray(b["feature_list"], np.float32), what=split)


def _same_text(out_t, out_j):
    a = np.load(os.path.join(out_t, "text.npz"), allow_pickle=True)
    b = np.load(os.path.join(out_j, "text.npz"), allow_pickle=True)
    assert list(a["classnames"]) == list(b["classnames"])
    assert a["text_features"].dtype == np.float32
    _close(a["text_features"], b["text_features"], what="text")
    return list(a["classnames"])


@pytest.mark.parametrize("case", ["knowledge", "custom"])
def test_extract_features_matches_jax(world, tmp_path, monkeypatch, case):
    if case == "knowledge":
        extra = ["--dataset", TASK, "--knowledge", "wiki", "gpt3", "--knowledge-tsv",
                 world["tsv"]]
    else:
        extra = ["--dataset", CUSTOM]
    for package in ("jax", "port"):
        _run(package, ["--root", world["data"], "--output-dir", str(tmp_path / package),
                       "--batch-size", "4", *extra], str(world["root"] / "vit.pt"), monkeypatch)
    _same_images(tmp_path / "port", tmp_path / "jax")
    names = _same_text(tmp_path / "port", tmp_path / "jax")
    if case == "custom":
        assert names == ["ant", "bee", "wasp"]
    else:
        from mvlpt_torch.data.elevater import class_map

        assert len(names) == 4 and names[0] == class_map(TASK)[0]


def test_rn_backbone_fails_at_the_text_step_in_both(world, tmp_path, monkeypatch):
    """An RN backbone gives image features only: both packages write every
    split's npz, then fail where the text step reads the config's text
    fields (the JAX package's RNConfig has none)."""
    argv = ["--root", world["data"], "--dataset", TASK, "--backbone", "RN50",
            "--batch-size", "4"]
    ckpt = str(world["root"] / "rn.pt")
    with pytest.raises(AttributeError, match="context_length"):
        _run("jax", [*argv, "--output-dir", str(tmp_path / "jax")], ckpt, monkeypatch)
    with pytest.raises(ValueError, match="image features only"):
        _run("port", [*argv, "--output-dir", str(tmp_path / "port")], ckpt, monkeypatch)
    _same_images(tmp_path / "port", tmp_path / "jax")
    assert not (tmp_path / "port" / "text.npz").exists()


def test_knowledge_json_is_a_byte_copy():
    from mvlpt_tpu.data.elevater import knowledge as jk

    from mvlpt_torch.data.elevater import knowledge as tk

    with open(jk._KNOWLEDGE_PATH, "rb") as a, open(tk._KNOWLEDGE_PATH, "rb") as b:
        assert a.read() == b.read()
    assert len(tk.load_knowledge()) == 21
    assert sum(len(v) for v in tk.load_knowledge().values()) == 2149


@pytest.mark.parametrize("aggregation", ["WIKI_AND_GPT3", "WIKI_THEN_GPT3"])
def test_knowledge_texts_match_jax(aggregation):
    from mvlpt_tpu.data.elevater import knowledge as jk

    from mvlpt_torch.data.elevater import knowledge as tk

    n = 0
    for mask in range(1, 1 << len(SOURCES)):
        use = {f"use_{s}": bool(mask >> i & 1) for i, s in enumerate(SOURCES)}
        for task, table in tk.load_knowledge().items():
            for classname in [*table, "not a class"]:
                kw = dict(use, aggregation=aggregation, n_gpt3=3 if mask == 15 else 5)
                got = tk.knowledge_texts(task, classname, **kw)
                assert got == jk.knowledge_texts(task, classname, **kw), (task, classname, kw)
                n += bool(got)
    assert n > 20000  # most comparisons hold snippets, not two empty lists


def test_knowledge_text_features_match_jax(synthetic_vocab):  # noqa: F811
    """encode_class_text_features_with_knowledge in chunks of 7 rows, the
    tail padded, against the JAX package's on the same fp32 text tower."""
    import jax

    from mvlpt_tpu.checkpoint import convert as jconv
    from mvlpt_tpu.data.elevater import knowledge as jk
    from mvlpt_tpu.data.elevater import template_map as j_templates

    from mvlpt_torch.checkpoint import backbone_from_jax
    from mvlpt_torch.core.clip import CLIPConfig
    from mvlpt_torch.data.elevater import knowledge as tk

    j_params, j_cfg = jconv.convert_openai_state_dict(_vit_224_state_dict())
    params = backbone_from_jax(jax.tree_util.tree_map(np.asarray, j_params), "cpu")
    classes = ["Abyssinian", "american bulldog", "no such pet"]
    templates = j_templates("oxford-iiit-pets")[:2]
    kw = dict(sources=("hierarchy", "gpt3"), n_gpt3=2, aggregation="WIKI_THEN_GPT3",
              batch_rows=7)
    want = np.asarray(jk.encode_class_text_features_with_knowledge(
        j_params, j_cfg, "oxford-iiit-pets", classes, templates, **kw))
    got = tk.encode_class_text_features_with_knowledge(
        params, CLIPConfig(**dataclasses.asdict(j_cfg)), "oxford-iiit-pets", classes,
        templates, **kw)
    assert got.shape == (3, 32) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_extract_features_runs_on_the_card_unless_asked(world, tmp_path, monkeypatch):
    from mvlpt_torch.cli.extract_features import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli(["--root", world["data"], "--dataset", TASK, "--output-dir", str(tmp_path)])
