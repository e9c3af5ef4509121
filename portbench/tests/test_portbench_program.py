"""The benchmark's inputs in the port's formats: its weights and prompt
leaves have the port's schema, its leaf order is the port's, and the
reference's class prompts give the port's text length."""

import json

import pytest
import torch
from conftest import DATA, ROOT

from portbench import cells, program


def _shapes(tree):
    return [(p, tuple(t.shape)) for p, t in cells.flatten(tree)]


@pytest.mark.parametrize("config", ["tiny_upt", "tiny_upt_multitask"])
def test_inputs_have_the_ports_schema(config):
    from mvlpt_torch.core.clip import CLIPConfig, init_clip_params
    from mvlpt_torch.prompts import PromptSpec, init_prompt_params
    from mvlpt_torch.utils.tree import tree_leaves

    cfg = json.loads((DATA / f"{config}.json").read_text())
    clip, pr = cfg["clip"], cfg["prompt"]
    clip_cfg = CLIPConfig(**{k: v for k, v in clip.items() if k != "vision_heads"},
                          vision_heads_override=clip["vision_heads"])
    ours = program.make_backbone(clip, 1, torch.bfloat16, "cpu")
    theirs = init_clip_params(torch.Generator().manual_seed(0), clip_cfg, device="cpu")
    assert _shapes(ours) == _shapes(theirs)
    spec = PromptSpec(n_cls=len(program.classnames(cfg)), coop_n_ctx=pr["coop_n_ctx"],
                      vpt_n_ctx=pr["vpt_n_ctx"], vpt_deep=pr["vpt_deep"],
                      project_method=pr["project_method"], project_dim=pr["project_dim"],
                      vision_layers=clip["vision_layers"], vision_width=clip["vision_width"],
                      text_width=clip["transformer_width"], embed_dim=clip["embed_dim"],
                      vision_patch_size=clip["vision_patch_size"])
    mine = program.make_prompt_params(cfg, 2, "cpu")
    assert _shapes(mine) == _shapes(init_prompt_params(torch.Generator().manual_seed(0), spec,
                                                       device="cpu"))
    assert all(a is b for (_, a), b in zip(cells.flatten(mine), tree_leaves(mine)))


def test_inputs_follow_the_seed():
    cfg = json.loads((DATA / "tiny_upt.json").read_text())
    a, b = (program.make_prompt_params(cfg, program.seeds(s)["prompts"], "cpu")
            for s in (2 ** 31 + 7, 2 ** 31 + 7))
    c = program.make_prompt_params(cfg, program.seeds(2 ** 31 + 8)["prompts"], "cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(cells.flatten(a), cells.flatten(b)))
    assert not torch.equal(cells.flatten(a)[0][1], cells.flatten(c)[0][1])
    assert len(set(program.seeds(5).values())) == len(program.STREAMS)


@pytest.mark.parametrize("config,s", [("upt_vitb16_c100", 18), ("upt_vitb16_elevater20", 70)])
def test_text_length_of_the_cells(config, s, tmp_path):
    """The port's CUT_CONTEXTLEN and the reference's own prompts agree on
    the cell's text length with the synthetic vocab (seed 0)."""
    import os

    from portbench.reference.clip_upt import ClassPrompts
    from portbench.reference.tokenizer import ClipBpeTokenizer, write_synthetic_vocab

    vocab = write_synthetic_vocab(str(tmp_path / "vocab.txt.gz"), seed=0)
    os.environ["MVLPT_TORCH_BPE_PATH"] = vocab
    os.environ["MVLPT_TPU_NO_NATIVE_BPE"] = "1"
    from mvlpt_torch.prompts import compute_cut_context_length

    cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    names = program.classnames(cfg)
    n_ctx = cfg["prompt"]["coop_n_ctx"]
    assert compute_cut_context_length(names, n_ctx) == s
    prompts = ClassPrompts(ClipBpeTokenizer(vocab), names, n_ctx, "cpu")
    assert prompts.token.shape == (len(names), s)
