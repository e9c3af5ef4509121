"""``interpret_prompt`` (mvlpt_torch/cli/interpret_prompt.py) against the
JAX package's, on the CPU with the synthetic vocab.

``interpret`` on a seeded (49408, 64) token embedding gives the JAX
package's words, in the same order, and its distances within 1e-5
relative, for one context set (n, D) and for several (M, n, D). Both CLIs
read a CoOp checkpoint (the reference trainer's torch archive, ``ctx``
beside ``token_prefix``/``token_suffix``) and a CoCoOp one (this repo's
pickle with ``cocoop.ctx`` and the meta-net) against one tiny OpenAI
``.pt`` (``MVLPT_TPU_CLIP_CKPT``), and print the same context size and the
same nearest words at the same distances. The CLI raises when CUDA is
asked for and absent.
"""

import sys

import numpy as np
import pytest
import torch

from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)

REL = 1e-5


def _same_rows(got, want):
    assert len(got) == len(want)
    for set_got, set_want in zip(got, want):
        assert len(set_got) == len(set_want)
        for row_got, row_want in zip(set_got, set_want):
            assert [w for w, _ in row_got] == [w for w, _ in row_want]
            np.testing.assert_allclose([d for _, d in row_got], [d for _, d in row_want],
                                       rtol=REL, atol=0)


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 64)])
def test_interpret_matches_jax(synthetic_vocab, shape):  # noqa: F811
    from mvlpt_tpu.cli.interpret_prompt import interpret as j_interpret

    from mvlpt_torch.cli.interpret_prompt import interpret

    rng = np.random.RandomState(len(shape))
    emb = (rng.randn(49408, 64) * 0.02).astype(np.float32)
    ctx = (rng.randn(*shape) * 0.02).astype(np.float32)
    want = j_interpret(ctx, emb, 7)
    got = interpret(torch.from_numpy(ctx), torch.from_numpy(emb), 7)
    _same_rows(got, want)
    assert len(got) == (1 if len(shape) == 2 else shape[0]) and len(got[0][0]) == 7


@pytest.fixture(scope="module")
def files(tmp_path_factory, synthetic_vocab):  # noqa: F811
    from mvlpt_torch.checkpoint import save_prompt_checkpoint
    from tests.test_torch_port_checkpoint import _openai_state_dict

    root = tmp_path_factory.mktemp("interpret")
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.02).astype(np.float32))

    clip = str(root / "tiny_vit.pt")
    torch.save(_openai_state_dict(0), clip)
    coop = str(root / "prompt_learner" / "model.pth.tar-5")
    (root / "prompt_learner").mkdir()
    torch.save({"state_dict": {"ctx": t(16, 64), "token_prefix": t(3, 1, 64),
                               "token_suffix": t(3, 60, 64)}, "epoch": 5}, coop)
    cocoop = str(root / "cocoop" / "model-best.pth.tar")
    save_prompt_checkpoint(cocoop, {"cocoop": {"ctx": t(4, 64), "meta_net": {
        "linear1": {"kernel": t(32, 2), "bias": t(2)},
        "linear2": {"kernel": t(2, 64), "bias": t(64)}}}}, epoch=3)
    return {"clip": clip, "coop": coop, "cocoop": cocoop}


@pytest.mark.parametrize("which, n_ctx", [("coop", 16), ("cocoop", 4)])
def test_cli_matches_jax(files, monkeypatch, capsys, which, n_ctx):
    from mvlpt_tpu.cli import interpret_prompt as j_mod

    from mvlpt_torch.cli import interpret_prompt as t_mod

    monkeypatch.delenv("MVLPT_TPU_RANDOM_CLIP", raising=False)
    monkeypatch.setenv("MVLPT_TPU_CLIP_CKPT", files["clip"])
    seen = []
    real = j_mod.interpret
    monkeypatch.setattr(j_mod, "interpret", lambda *a: seen.append(real(*a)) or seen[-1])
    monkeypatch.setattr(sys, "argv", ["interpret_prompt", files[which], "3"])
    j_mod.cli()
    j_out = capsys.readouterr().out
    rows = t_mod.cli([files[which], "3"], device="cpu")
    t_out = capsys.readouterr().out
    assert t_out.splitlines()[0] == j_out.splitlines()[0] == f"Size of context: ({n_ctx}, 64)"
    _same_rows(rows, seen[0])
    assert len(rows) == 1 and len(rows[0]) == n_ctx and all(len(r) == 3 for r in rows[0])
    assert len(t_out.splitlines()) == len(j_out.splitlines()) == 2 + n_ctx


def test_cli_runs_on_the_card_unless_asked(files, monkeypatch):
    from mvlpt_torch.cli.interpret_prompt import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli([files["coop"], "3"])
