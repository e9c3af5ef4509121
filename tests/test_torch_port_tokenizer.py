"""The port's stdlib-re tokenizer against the JAX package's, on a
synthetic merges file (the real CLIP vocab is not in the repository)."""

import gzip
import json
from pathlib import Path

import numpy as np
import pytest

from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)

METADATA = Path(__file__).resolve().parent.parent / "mvlpt_tpu/data/elevater/metadata.json"


def _task_classnames():
    tasks = json.loads(METADATA.read_text())["tasks"]
    out = {}
    for name, task in tasks.items():
        names = []
        for c in task["classes"]:
            names.extend(c if isinstance(c, list) else [c])
        out[name] = names
    return out


def test_synthetic_vocab_shape(tmp_path):
    from mvlpt_torch.tokenizer import ClipBpeTokenizer, write_synthetic_vocab
    from mvlpt_torch.tokenizer.bpe import NUM_MERGES

    a = write_synthetic_vocab(str(tmp_path / "a.txt.gz"), seed=3)
    b = write_synthetic_vocab(str(tmp_path / "b.txt.gz"), seed=3)
    with gzip.open(a, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    merges = [line for line in lines[1:] if line]
    assert len(merges) == NUM_MERGES == 48894
    assert len(set(merges)) == NUM_MERGES
    assert Path(a).read_bytes() != b"" and gzip.open(a).read() == gzip.open(b).read()
    assert ClipBpeTokenizer(a).vocab_size == 49408


def test_ids_match_jax_on_repo_classnames(synthetic_vocab):  # noqa: F811
    from mvlpt_tpu.tokenizer import bpe as jbpe
    from mvlpt_torch.tokenizer import bpe as tbpe

    jtok, ttok = jbpe.get_tokenizer(), tbpe.get_tokenizer()
    names = [n for ns in _task_classnames().values() for n in ns]
    assert len(names) > 3000
    for n in names:
        assert ttok.encode(n) == jtok.encode(n), n
    prompts = [f"X X X X {n}." for n in names[:500]]
    np.testing.assert_array_equal(tbpe.tokenize(prompts), jbpe.tokenize(prompts))


@pytest.mark.parametrize("text", [
    "naïve café ½ ² Ⅻ 日本語 déjà-vu", "it's the dog's &amp; cat's   toy!!",
    "Ωmega 3.14 x²", "ＦＵＬＬ　ｗｉｄｔｈ", "emoji 🐕‍🦺 and tabs\tnewlines\n"])
def test_ids_match_jax_beyond_ascii(synthetic_vocab, text):  # noqa: F811
    from mvlpt_tpu.tokenizer import bpe as jbpe
    from mvlpt_torch.tokenizer import bpe as tbpe

    assert tbpe.get_tokenizer().encode(text) == jbpe.get_tokenizer().encode(text)
    assert tbpe.get_tokenizer().decode(tbpe.get_tokenizer().encode(text)) == \
        jbpe.get_tokenizer().decode(jbpe.get_tokenizer().encode(text))


def test_cut_context_length_matches_jax(synthetic_vocab):  # noqa: F811
    from mvlpt_tpu.prompts import compute_cut_context_length as jcut
    from mvlpt_torch.prompts import compute_cut_context_length as tcut

    for names in _task_classnames().values():
        for n_ctx in (4, 16):
            assert tcut(names, n_ctx) == jcut(names, n_ctx)
    flagship = [f"class number {i}" for i in range(100)]
    assert tcut(flagship, 4) == jcut(flagship, 4)
    assert tcut(flagship, 0, ctx_init="a photo of a") == jcut(flagship, 0, ctx_init="a photo of a")


def test_vocab_lookup_and_overflow(synthetic_vocab, tmp_path, monkeypatch):  # noqa: F811
    from mvlpt_torch.tokenizer import bpe as tbpe

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("MVLPT_TORCH_BPE_PATH", synthetic_vocab)
    assert tbpe.find_bpe_vocab() == synthetic_vocab
    monkeypatch.setenv("MVLPT_TORCH_BPE_PATH", str(tmp_path / "missing.txt.gz"))
    with pytest.raises(FileNotFoundError, match="MVLPT_TORCH_BPE_PATH"):
        tbpe.find_bpe_vocab()
    with pytest.raises(RuntimeError, match="too long"):
        tbpe.tokenize("word " * 100, context_length=8)
    ids = tbpe.tokenize("word " * 100, context_length=8, truncate=True)
    assert ids[0, -1] == tbpe.get_tokenizer().eot_token
