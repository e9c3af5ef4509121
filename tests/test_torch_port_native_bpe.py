"""The port's native BPE core (``mvlpt_torch/native/bpetok.cpp`` through
``tokenizer/bpe.py``) on the synthetic vocab of
``mvlpt_torch.tokenizer.write_synthetic_vocab``: its ids equal the
port's Python path, the JAX package's ``NativeBpe`` and the JAX
tokenizer's, for every case of tests/test_native_bpe.py and 300 random
ASCII strings; input off the fast path (non-ASCII, control characters)
takes the Python path; MVLPT_TPU_NO_NATIVE_BPE opts out."""

import random
import string

import pytest

from mvlpt_tpu import native as jnative
from mvlpt_tpu.tokenizer import bpe as jbpe
from mvlpt_torch import native
from mvlpt_torch.tokenizer import bpe as tbpe

CASES = [
    "a photo of a dog.",
    "A PHOTO of a Dog!!",                       # lowered before dispatch
    "it's a dog's life, isn't it?",             # contractions
    "class 123 number 9",                       # digits one by one
    "hello-world_under.score",
    "don't!!!'s mix''d",                        # apostrophes inside runs
    "<|startoftext|> weird <|endoftext|>",      # special literals
    "'ll 'd 've 're 'm 's 't",
    "..,,;;''!!",
    "",
    "   ",
    "antidisestablishmentarianism",             # a long merge chain
    "a  b\t c\n d",                             # whitespace collapse
    "price $5.99 (50% off)",
]
NON_ASCII = [
    "naïve café",
    "日本語 text",
    "emoji 🙂 here",
    "mixed ascii ünïcode tail",
    "ctrl\x01char",                             # a control character's punct run
]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """(port native, port Python, JAX native) tokenizers and the JAX
    package's bare NativeBpe, on one synthetic merges file."""
    root = tmp_path_factory.mktemp("native_bpe")
    path = tbpe.write_synthetic_vocab(str(root / "synthetic_bpe_vocab.txt.gz"), seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MVLPT_TPU_NO_NATIVE_BPE", raising=False)
        mp.setenv("MVLPT_TPU_NATIVE_CACHE", str(root / "jax_native"))
        port_native = tbpe.ClipBpeTokenizer(path)
        jax_native = jbpe.ClipBpeTokenizer(path)
        mp.setenv("MVLPT_TPU_NO_NATIVE_BPE", "1")
        port_python = tbpe.ClipBpeTokenizer(path)
    assert port_native._native is not None, port_native.native_error
    assert jax_native._native is not None
    assert port_python._native is None
    assert port_python.native_error == "MVLPT_TPU_NO_NATIVE_BPE is set"
    import gzip

    with gzip.open(path, "rt", encoding="utf-8") as f:
        raw = f.read().encode("utf-8")
    return port_native, port_python, jax_native, jnative.NativeBpe(raw)


@pytest.mark.parametrize("text", CASES, ids=range(len(CASES)))
def test_ascii_ids_equal_python_and_jax(tokenizers, text):
    port_native, port_python, jax_native, jax_core = tokenizers
    ids = port_native.encode(text)
    assert ids == port_python.encode(text) == jax_native.encode(text)
    cleaned = tbpe._clean_text(text).lower()
    assert port_native._native.encode(cleaned) == jax_core.encode(cleaned) == ids


@pytest.mark.parametrize("text", NON_ASCII, ids=range(len(NON_ASCII)))
def test_off_the_fast_path_takes_python(tokenizers, text):
    port_native, port_python, jax_native, _ = tokenizers
    cleaned = tbpe._clean_text(text).lower()
    if cleaned.isascii():  # a control character: the core hands it back
        assert port_native._native.encode(cleaned) is None
    assert port_native.encode(text) == port_python.encode(text) == jax_native.encode(text)


def test_ascii_fuzz(tokenizers):
    port_native, port_python, jax_native, _ = tokenizers
    rng = random.Random(0)
    alphabet = string.ascii_letters + string.digits + string.punctuation + "  "
    for _ in range(300):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 80)))
        assert port_native.encode(s) == port_python.encode(s) == jax_native.encode(s), repr(s)


def test_specials_and_tokenize(tokenizers, monkeypatch):
    port_native, port_python, _, jax_core = tokenizers
    assert (port_native._native.sot, port_native._native.eot) == \
        (port_native.sot_token, port_native.eot_token) == (jax_core.sot, jax_core.eot)
    monkeypatch.setattr(tbpe, "_DEFAULT", port_native)
    fast = tbpe.tokenize(["a photo of a cat.", "x"], context_length=20)
    monkeypatch.setattr(tbpe, "_DEFAULT", port_python)
    assert (fast == tbpe.tokenize(["a photo of a cat.", "x"], context_length=20)).all()


def test_unbuildable_core_takes_python_quietly(tokenizers, monkeypatch, tmp_path):
    """As in the JAX package, a host that cannot build the core tokenizes
    on the Python path; ``native_error`` says why."""
    port_native, port_python, _, _ = tokenizers

    def fail(*a, **k):
        raise native.NativeUnavailable("native bpetok build failed: no g++")

    monkeypatch.setattr(native, "_build", fail)
    monkeypatch.delenv("MVLPT_TPU_NO_NATIVE_BPE", raising=False)
    vocab = tbpe.write_synthetic_vocab(str(tmp_path / "v.txt.gz"), seed=0)
    tok = tbpe.ClipBpeTokenizer(vocab)
    assert tok._native is None and "no g++" in tok.native_error
    assert tok.encode(CASES[2]) == port_python.encode(CASES[2])
