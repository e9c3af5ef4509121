"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py).

The JAX package is the reference: the same numpy inputs go through it
and through ``mvlpt_torch`` on the CPU, in fp32. Its Pallas kernels run
in interpret mode there, as in its own tests.
"""

from __future__ import annotations

import numpy as np
import pytest


@pytest.fixture(scope="module")
def synthetic_vocab(tmp_path_factory):
    """A generated merges file in place of the real CLIP vocab, handed to
    both tokenizers: the JAX side by replacing its default tokenizer
    (its search paths are fixed when it is imported), the port by its
    own default."""
    from mvlpt_torch.tokenizer import bpe as tbpe

    path = str(tmp_path_factory.mktemp("vocab") / "synthetic_bpe_vocab.txt.gz")
    tbpe.write_synthetic_vocab(path, seed=0)
    from mvlpt_tpu.tokenizer import bpe as jbpe

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MVLPT_TPU_NO_NATIVE_BPE", "1")
        mp.setattr(jbpe, "_DEFAULT", jbpe.ClipBpeTokenizer(path))
        mp.setattr(tbpe, "_DEFAULT", tbpe.ClipBpeTokenizer(path))
        yield path


def block_params_np(rng: np.random.RandomState, w: int) -> dict:
    """One residual block's params in the JAX schema (tests/test_fused_block.py)."""
    def mk(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    return {
        "ln_1": {"scale": (1 + 0.1 * rng.randn(w)).astype(np.float32), "bias": mk(w)},
        "ln_2": {"scale": (1 + 0.1 * rng.randn(w)).astype(np.float32), "bias": mk(w)},
        "attn": {"qkv_w": mk(w, 3 * w), "qkv_b": mk(3 * w), "out_w": mk(w, w),
                 "out_b": mk(w)},
        "mlp": {"fc_w": mk(w, 4 * w), "fc_b": mk(4 * w), "proj_w": mk(4 * w, w),
                "proj_b": mk(w)},
    }


def to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)
