"""HuggingFace tokenizer adapter (counterpart of the reference's
trainers/vision_benchmark/datasets/hfpt_tokenizer.py:1-96 and of
``mvlpt_tpu/tokenizer/hf_adapter.py``): the same ``tokenize(texts,
context_length) -> (N, L) ids`` surface over any transformers tokenizer,
for model zoos whose text towers are not CLIP's BPE.

``transformers`` is imported when a tokenizer is built, never at import.
Tokenizers load from local files only (``local_files_only=True``): a
directory saved with ``save_pretrained`` or the local HuggingFace
cache. Where the JAX package would fetch a tokenizer from the hub, this
raises."""

from __future__ import annotations

import numpy as np


class HFPTTokenizer:
    def __init__(self, pt_name: str = "bert-base-cased"):
        from transformers import AutoTokenizer

        self.pt_name = pt_name
        try:
            self.tokenizer = AutoTokenizer.from_pretrained(pt_name, local_files_only=True)
        except OSError as e:
            raise FileNotFoundError(
                f"no local tokenizer {pt_name!r} (a saved directory or the HuggingFace cache); "
                f"nothing is downloaded: {e}") from e
        # GPT-2-family tokenizers ship no pad token; padding='max_length'
        # would raise. The reference adapter aliases pad to eos for these
        # (hfpt_tokenizer.py:33).
        if self.tokenizer.pad_token is None:
            if self.tokenizer.eos_token is not None:
                self.tokenizer.pad_token = self.tokenizer.eos_token
            else:
                self.tokenizer.add_special_tokens({"pad_token": "<PAD>"})

    @property
    def vocab_size(self) -> int:
        return int(self.tokenizer.vocab_size)

    def tokenize(self, texts, context_length: int = 77) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        enc = self.tokenizer(
            texts, padding="max_length", truncation=True,
            max_length=context_length, return_tensors="np")
        return enc["input_ids"].astype(np.int32)

    def __call__(self, texts, context_length: int = 77) -> np.ndarray:
        return self.tokenize(texts, context_length)


def build_tokenizer(tokenizer_name: str = "clip"):
    """Tokenizer factory (languages/build.py:4-16 equivalent)."""
    if tokenizer_name == "clip":
        from mvlpt_torch.tokenizer.bpe import get_tokenizer

        return get_tokenizer()
    return HFPTTokenizer(tokenizer_name)
