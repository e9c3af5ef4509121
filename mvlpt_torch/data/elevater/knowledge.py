"""External-knowledge text augmentation for ELEVATER zero-shot and
feature extraction.

The counterpart of ``mvlpt_tpu/data/elevater/knowledge.py`` (the
knowledge branch of the reference's trainers/vision_benchmark/evaluation/
feature.py:410-535): for each class, its Wiktionary or WordNet
definition, or its WordNet hierarchy path (first 3 hops), and its GPT-3
descriptions are appended to each prompt template as
``" ; {classname} , {knowledge}"``; a class's feature is the renormalised
mean of the normalised per-text embeddings.

The data is ``knowledge.json`` beside this module, a byte copy of the
JAX package's (see its ``_provenance`` field). The aggregations are the
reference's KNOWLEDGE.AGGREGATION.MEHTOD: WIKI_AND_GPT3 (both) and
WIKI_THEN_GPT3 (GPT-3 only where there is no definition).
"""

from __future__ import annotations

import json
import os
import re
from functools import lru_cache

import numpy as np
import torch

from mvlpt_torch.core import clip as clip_core
from mvlpt_torch.models.zsclip import text_config
from mvlpt_torch.tokenizer import tokenize

_KNOWLEDGE_PATH = os.path.join(os.path.dirname(__file__), "knowledge.json")


@lru_cache()
def load_knowledge() -> dict:
    with open(_KNOWLEDGE_PATH, encoding="utf-8") as f:
        return json.load(f)["tasks"]


def _clean(text: str) -> str:
    # The reference builds ' ' + ' '.join(word_tokenize(text))
    # (feature.py:509): whitespace-normalised, with a LEADING SPACE that
    # keeps the template's trailing '.' and the snippet's ';' separate BPE
    # tokens ('.;' would merge under CLIP's punctuation grouping).
    # word_tokenize's splits inside a snippet ("dog's" -> "dog 's") are not
    # reproduced, as in the JAX package: whitespace only.
    return " " + re.sub(r"\s+", " ", text).strip()


def knowledge_texts(task: str, classname: str, *, use_wiki: bool = False,
                    use_wordnet: bool = False, use_hierarchy: bool = False,
                    use_gpt3: bool = False, n_gpt3: int = 5,
                    aggregation: str = "WIKI_AND_GPT3") -> list[str]:
    """One class's knowledge snippets, formatted as feature.py:505-510
    does. An empty list: the caller keeps the plain templates."""
    entry = load_knowledge().get(task, {}).get(classname, {})
    out: list[str] = []
    primary = None
    if use_wiki and entry.get("def_wiki"):
        primary = entry["def_wiki"]
    elif use_wordnet and entry.get("def_wn"):
        primary = entry["def_wn"]
    elif use_hierarchy and entry.get("path_wn"):
        path = entry["path_wn"]
        primary = " ".join(path[: min(3, len(path))]) if path else None
    if primary:
        out.append(primary)
    if use_gpt3 and entry.get("gpt3"):
        if aggregation == "WIKI_AND_GPT3" or not out:
            out.extend(entry["gpt3"][:n_gpt3])
    return [_clean(f" ; {classname} , {t}") for t in out if t]


@torch.no_grad()
def encode_class_text_features_with_knowledge(
        backbone: dict, clip_cfg, task: str, classnames, templates, sources=("wiki",),
        n_gpt3: int = 5, aggregation: str = "WIKI_AND_GPT3",
        batch_rows: int = 512) -> torch.Tensor:
    """Knowledge-augmented, normalised (n_cls, embed_dim) fp32 class text
    features, through the plain text tower on the backbone's device."""
    clip_cfg = text_config(clip_cfg)
    use = {s: s in sources for s in ("wiki", "wordnet", "hierarchy", "gpt3")}
    # Every class's rows first, then the flat matrix in chunks of
    # ``batch_rows``, the tail padded to the chunk (classes have different
    # numbers of templates x snippets).
    all_texts: list[str] = []
    counts: list[int] = []
    for classname in classnames:
        ktexts = knowledge_texts(
            task, classname, use_wiki=use["wiki"], use_wordnet=use["wordnet"],
            use_hierarchy=use["hierarchy"], use_gpt3=use["gpt3"], n_gpt3=n_gpt3,
            aggregation=aggregation)
        if ktexts:
            texts = [t.format(classname) + k for k in ktexts for t in templates]
        else:
            texts = [t.format(classname) for t in templates]
        all_texts.extend(texts)
        counts.append(len(texts))

    ids = np.asarray(tokenize(all_texts, context_length=clip_cfg.context_length, truncate=True))
    device = backbone["text"]["token_embedding"].device
    n_rows = len(ids)
    chunk = min(batch_rows, n_rows)
    embs = []
    for i in range(0, n_rows, chunk):
        part = ids[i:i + chunk]
        pad = chunk - len(part)
        if pad:  # the tail padded to the chunk's shape
            part = np.concatenate([part, np.repeat(part[-1:], pad, 0)])
        emb = clip_core.encode_text(backbone, torch.from_numpy(part).to(device), clip_cfg).float()
        emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
        embs.append(emb[:chunk - pad])
    flat = torch.cat(embs)

    feats, start = [], 0
    for n in counts:
        mean = flat[start:start + n].mean(dim=0)
        feats.append(mean / torch.linalg.norm(mean))
        start += n
    return torch.stack(feats)
