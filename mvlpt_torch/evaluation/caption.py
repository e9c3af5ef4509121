"""Image-caption metrics (host-side, pure Python/numpy).

The counterpart of ``mvlpt_tpu/evaluation/caption.py``, line for line.
Rebuilds the captioning tail of the reference's evaluator zoo
(trainers/vision_benchmark/datasets/metrics.py:901-989:
Bleu/METEOR/ROUGE_L/CIDEr evaluators).  The reference classes delegate
scoring to ``from .coco_evalcap_utils import ...`` (metrics.py:926) — a
module that does not exist in the reference tree, i.e. the in-tree tail
is dead code.  This module implements the metrics those wrappers name,
following the COCO caption-evaluation protocol
(github.com/tylin/coco-caption) directly:

* ``caption_bleu``    — corpus BLEU-1..4, clipped n-gram precision with
  per-image closest-reference-length brevity penalty (coco-caption
  bleu_scorer semantics, option='closest').
* ``caption_rouge_l`` — LCS F-measure, beta=1.2, per image the max
  precision / max recall over references (coco-caption rouge.py).
* ``caption_cider``   — CIDEr-D: tf-idf weighted n-gram cosine
  similarity, n=1..4, gaussian length penalty sigma=6, x10 scaling
  (coco-caption cider_scorer.py).
* ``caption_meteor``  — exact-match METEOR: unigram alignment, harmonic
  mean weighted 9:1 toward recall, fragmentation penalty
  0.5*(chunks/matches)^3.  The full METEOR jar adds stem/synonym/
  paraphrase matching stages (external Java + WordNet data); this
  implements the exact-match stage only, which is the dominant term on
  caption-length text.  Deviation documented here deliberately.

SPICE (metrics.py:980-988) is NOT implemented: it requires the Stanford
scene-graph parser (external Java toolchain) even in the reference's
ecosystem, and the reference's own wrapper cannot run in-tree.
``caption_report`` raises KeyError for it, the same failure shape as
``get_metric`` for unknown names.

Inputs follow the reference evaluator interface (metrics.py:909-920):
``predictions`` is a list of N candidate strings; ``targets`` is a list
of N lists of reference strings.  Tokenization is lowercase,
punctuation-stripped whitespace splitting — a deterministic stand-in
for the PTBTokenizer jar the COCO toolkit shells out to.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict

import numpy as np

__all__ = [
    "caption_bleu",
    "caption_rouge_l",
    "caption_cider",
    "caption_meteor",
    "caption_report",
]

_PUNCT = re.compile(r"[^\w\s]")


def _tokenize(s: str) -> list:
    return _PUNCT.sub(" ", s.lower()).split()


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# --------------------------------------------------------------------------
# BLEU
# --------------------------------------------------------------------------

def caption_bleu(predictions, targets, max_n: int = 4) -> dict:
    """Corpus BLEU-1..max_n with closest-reference brevity penalty."""
    assert len(predictions) == len(targets)
    clipped = np.zeros(max_n)
    total = np.zeros(max_n)
    cand_len = 0
    eff_ref_len = 0
    for cand, refs in zip(predictions, targets):
        c = _tokenize(cand)
        rs = [_tokenize(r) for r in refs]
        cand_len += len(c)
        # closest reference length (ties -> shorter), coco bleu 'closest'
        eff_ref_len += min((abs(len(r) - len(c)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            cn = _ngrams(c, n)
            if not cn:
                continue
            best = Counter()
            for r in rs:
                rn = _ngrams(r, n)
                for g, cnt in rn.items():
                    best[g] = max(best[g], cnt)
            clipped[n - 1] += sum(min(cnt, best[g]) for g, cnt in cn.items())
            total[n - 1] += sum(cn.values())
    bp = 1.0 if cand_len > eff_ref_len else math.exp(
        1.0 - eff_ref_len / max(cand_len, 1e-9))
    report = {}
    log_sum = 0.0
    for n in range(1, max_n + 1):
        # coco-caption bleu_scorer smoothing: tiny (1e-15) in the
        # numerator over small (1e-9) in the denominator, so an order
        # with zero candidate n-grams contributes ~1e-6 precision —
        # equal epsilons would score it 1.0 and inflate Bleu_3/4 on
        # short captions
        p = (clipped[n - 1] + 1e-15) / (total[n - 1] + 1e-9)
        log_sum += math.log(p)
        report[f"Bleu_{n}"] = float(bp * math.exp(log_sum / n))
    return report


# --------------------------------------------------------------------------
# ROUGE-L
# --------------------------------------------------------------------------

def _lcs_len(a, b) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def caption_rouge_l(predictions, targets, beta: float = 1.2) -> dict:
    """ROUGE-L F-measure averaged over images (coco-caption rouge.py:
    per image, max LCS precision and max LCS recall over references)."""
    assert len(predictions) == len(targets)
    scores = []
    for cand, refs in zip(predictions, targets):
        c = _tokenize(cand)
        prec, rec = [], []
        for r in refs:
            rt = _tokenize(r)
            lcs = _lcs_len(c, rt)
            prec.append(lcs / len(c) if c else 0.0)
            rec.append(lcs / len(rt) if rt else 0.0)
        p, r = max(prec), max(rec)
        if p + r > 0:
            scores.append(((1 + beta ** 2) * p * r) / (r + beta ** 2 * p))
        else:
            scores.append(0.0)
    return {"ROUGE_L": float(np.mean(scores)) if scores else 0.0}


# --------------------------------------------------------------------------
# CIDEr-D
# --------------------------------------------------------------------------

def caption_cider(predictions, targets, n: int = 4, sigma: float = 6.0) -> dict:
    """CIDEr-D (coco-caption cider_scorer.py): per-n tf-idf cosine with
    count clipping and gaussian length penalty, averaged over n and
    references, scaled by 10."""
    assert len(predictions) == len(targets)
    num_images = len(targets)
    if num_images == 0:
        return {"CIDEr": 0.0}

    # Document frequency over the reference corpus: an n-gram counts
    # once per image in which any reference contains it.
    doc_freq = defaultdict(float)
    ref_grams = []   # per image: list of per-reference [Counter_1..Counter_n]
    for refs in targets:
        per_ref = []
        seen = set()
        for r in refs:
            toks = _tokenize(r)
            grams = [_ngrams(toks, k) for k in range(1, n + 1)]
            per_ref.append((grams, len(toks)))
            for g in grams:
                seen.update(g.keys())
        for g in seen:
            doc_freq[g] += 1.0
        ref_grams.append(per_ref)

    log_ref = math.log(max(num_images, 1e-9))

    def vecs(grams_per_n):
        out, norms = [], []
        for k in range(n):
            v = {}
            sq = 0.0
            for g, cnt in grams_per_n[k].items():
                idf = log_ref - math.log(max(1.0, doc_freq[g]))
                w = float(cnt) * idf
                v[g] = w
                sq += w * w
            out.append(v)
            norms.append(math.sqrt(sq))
        return out, norms

    scores = []
    for (cand, refs_info) in zip(predictions, ref_grams):
        toks = _tokenize(cand)
        cand_grams = [_ngrams(toks, k) for k in range(1, n + 1)]
        cvec, cnorm = vecs(cand_grams)
        per_ref_scores = np.zeros(n)
        for rgrams, rlen in refs_info:
            rvec, rnorm = vecs(rgrams)
            delta = float(len(toks) - rlen)
            for k in range(n):
                num = 0.0
                for g, w in cvec[k].items():
                    if g in rvec[k]:
                        # CIDEr-D clips candidate weight at the reference's
                        num += min(w, rvec[k][g]) * rvec[k][g]
                denom = cnorm[k] * rnorm[k]
                val = num / denom if denom > 0 else 0.0
                val *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                per_ref_scores[k] += val
        nrefs = max(len(refs_info), 1)
        scores.append(float(np.mean(per_ref_scores / nrefs)) * 10.0)
    return {"CIDEr": float(np.mean(scores)) if scores else 0.0}


# --------------------------------------------------------------------------
# METEOR (exact-match stage)
# --------------------------------------------------------------------------

def _align_greedy(cand, ref):
    """Greedy left-to-right exact alignment (fallback for pathological
    duplicate-heavy inputs); returns list of (cand_idx, ref_idx)."""
    used = set()
    matches = []
    for i, w in enumerate(cand):
        for j, r in enumerate(ref):
            if j not in used and r == w:
                used.add(j)
                matches.append((i, j))
                break
    return matches


_ALIGN_NODE_CAP = 20000


def _align(cand, ref):
    """Maximum exact matching that MINIMIZES the METEOR chunk count —
    the official matcher's objective (the fragmentation penalty is
    defined over the minimum-chunk alignment; a greedy alignment can
    report more chunks for the same matches and understate the score).
    Exhaustive DFS with per-word match quotas; captions are short and
    duplicates rare, with a node cap falling back to greedy."""
    cr = Counter(ref)
    quota = {w: min(c, cr[w]) for w, c in Counter(cand).items() if w in cr}
    if not quota:
        return []
    opts = [[j for j, r in enumerate(ref) if r == w] if w in quota else []
            for w in cand]
    remaining = Counter(w for w in cand if w in quota)

    best = {"chunks": None, "matches": None, "nodes": 0}

    def dfs(i, used, matched, acc):
        """Returns False once the node cap is hit (search incomplete)."""
        best["nodes"] += 1
        if best["nodes"] > _ALIGN_NODE_CAP:
            return False
        if i == len(cand):
            # the DFS objective and the reported fragmentation penalty
            # must count chunks identically — single definition
            c = _chunks(acc)
            if best["chunks"] is None or c < best["chunks"]:
                best["chunks"], best["matches"] = c, list(acc)
            return True
        w = cand[i]
        if w not in quota:
            return dfs(i + 1, used, matched, acc)
        remaining[w] -= 1  # this occurrence leaves the future pool
        ok = True
        if matched[w] < quota[w]:
            for j in opts[i]:
                if j in used:
                    continue
                used.add(j)
                matched[w] += 1
                acc.append((i, j))
                ok = dfs(i + 1, used, matched, acc)
                acc.pop()
                matched[w] -= 1
                used.discard(j)
                if not ok:
                    break
        # skipping this occurrence is legal only if later occurrences
        # can still fill the word's match quota (max cardinality)
        if ok and matched[w] + remaining[w] >= quota[w]:
            ok = dfs(i + 1, used, matched, acc)
        remaining[w] += 1
        return ok

    completed = dfs(0, set(), Counter(), [])
    if not completed and best["matches"] is None:
        return _align_greedy(cand, ref)
    if not completed:
        # cap hit mid-search: keep the best complete alignment found if
        # it has maximum cardinality, else fall back
        g = _align_greedy(cand, ref)
        if len(best["matches"]) < len(g):
            return g
    return best["matches"]


def _chunks(matches) -> int:
    """Number of maximal runs where both indices advance by one."""
    if not matches:
        return 0
    runs = 1
    for (pi, pj), (ci, cj) in zip(matches, matches[1:]):
        if ci != pi + 1 or cj != pj + 1:
            runs += 1
    return runs


def caption_meteor(predictions, targets) -> dict:
    """Exact-match METEOR averaged over images; per image the max score
    over references (see module docstring for the documented deviation
    from the Java METEOR jar)."""
    assert len(predictions) == len(targets)
    scores = []
    for cand, refs in zip(predictions, targets):
        c = _tokenize(cand)
        best = 0.0
        for r in refs:
            rt = _tokenize(r)
            matches = _align(c, rt)
            m = len(matches)
            if m == 0 or not c or not rt:
                continue
            p = m / len(c)
            rc = m / len(rt)
            fmean = 10 * p * rc / (rc + 9 * p)
            penalty = 0.5 * (_chunks(matches) / m) ** 3
            best = max(best, fmean * (1 - penalty))
        scores.append(best)
    return {"METEOR": float(np.mean(scores)) if scores else 0.0}


_CAPTION_METRICS = {
    "Bleu": caption_bleu,
    "ROUGE_L": caption_rouge_l,
    "CIDEr": caption_cider,
    "METEOR": caption_meteor,
}


def caption_report(predictions, targets, metric: str) -> dict:
    """Dispatch matching the reference's per-metric evaluator classes
    (BleuScoreEvaluator etc., metrics.py:941-988). Unknown names
    (including SPICE — see module docstring) raise KeyError."""
    if metric not in _CAPTION_METRICS:
        raise KeyError(
            f"Unknown caption metric {metric!r}; known: "
            f"{sorted(_CAPTION_METRICS)} (SPICE requires the external "
            f"Stanford scene-graph toolchain and is deliberately absent)")
    return _CAPTION_METRICS[metric](predictions, targets)
