"""The port's detection, caption and matting metrics
(mvlpt_torch/evaluation/{detection,caption,matting}.py) against the JAX
package's, on seeded random inputs, to 1e-12; and the JAX package's own
cases of tests/test_metric_zoo.py run on the port's functions.

Detection's per-class AP runs the port's numpy copy of scikit-learn's
average precision (``evaluation.metrics._binary_average_precision``)
where the JAX package calls scikit-learn.
"""

import importlib
import inspect

import numpy as np
import pytest

TOL = 1e-12
SEEDS = range(6)


def _same(got, want):
    """Reports equal key for key, numbers within TOL (lists and dicts of
    per-class APs too)."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    else:
        assert abs(got - want) <= TOL, (got, want)


def _boxes(rng, n_images, n_classes, scored):
    """Per image a list of [label, (score,) L, T, R, B], with boxes near
    each other so that IoUs spread over the thresholds; some images
    empty."""
    out = []
    for _ in range(n_images):
        rows = []
        for _ in range(rng.randint(0, 6)):
            x, y = rng.randint(0, 40, 2)
            w, h = rng.randint(2, 30, 2)
            box = [float(x), float(y), float(x + w), float(y + h)]
            label = int(rng.randint(n_classes))
            rows.append([label, float(rng.rand())] + box if scored else [label] + box)
        out.append(rows)
    return out


def _detection_inputs(seed):
    rng = np.random.RandomState(seed)
    targets = _boxes(rng, 8, 4, scored=False)
    predictions = _boxes(rng, 8, 4, scored=True)
    # a share of predictions that copy a target box with jitter: true positives
    for img, rows in enumerate(targets):
        for t in rows[: rng.randint(0, len(rows) + 1)]:
            jitter = rng.randint(-3, 4, 4).astype(float)
            predictions[img].append([t[0], float(rng.rand())] + list(np.add(t[1:], jitter)))
    return predictions, targets


@pytest.mark.parametrize("seed", SEEDS)
def test_detection_matches_jax(seed):
    from mvlpt_tpu.evaluation import detection as jd

    from mvlpt_torch.evaluation import detection as td

    predictions, targets = _detection_inputs(seed)
    for iou in (0.3, 0.5, 0.75):
        _same(td.detection_map_single_iou(predictions, targets, iou=iou, report_tag_wise=True),
              jd.detection_map_single_iou(predictions, targets, iou=iou, report_tag_wise=True))
    tags = [True, False, True, False]
    _same(td.detection_map_multi_iou(predictions, targets, report_tag_wise=tags),
          jd.detection_map_multi_iou(predictions, targets, report_tag_wise=tags))
    for max_dets in (300, 2):
        _same(td.detection_map_coco(predictions, targets, report_tag_wise=tags,
                                    max_dets=max_dets),
              jd.detection_map_coco(predictions, targets, report_tag_wise=tags,
                                    max_dets=max_dets))


def test_detection_ap_matches_scikit_learn():
    """The per-class AP itself against the JAX package's scikit-learn call,
    ties in the scores and an all-correct sequence included."""
    from mvlpt_tpu.evaluation import detection as jd

    from mvlpt_torch.evaluation import detection as td

    rng = np.random.RandomState(0)
    for n in (1, 2, 7, 40):
        for tied in (False, True):
            scores = rng.randint(0, 4, n) / 4.0 if tied else rng.rand(n)
            for is_correct in (rng.rand(n) < 0.5, np.ones(n, bool), np.zeros(n, bool)):
                true_num = int(is_correct.sum()) + int(rng.randint(0, 3))
                _same(td._ap_sklearn(is_correct, scores, true_num),
                      jd._ap_sklearn(is_correct, scores, true_num))


_WORDS = "a the cat dog sits runs on in over park mat water bird flies red big".split()


def _sentence(rng):
    return " ".join(rng.choice(_WORDS, rng.randint(1, 9)))


@pytest.mark.parametrize("seed", SEEDS)
def test_caption_matches_jax(seed):
    from mvlpt_tpu.evaluation import caption as jc

    from mvlpt_torch.evaluation import caption as tc

    rng = np.random.RandomState(seed)
    targets = [[_sentence(rng) + ("." if rng.rand() < 0.3 else "")
                for _ in range(rng.randint(1, 4))] for _ in range(6)]
    predictions = [_sentence(rng) if rng.rand() < 0.7 else refs[0].upper()
                   for refs in targets]
    for name in ("caption_bleu", "caption_rouge_l", "caption_cider", "caption_meteor"):
        _same(getattr(tc, name)(predictions, targets), getattr(jc, name)(predictions, targets))
    for metric in ("Bleu", "ROUGE_L", "CIDEr", "METEOR"):
        _same(tc.caption_report(predictions, targets, metric),
              jc.caption_report(predictions, targets, metric))
    with pytest.raises(KeyError) as want:
        jc.caption_report(predictions, targets, "SPICE")
    with pytest.raises(KeyError) as got:
        tc.caption_report(predictions, targets, "SPICE")
    assert str(got.value) == str(want.value)


def _mask(rng, size=48):
    """A uint8 matte: a thresholded blur of noise, soft values at its edge;
    sometimes all background."""
    from scipy.ndimage import uniform_filter

    if rng.rand() < 0.15:
        return np.zeros((size, size), np.uint8)
    field = uniform_filter(rng.rand(size, size), 9)
    return np.clip((field - field.mean()) * 4000 + 128, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed", SEEDS)
def test_matting_matches_jax(seed):
    from mvlpt_tpu.evaluation import matting as jm

    from mvlpt_torch.evaluation import matting as tm

    rng = np.random.RandomState(seed)
    targets = [_mask(rng) for _ in range(5)]
    predictions = [_mask(rng) if rng.rand() < 0.7 else t for t in targets]
    for name in ("matting_mean_iou", "matting_foreground_iou", "matting_l1_error"):
        _same(getattr(tm, name)(predictions, targets), getattr(jm, name)(predictions, targets))
    for name in ("matting_boundary_mean_iou", "matting_boundary_foreground_iou"):
        for thickness in (2, 10):
            _same(getattr(tm, name)(predictions, targets, thickness),
                  getattr(jm, name)(predictions, targets, thickness))


def _jax_cases():
    """tests/test_metric_zoo.py's cases whose every metric comes from the
    module's imports (those are swapped for the port's below)."""
    from tests import test_metric_zoo as cases

    return cases, sorted(
        name for name, fn in vars(cases).items()
        if name.startswith("test_") and callable(fn)
        and "from mvlpt_tpu" not in inspect.getsource(fn))


@pytest.mark.parametrize("name", _jax_cases()[1])
def test_jax_metric_zoo_cases_on_the_port(name, monkeypatch):
    """Each case with every function it imported from mvlpt_tpu.evaluation
    replaced by the port's namesake in mvlpt_torch.evaluation."""
    cases, _ = _jax_cases()
    swapped = 0
    for attr, value in list(vars(cases).items()):
        module = getattr(value, "__module__", None) or ""
        if callable(value) and module.startswith("mvlpt_tpu.evaluation"):
            port = importlib.import_module(module.replace("mvlpt_tpu", "mvlpt_torch", 1))
            monkeypatch.setattr(cases, attr, getattr(port, attr))
            swapped += 1
    assert swapped == 15  # 5 caption, 3 detection, 5 matting, group_wise, mean_lp_error
    getattr(cases, name)()
