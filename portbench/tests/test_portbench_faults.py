"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have, under the cells' own limits; the
control (the reference in float8 in the program's place) fails them too.
The card's checks are skipped: the runs are on the CPU at tiny sizes.
(One chip: no exchange between chips to leave out.)"""

import sys

import pytest
from conftest import EVAL, TRAIN, tiny_cell

from portbench import bench

TRAIN_CELLS = [("tiny_upt", TRAIN, "c100.train"),
               ("tiny_upt_multitask", dict(TRAIN, labels="task_proportional"),
                "elevater20.train")]


def _correct(cell):
    return bench.run(cell, 2 ** 31 + 19, 0.2, False, device="cpu", log=sys.stderr)["correct"]


@pytest.mark.parametrize("config,traffic,limits", TRAIN_CELLS + [("tiny_upt", EVAL, "c100.eval")])
def test_sound_run_is_correct(config, traffic, limits):
    assert _correct(tiny_cell(config, traffic, limits))


@pytest.mark.parametrize("config,traffic,limits", TRAIN_CELLS)
def test_state_left_unchanged(config, traffic, limits, monkeypatch):
    from mvlpt_torch.train import train_step

    def frozen(params, grads, opt):   # counts the update and changes nothing
        opt.count.add_(1)

    monkeypatch.setattr(train_step, "device_update_", frozen)
    assert not _correct(tiny_cell(config, traffic, limits))


@pytest.mark.parametrize("config,traffic,limits", TRAIN_CELLS)
def test_half_the_batch_left_out(config, traffic, limits, monkeypatch):
    from mvlpt_torch.train import train_step

    whole = train_step.soft_cross_entropy

    def half(logits, labels):
        n = logits.shape[0] // 2
        return whole(logits[:n], labels[:n])

    monkeypatch.setattr(train_step, "soft_cross_entropy", half)
    assert not _correct(tiny_cell(config, traffic, limits))


def test_answer_altered(monkeypatch):
    from mvlpt_torch.core import clip

    exact = clip.clip_logits

    def altered(image_features, text_features, logit_scale):
        out = exact(image_features, text_features, logit_scale)
        out[0, 0] += 1.0
        return out

    monkeypatch.setattr(clip, "clip_logits", altered)
    assert not _correct(tiny_cell("tiny_upt", EVAL, "c100.eval"))


@pytest.mark.parametrize("config,traffic,limits", TRAIN_CELLS + [("tiny_upt", EVAL, "c100.eval")])
def test_control_fails_the_limits_on_the_cpu(config, traffic, limits):
    """The control follows what the program did, from the same starting
    points; the program passes and the control does not."""
    from portbench import check, control

    cell = tiny_cell(config, traffic, limits)
    got = control.readings(cell, 2 ** 31 + 23, 0.2, device="cpu")
    assert check.judge(got["program"], cell.limits)[0], got["program"]
    assert not check.judge(got["control_fp8"], cell.limits)[0], got["control_fp8"]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["c100.train", "elevater20.train", "c100.eval"])
def test_control_fails_the_limits_on_the_card(workload, card):
    """At the cell's own size, after a short window: the program passes,
    and the control and each of the loop's faults fail the cell's
    limits."""
    from portbench import check, control

    cell = bench.find_cell(workload)
    got = control.readings(cell, 2 ** 31 + 29, 1.0)
    assert check.judge(got.pop("program"), cell.limits)[0]
    for name, numbers in got.items():
        assert not check.judge(numbers, cell.limits)[0], (name, numbers)
