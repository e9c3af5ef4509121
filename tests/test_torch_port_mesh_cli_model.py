"""The port's training CLI on two ranks under TPU.MESH_MODEL 2
TPU.MESH_DATA 1 (the model axis: both towers sharded, 2 heads a tower),
against the JAX CLI under the same mesh and against the port's own
single-rank CLI, fp32 on the CPU: the set-up and the bounds of
tests/test_torch_port_mesh_cli.py (per-step losses within 1e-4 relative,
the final prompts within 1e-4 x max|leaf|, every ``results`` value within
one test sample; both ranks' ``results`` lines equal; only rank 0 wrote
files). Besides, on the same two ranks, FinetuneCLIP raises."""

import pytest

from tests.test_torch_port_mesh_cli import (  # noqa: F401 (fixture)
    check_matches_jax, check_matches_single, check_only_rank_0_writes, mesh_runs, world)
from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def runs(world):  # noqa: F811
    return mesh_runs(world, "model")


def test_mesh_cli_matches_jax_cli_on_the_same_mesh(runs):
    check_matches_jax(runs, "model")


def test_mesh_cli_matches_the_single_rank_cli(runs):
    check_matches_single(runs, "model")


def test_only_rank_0_writes(runs, world):  # noqa: F811
    check_only_rank_0_writes(runs, world, "model")


def test_finetune_on_two_ranks_raises(runs):
    ranks, _ = runs
    for rank in ranks:
        assert rank["ft"]["raised"].startswith("NotImplementedError: FinetuneCLIP runs on one "
                                               "rank")
