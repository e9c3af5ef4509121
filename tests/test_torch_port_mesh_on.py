"""'on' under a mesh with a model axis, against the JAX package, fp32 on
the CPU: the standalone attention (its plain twin here) on each model
rank's heads, on spawned gloo ranks of (1, 2) and (2, 2) meshes, against
the JAX package's 'on' (``pallas_attention`` in interpret mode) on a mesh
of the same shape, with the set-up and bounds of
tests/test_torch_port_mesh_plain.py."""

import pytest

from tests.test_torch_port_mesh_plain import (
    MESHES, check_block, check_cached_text_eval, check_sgd_step, spawn_and_reference)
from tests.test_torch_port_slice import sides  # noqa: F401 (fixture)
from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def spawned(sides, synthetic_vocab, tmp_path_factory):  # noqa: F811
    return spawn_and_reference("on", sides, synthetic_vocab, tmp_path_factory)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_block_forward_and_dx_match_jax(spawned, mesh):
    check_block(spawned, mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_sgd_step_matches_jax(spawned, mesh):
    check_sgd_step(spawned, mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_cached_text_eval_matches_jax(spawned, mesh):
    check_cached_text_eval(spawned, mesh)
