"""The documented launch and the pod loss check of the port's mesh, on the CPU.

``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
mvlpt_torch.cli.train --device cpu ... TPU.MESH_DATA 2`` runs as a
subprocess (its ranks join through torchrun's variables,
``parallel.maybe_initialize_distributed``, over gloo), and its ``results``
lines are the single-rank CLI's within one test sample (the set-up of
tests/test_torch_port_mesh_cli.py). ``scripts/torch_port_pod_loss_check.py``
holds K = 3 SGD steps of the tiny UPT model on (2, 1) and (1, 2) meshes
of spawned ranks to one rank's, under 'block' and 'off' in turn, at its
default tolerance of 1e-5; the two meshes' runs go at once.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_torch_port_mesh_cli import _env, _one_sample, _train_argv, world  # noqa: F401
from tests.test_torch_port_trainer import _results, _run
from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parent.parent
MESHES = ["2,1", "1,2"]
KERNELS = ["block", "off"]
TIMEOUT_S = 240


def _child_env(**extra) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_torchrun_command_runs_on_the_cpu(world, tmp_path):  # noqa: F811
    out = tmp_path / "torchrun"
    argv = _train_argv(world, out, "data")
    argv.insert(argv.index("--shots"), "--device")
    argv.insert(argv.index("--shots"), "cpu")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "mvlpt_torch.cli.train", *argv]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S,
                          env=_child_env(MVLPT_TPU_CLIP_CKPT=world["ckpt"],
                                         MVLPT_TORCH_BPE_PATH=world["vocab"]))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "multi-host: process 0/2" in proc.stdout and "multi-host: process 1/2" in proc.stdout
    assert "backend gloo (the ranks run on the CPU)" in proc.stdout
    got = _results(out)
    assert len(got) == 3  # val, val, test: rank 0's log.txt
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, world)
        _run("port", _train_argv(world, tmp_path / "single", "data"), mp)
    for a, b in zip(got, _results(tmp_path / "single")):
        _one_sample(a, b)


@pytest.fixture(scope="module")
def pod_checks(tmp_path_factory, synthetic_vocab):  # noqa: F811
    """Both meshes' pod loss checks under 'block' then 'off', run at once:
    {mesh: (rc, stdout, stderr)}."""
    work = tmp_path_factory.mktemp("pod_loss_check")
    procs = {}
    for mesh in MESHES:
        cmd = [sys.executable, str(ROOT / "scripts" / "torch_port_pod_loss_check.py"),
               "--device", "cpu", "--mesh", mesh, "--kernels", *KERNELS, "--backbone", "tiny",
               "--steps", "3", "--workdir", str(work)]
        procs[mesh] = subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_child_env(MVLPT_TORCH_BPE_PATH=synthetic_vocab))
    out = {}
    for key, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        out[key] = (proc.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("mesh", MESHES)
def test_pod_loss_check_on_the_cpu(pod_checks, mesh, kernels):
    import json

    rc, stdout, stderr = pod_checks[mesh]
    assert rc == 0, stderr[-4000:]
    assert "POD LOSS CHECK OK" in stdout
    line = json.loads(stdout.splitlines()[0])
    n_data, n_model = map(int, mesh.split(","))
    assert line["mesh"] == {"data": n_data, "model": n_model} and line["ok"]
    check = line["checks"][KERNELS.index(kernels)]
    assert check["kernels"] == kernels and check["ok"]
    assert len(check["ranks"]) == n_data * n_model
    assert all(len(r["losses"]) == 3 for r in check["ranks"])
    assert check["max_excess"] <= line["tol"]
