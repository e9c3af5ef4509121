"""text_tower_ms.train: the device time of the text side of a train step
at the cell's shapes: the port's compute_text_features forward (the
coupler, the prompt assembly, the class-packed text tower, remat as the
cell runs it) and its backward into the prompt leaves, run eagerly REPS
times under torch.profiler; the union of the device's activity over the
runs, a run. The eager calls are paced by the host, so their wall time
would read the host's launch overhead, which the captured window does not
pay."""

import torch

from portbench import trace
from portbench.cells import flatten

REPS = 5


def read(run):
    if run.cell.traffic["kind"] != "train_window" or run.device.type != "cuda":
        return None
    prog, state = run.prog, run.loop.state
    leaves = [t for _, t in flatten(state.prompt_params)]
    gen = torch.Generator(device=run.device).manual_seed(0)
    weights = None

    def text_step():
        nonlocal weights
        feats = prog.model.compute_text_features(prog.backbone, state.prompt_params, prog.consts)
        if weights is None:
            weights = torch.randn(feats.shape, generator=gen, device=run.device)
        torch.autograd.grad((feats.float() * weights).sum(), leaves, allow_unused=True)

    text_step()
    return 1e3 * trace.traced(lambda: [text_step() for _ in range(REPS)]).busy_s / REPS

