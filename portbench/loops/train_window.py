"""Training windows (traffic kind ``train_window``): windows of K steps
of batch B through ``make_train_step_multi``, cycled from a device pool
of ``pool_windows`` windows made from the seed.

Set-up builds the one train state and runs one whole window of the
cell's length from the seed: its first step warms up, the next is
captured into the graph that every later window replays. The loop is
closed: the next window goes out after the host has read the last one's
losses (and gradient norms, in the same read).

What the comparison reads is what the timed graph produced. Before each
window the state's leaves and momentum buffers are copied on the device
(one copy of a few MB); once the window has closed, the last measured
window's start, its per-step losses and gradient norms, and the state
after it are kept. The reference follows that window's K steps from
that start (at the learning rate of its own count of the steps before
it), and the set-up window's first FIRST_STEPS steps from the seed's
leaves: the start of the run, which the last window's snapshot skips.
"""

from __future__ import annotations

import torch

from portbench import cells

# The set-up window's first steps that the reference follows from the start.
FIRST_STEPS = 3


class Loop:
    FAULTS = ("half_batch",)

    def __init__(self, prog, traffic: dict, seed: int):
        self.prog = prog
        k, b, n = traffic["window"], traffic["batch"], traffic["pool_windows"]
        self.pool = cells.make_pool(prog.cfg, (n, k, b), traffic["labels"], seed, prog.device)
        self.steps_per_epoch = cells.steps_per_epoch(prog.cfg, traffic)
        self.k, self.b, self.n_pool = k, b, n
        self.next = self.steps = 0
        self.step = self.state = self.live = self.snap = None
        self.paths = self.start = self.first = self.last = self.kept = None
        self.got = self.origin = None

    def batches(self, j: int) -> dict:
        return {name: t[j] for name, t in self.pool.items()}

    def setup(self) -> None:
        """The train state, and one whole window of the cell's length from
        the seed (the warm-up and the capture)."""
        from mvlpt_torch.train.train_step import init_train_state, make_train_step_multi

        prog = self.prog
        self.step = make_train_step_multi(prog.model, prog.task_ranges,
                                          pre_embed=prog.cfg["pre_embed"],
                                          normalize=prog.normalize)
        self.state = init_train_state(prog.prompt_params, prog.optim, self.steps_per_epoch)
        pairs = cells.flatten(self.state.prompt_params)
        leaves = [t for _, t in pairs]
        slots = self.state.opt.slots["momentum"]
        if [s.shape for s in slots] != [t.shape for t in leaves]:
            raise RuntimeError("the optimizer's slots do not line up with the prompt leaves")
        self.live = leaves + list(slots)
        if any(t.dtype != torch.float32 for t in self.live):
            raise RuntimeError("the prompt leaves and momentum buffers are not all float32")
        self.snap = torch.empty(sum(t.numel() for t in self.live), device=prog.device)
        self.paths = [p for p, _ in pairs]
        self.start = [t.detach().to("cpu", copy=True) for t in leaves]
        self.first = self.run_window()[:, :FIRST_STEPS]

    def _packed(self, out: torch.Tensor | None = None) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1) for t in self.live], out=out)

    def run_window(self) -> torch.Tensor:
        """The next window of the pool; (2, K) losses and gradient norms,
        read by the host."""
        j, self.next = self.next, (self.next + 1) % self.n_pool
        self._packed(self.snap)
        _, metrics = self.step(self.state, self.prog.backbone, self.prog.consts, self.batches(j))
        out = torch.stack([metrics["loss"], metrics["grad_norm"]]).cpu()
        self.last = (j, self.steps, out)
        self.steps += self.k
        return out

    def measure(self, seconds: float, clock) -> dict:
        """Whole windows until ``seconds`` have passed; the clock ends in
        torch.cuda.synchronize() after the last."""
        windows = bad = 0
        t0 = clock()
        while True:
            out = self.run_window()
            windows += 1
            bad += int((~torch.isfinite(out[0])).sum())
            if clock() - t0 >= seconds:
                break
        cells.sync(self.prog.device)
        elapsed = clock() - t0
        j, count, out = self.last
        self.kept = {"window": j, "count": count, "out": out, "before": self.snap.clone(),
                     "after": self._packed()}
        steps = windows * self.k
        return {"seconds": elapsed, "windows": windows, "steps": steps,
                "images": steps * self.b, "failed": bad * self.b}

    def stretch(self) -> None:
        """One window, as the measured loop runs it (the traced stretch)."""
        self.run_window()

    def eager_step(self) -> None:
        """One train step of the cell, eagerly, on a new train state."""
        from mvlpt_torch.train.train_step import init_train_state, make_train_step

        prog = self.prog
        state = init_train_state(prog.prompt_params, prog.optim, self.steps_per_epoch)
        step = make_train_step(prog.model, prog.task_ranges, normalize=prog.normalize)
        step(state, prog.backbone, prog.consts, {name: t[0, 0] for name, t in self.pool.items()})

    def _unpack(self, flat: torch.Tensor) -> tuple[list, list]:
        parts = torch.split(flat, [t.numel() for t in self.live])
        out = [p.reshape(t.shape).cpu() for p, t in zip(parts, self.live)]
        n = len(self.paths)
        return out[:n], out[n:]

    def close(self) -> None:
        """Keep the program's output and the last window's start; drop the
        program's objects."""
        kept = self.kept
        before, momentum = self._unpack(kept["before"])
        after, after_momentum = self._unpack(kept["after"])
        self.origin = {"window": kept["window"], "count": kept["count"], "params": before,
                       "momentum": momentum}
        self.got = {"losses": torch.cat([self.first[0], kept["out"][0]]).double(),
                    "grad_norms": torch.cat([self.first[1], kept["out"][1]]).double(),
                    "momentum": after_momentum, "params": after}
        self.prog = self.step = self.state = self.live = self.snap = self.kept = None

    def follow(self, ref, fault: str | None = None) -> dict:
        """``ref`` over the set-up window's first steps from the seed's
        leaves and over the last window from its start, in the program's
        form."""
        half = fault == "half_batch"
        first = ref.train(list(zip(self.paths, self.start)), None, 0,
                          {name: t[0, :FIRST_STEPS] for name, t in self.pool.items()},
                          self.steps_per_epoch, half_batch=half)
        o = self.origin
        last = ref.train(list(zip(self.paths, o["params"])), o["momentum"], o["count"],
                         self.batches(o["window"]), self.steps_per_epoch, half_batch=half)
        return {"losses": torch.cat([first["losses"], last["losses"]]),
                "grad_norms": torch.cat([first["grad_norms"], last["grad_norms"]]),
                "momentum": last["momentum"], "params": last["params"],
                "grad_rms": last["grad_rms"]}

    def compare(self, got: dict, want: dict) -> dict:
        from portbench import check

        return check.train_readings(got, want, self.origin["params"], self.paths)
