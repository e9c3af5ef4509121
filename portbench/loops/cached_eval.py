"""The cached-text eval (traffic kind ``cached_eval``):
``make_cached_text_eval`` computes the text features once at set-up,
then batches run through ``eval_fn`` by ``pipelined_inference``, the
logits read back one batch behind, cycled from a device pool of
``pool_batches`` batches made from the seed. With ``labels`` set to
"task_proportional" each image carries its task, and the logits are
those of its task's classes (multitask routing).

The comparison reads the text features computed at set-up and every
answer that reached the host in the window.
"""

from __future__ import annotations

import torch

from portbench import cells


class Loop:
    FAULTS = ()

    def __init__(self, prog, traffic: dict, seed: int):
        self.prog = prog
        self.pool = cells.make_pool(prog.cfg, (traffic["pool_batches"], traffic["batch"]),
                                    traffic.get("labels"), seed, prog.device)
        self.pool.pop("label", None)        # the eval reads images and tasks
        self.b, self.n_pool = traffic["batch"], traffic["pool_batches"]
        self.text = self.eval_fn = None
        # Every answer that reached the host, folded per pool batch: the
        # elementwise least and greatest logits over its arrivals.
        self.low: dict = {}
        self.high: dict = {}
        self.bad_rows = 0
        self.got = self.params = self.logit_scale = None

    def batch(self, j: int) -> dict:
        return {name: t[j] for name, t in self.pool.items()}

    def setup(self) -> None:
        from mvlpt_torch.train.train_step import make_cached_text_eval

        prog = self.prog
        text_fn, self.eval_fn = make_cached_text_eval(prog.model, prog.task_ranges,
                                                      normalize=prog.normalize)
        self.text = text_fn(prog.backbone, prog.prompt_params, prog.consts)
        self._run(lambda i: i < 2, record=False)

    def _run(self, more, record: bool = True) -> int:
        """Batches 0, 1, ... of the pool while ``more(i)``, one dispatch
        ahead of the read; returns the batches read."""
        from mvlpt_torch.utils.pipeline import pipelined_inference

        prog = self.prog

        def loader():
            i = 0
            while more(i):
                yield dict(self.batch(i % self.n_pool), index=i % self.n_pool)
                i += 1

        def dispatch(batch):
            return self.eval_fn(prog.backbone, prog.prompt_params, self.text,
                                {name: batch[name] for name in self.pool})

        done = 0
        for logits, batch in pipelined_inference(loader(), dispatch):
            done += 1
            if record:
                j, logits = batch["index"], torch.from_numpy(logits)
                self.bad_rows += int((~torch.isfinite(logits)).any(dim=1).sum())
                if j in self.low:
                    self.low[j] = torch.minimum(self.low[j], logits)
                    self.high[j] = torch.maximum(self.high[j], logits)
                else:
                    self.low[j] = self.high[j] = logits
        return done

    def measure(self, seconds: float, clock) -> dict:
        """Batches until ``seconds`` have passed; the clock ends when the
        last batch's logits reached the host."""
        t0 = clock()
        done = self._run(lambda i: clock() - t0 < seconds)
        elapsed = clock() - t0
        return {"seconds": elapsed, "batches": done, "images": done * self.b,
                "failed": self.bad_rows}

    def stretch(self) -> None:
        """A pass over the pool, as the measured loop runs it."""
        self._run(lambda i: i < self.n_pool, record=False)

    def eager_step(self) -> None:
        """One eval batch."""
        prog = self.prog
        self.eval_fn(prog.backbone, prog.prompt_params, self.text, self.batch(0))

    def close(self) -> None:
        """Keep the program's answers; drop its objects (the pool stays for
        the reference)."""
        self.got = {"text": self.text.float().cpu(), "low": self.low, "high": self.high}
        self.params = cells.flatten(self.prog.prompt_params)
        self.logit_scale = self.prog.backbone["logit_scale"].float().exp().item()
        self.prog = self.eval_fn = self.text = None

    def follow(self, ref, fault: str | None = None) -> dict:
        """``ref``'s text features and logits of every pool batch that the
        window answered, in the program's form."""
        from portbench import check

        text, logits = ref.eval(check.unflatten(self.params), self.pool, sorted(self.got["low"]))
        return {"text": text, "low": logits, "high": logits}

    def compare(self, got: dict, want: dict) -> dict:
        from portbench import check

        return check.eval_readings(got["text"], got["low"], got["high"], want["text"],
                                   want["low"], self.logit_scale)
