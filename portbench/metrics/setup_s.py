"""setup_s: from the start of run.py to the start of the measured window:
imports, the kernel build where the checkout has none, the weights and
inputs from the seed, the class prompts, and the warm-up of the cell's
own shapes (graph capture included)."""


def read(run):
    return run.setup_s
