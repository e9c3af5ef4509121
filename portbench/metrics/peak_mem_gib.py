"""peak_mem_gib: torch.cuda.max_memory_allocated() over the whole run up
to the window's close (set-up, warm-up and the window), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
