"""mfu_pct.eval: the matmul FLOPs of a cached-text eval batch (the frozen
copy of utils/flops.py's eval_step_flops at the cell's shapes), times the
batches of the measured window, over the window's time, against the
card's dense peak in the compute dtype."""

from portbench import flops, roofline
from portbench.program import classnames


def read(run):
    if run.cell.traffic["kind"] != "cached_eval" or run.device.type != "cuda":
        return None
    cfg = run.cell.config
    clip = cfg["clip"]
    grid = clip["image_resolution"] // clip["vision_patch_size"]
    per_batch = flops.eval_step_flops(
        batch=run.cell.traffic["batch"], n_cls=len(classnames(cfg)),
        image_tokens=roofline.image_tokens(clip, cfg["prompt"]),
        vision_width=clip["vision_width"], vision_layers=clip["vision_layers"],
        patch_tokens=grid * grid, patch_dim=clip["vision_patch_size"] ** 2 * 3,
        embed=clip["embed_dim"])
    rate = per_batch * run.window["batches"] / run.window["seconds"]
    return 100.0 * rate / roofline.PEAK_FLOPS[cfg["compute_dtype"]]
