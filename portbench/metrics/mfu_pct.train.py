"""mfu_pct.train: the model's matmul FLOPs of a train step (the frozen
copy of utils/flops.py at the cell's own text length s, classes a packed
row G and image tokens; remat's recomputed forwards not counted), times
the steps of the measured window, over the window's time, against the
card's dense peak in the compute dtype."""

from portbench import flops, roofline
from portbench.program import classnames


def read(run):
    if run.cell.traffic["kind"] != "train_window" or run.device.type != "cuda":
        return None
    cfg = run.cell.config
    clip = cfg["clip"]
    n_cls = len(classnames(cfg))
    s = run.prog.text_len
    g, _ = roofline.packing(n_cls, s)
    grid = clip["image_resolution"] // clip["vision_patch_size"]
    per_step = flops.flagship_step_flops(
        batch=run.cell.traffic["batch"], n_cls=n_cls,
        image_tokens=roofline.image_tokens(clip, cfg["prompt"]),
        vision_width=clip["vision_width"], vision_layers=clip["vision_layers"],
        text_tokens_per_cls=s, text_width=clip["transformer_width"],
        text_layers=clip["transformer_layers"], text_pack_classes=g,
        patch_tokens=grid * grid, patch_dim=clip["vision_patch_size"] ** 2 * 3)
    rate = per_step * run.window["steps"] / run.window["seconds"]
    return 100.0 * rate / roofline.PEAK_FLOPS[cfg["compute_dtype"]]
