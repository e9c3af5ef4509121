"""eval_img_s: every image whose logits reached the host in the measured
window, over the window's wall time (host clock, ending when the last
batch's logits were read)."""


def read(run):
    if run.cell.traffic["kind"] != "cached_eval":
        return None
    return run.window["images"] / run.window["seconds"]
