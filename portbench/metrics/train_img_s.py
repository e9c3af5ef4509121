"""train_img_s: every image of every step completed in the measured
window, over the window's wall time (host clock ending in
torch.cuda.synchronize() after the last whole window)."""


def read(run):
    if run.cell.traffic["kind"] != "train_window":
        return None
    return run.window["images"] / run.window["seconds"]
