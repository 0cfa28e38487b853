"""``mfu.eval``: ``detect``'s model FLOPs (the forward's convs from the
configuration's shapes, ``counts/shapes.py``; the deployed sampler's in
f32, the rest in bf16) over the traced batches' time, against the
published dense peaks, in %."""

from counts import shapes


def read(run):
    tr = run["trace"]
    if run["kind"] != "eval" or tr.window_s <= 0:
        return None
    flops = shapes.forward_flops(run["cfg"]["model"], run["batch"])
    return 100.0 * shapes.peak_seconds(flops) * run["units"] / tr.window_s
