"""``mfu.train``: the captured train step's model FLOPs (the forward
once, the backward twice, nothing recomputed; convs from the
configuration's shapes, ``counts/shapes.py``) over the traced steps'
time, against the published dense peak of the dtype they run in (989
TFLOP/s bf16, 67 TFLOP/s f32 with TF32 off), in %."""

from counts import shapes


def read(run):
    tr = run["trace"]
    if run["kind"] != "train" or tr.window_s <= 0:
        return None
    flops = shapes.train_flops(run["cfg"]["model"], run["batch"])
    return 100.0 * shapes.peak_seconds(flops) * run["units"] / tr.window_s
