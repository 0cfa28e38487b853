"""``plif_train_roofline``: the train step's PLIF kernels (table rows 7
and 8: ``plif_fwd_kernel``, ``plif_bwd``) against their roofline: the
least time the H100 needs for the work of every spiking site of a step
(``counts/shapes.py:plif_train_bound_ms``, from shapes) over the device
time of the kernels of those names in the traced steps, in %. Nothing
to read where no such kernel ran."""

from counts import shapes


def read(run):
    if run["kind"] != "train":
        return None
    tr = run["trace"]
    s = tr.kernel_s("plif_fwd_kernel")[0] + tr.kernel_s("plif_bwd")[0]
    if s <= 0:
        return None
    bound = shapes.plif_train_bound_ms(run["cfg"]["model"], run["batch"])
    return 100.0 * bound * 1e-3 * run["units"] / s
