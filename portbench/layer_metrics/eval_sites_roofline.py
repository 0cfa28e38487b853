"""``eval_sites_roofline``: the eval forward's hand kernels (table rows
1-5: the PLIF kernel, the whole-site conv + BN + PLIF kernels, the
whole-scan sampler kernel) against their roofline: the least time the
H100 needs for their sites' work in a forward (``counts/shapes.py:
eval_sites_bound_ms``, from shapes and the frozen table of fused sites)
over the device time of the kernels of those names in the traced
batches, in %. Nothing to read where no such kernel ran."""

from counts import shapes


def read(run):
    if run["kind"] != "eval":
        return None
    tr = run["trace"]
    bound = shapes.eval_sites_bound_ms(run["cfg"]["model"], run["batch"])
    s = sum(tr.kernel_s(k)[0] for k in bound)
    if s <= 0:
        return None
    return 100.0 * sum(bound.values()) * 1e-3 * run["units"] / s
