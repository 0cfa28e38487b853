"""``idle_share.train``: the share of the traced window in which no
kernel, copy or set runs on the device (the profiler's timeline), in %."""


def read(run):
    tr = run["trace"]
    if run["kind"] != "train" or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
