"""``neck_head_ms.eval``: device ms a batch of the neck_head of ``detect``'s
forward, from CUDA events recorded by forward hooks that the benchmark
sets on the port's modules (``chip_smoke.py:layer_times``'s method; the
neck and head as the PAFPN minus its CSPDarknet, plus the head)."""


def read(run):
    if run["kind"] != "eval":
        return None
    return run["layer_ms"]["neck_head"]
