"""``postprocess_ms.eval``: host ms of the port's confidence filter and
NMS (``ops/boxes.py:postprocess``) a batch, timed from the benchmark's
own call on the outputs the traced window's forwards produced."""


def read(run):
    return run.get("postprocess_ms") if run["kind"] == "eval" else None
