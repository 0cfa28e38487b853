"""Eager cost of one checkout of the port against another, on the card.

    python eager_ab.py <checkout> <label>

Run as a file (not with ``-m``), once a checkout and in turns (parent,
change, change, parent), each in a fresh process: it imports
``eas_snn_tpu_torch`` and ``chip_smoke`` from ``<checkout>``, builds the
kernels, makes ``gen1_syolox_m`` under ``deploy()`` with its BN
calibrated (``chip_smoke.calibrate_spiking_bn``), and prints one JSON
line: the deploy forward's ms at B=128, 16 and 1 (CUDA events over 20
forwards, and the host clock), and one call of the PLIF site at 8x10
(``backbone.backbone.dark5.1.conv1``, 384 channels) as the model calls
it: what a change to the wrappers or the op layer (``ops/library.py``)
costs an eager call.
"""

import json
import sys
import time


def main(checkout: str, label: str) -> dict:
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke
    from eas_snn_tpu_torch.exp import get_exp
    from eas_snn_tpu_torch.ops import _build

    if not chip_smoke.__file__.startswith(checkout):
        raise SystemExit(f"chip_smoke came from {chip_smoke.__file__}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    out = {"label": label, "build_s": time.perf_counter() - t0}
    with torch.no_grad():
        exp = get_exp("gen1_syolox_m").deploy()
        model = exp.get_model(device="cuda", seed=0)
        H, W = exp.test_size
        gen = torch.Generator(device="cuda").manual_seed(0)
        big = torch.poisson(torch.full((128, 1, 4, H, W, 2), 0.2,
                                       device="cuda"), generator=gen)
        chip_smoke.calibrate_spiking_bn(model, big[:8])
        model.eval()
        for B in (128, 16, 1):
            ev = big[:B].contiguous()
            out[f"forward_ms_B{B}"] = chip_smoke.cuda_ms(lambda: model(ev),
                                                         20, warmup=3)
            t1 = time.perf_counter()
            for _ in range(20):
                model(ev)
            torch.cuda.synchronize()
            out[f"host_ms_B{B}"] = (time.perf_counter() - t1) / 20 * 1e3
        site = dict(model.named_modules())["backbone.backbone.dark5.1.conv1"]
        x = torch.randn((384, site.bn.num_features, 8, 10),
                        device="cuda").to(torch.bfloat16)
        out["plif_call_ms_8x10"] = chip_smoke.cuda_ms(
            lambda: site.act(x, bn=site.bn.eval_terms()), 50, warmup=5)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
