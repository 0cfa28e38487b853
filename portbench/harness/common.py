"""What every driver's set-up shares: the program's experiment, the
reference's structure, the weights made from the seed, the calibration,
the reference built on the card for the check, and the numerical
settings each side runs under."""

from __future__ import annotations

import gc

import torch

from reference.model import Detector, precision, spiking_sites
from . import traffic, weights


def ref_structure(cfg: dict, dtype: str) -> Detector:
    """The reference's modules on the meta device (names and shapes)."""
    with torch.device("meta"):
        return Detector(cfg, precision(dtype))


def ref_on(cfg: dict, dtype: str, sd: dict, device) -> Detector:
    """The reference in ``dtype`` on ``device`` holding ``sd``."""
    ref = ref_structure(cfg, dtype).to_empty(device=device)
    ref.load_state_dict(sd)
    return ref


def reference_numerics(dtype: str) -> None:
    """The reference computes f32 in IEEE f32 (TF32 off), unless it is the
    TF32 control; cuDNN deterministic, as the program's captured step."""
    tf32 = precision(dtype).tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = True


def state(cfg: dict, seed: int, device) -> dict:
    """The state dict drawn from the seed."""
    gen = torch.Generator(device=device).manual_seed(traffic.seeded(seed, 1))
    return weights.make_state(ref_structure(cfg, cfg["model"]["dtype"]),
                              gen, device)


def calibrated(cfg: dict, sd: dict, events: torch.Tensor, device) -> dict:
    """``sd`` with its spiking sites' BN calibrated on ``events`` by the
    reference (in the configuration's precision, f32 without TF32)."""
    reference_numerics(cfg["model"]["dtype"])
    ref = ref_on(cfg, cfg["model"]["dtype"], sd, device)
    weights.calibrate(ref, spiking_sites(ref), events)
    out = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref
    return out


def program_exp(cfg: dict):
    """The port's preset with the configuration file's sizes (as it is
    run), its precision applied."""
    from eas_snn_tpu_torch.exp.build import get_exp

    m = cfg["model"]
    exp = get_exp(cfg["preset"])
    exp.depth, exp.width = m["depth"], m["width"]
    exp.num_classes = m["num_classes"]
    exp.input_size = exp.test_size = tuple(m["input_size"])
    exp.Tl, exp.Tm, exp.Ts, exp.T = m["Tl"], m["Tm"], m["Ts"], m["T"]
    exp.compute_dtype = m["dtype"]
    exp.apply_precision()
    return exp


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device="cuda") -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
