"""Weights into the port: from the JAX package's variable tree, and from the
reference's PyTorch checkpoints.

The port's parameter names are the reference PyTorch model's, spikingjelly
tokens included (``stem.0.conv.conv.weight``, ``dark2.0.conv.0.weight``,
``...act.w``, ``embedding.input_conv.{0,2}.weight``), so a reference
``.pth`` loads by key, strictly. ``state_dict_from_jax`` maps the JAX
package's ``{"params", "batch_stats"}`` tree (numpy leaves) onto those
names; it is the inverse of the JAX package's importer, whose name logic
this module keeps its own copy of.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "load_reference_state_dict"]

# JAX module name -> reference torch path tokens
_DARK = {
    "dark2_conv": ("dark2", "0"), "dark2_csp": ("dark2", "1"),
    "dark3_conv": ("dark3", "0"), "dark3_csp": ("dark3", "1"),
    "dark4_conv": ("dark4", "0"), "dark4_csp": ("dark4", "1"),
    "dark5_conv": ("dark5", "0"), "dark5_spp": ("dark5", "1"),
    "dark5_csp": ("dark5", "2"),
}
_HEAD = (
    (re.compile(r"stem(\d+)$"), lambda m: ("stems", m[1])),
    (re.compile(r"(cls|reg)_conv(\d+)_(\d+)$"),
     lambda m: (f"{m[1]}_convs", m[2], m[3])),
    (re.compile(r"(cls|reg|obj)_pred(\d+)$"),
     lambda m: (f"{m[1]}_preds", m[2])),
)
# Darknet (models/yolo_fpn.py) module names -> reference tokens; the SPP
# tail continues dark5's indices after its n5 ResLayers
_DARKNET = (
    (re.compile(r"stem_conv$"), lambda m, n5: ("stem", "0")),
    (re.compile(r"stem_res_down$"), lambda m, n5: ("stem", "1")),
    (re.compile(r"stem_res_res(\d+)$"),
     lambda m, n5: ("stem", str(2 + int(m[1])))),
    (re.compile(r"(dark\d)_down$"), lambda m, n5: (m[1], "0")),
    (re.compile(r"(dark\d)_res(\d+)$"),
     lambda m, n5: (m[1], str(1 + int(m[2])))),
    (re.compile(r"dark5_spp(\d)$"),
     lambda m, n5: ("dark5", str(1 + n5 + int(m[1])))),
    (re.compile(r"(out[12])_(\d)$"), lambda m, n5: (m[1], m[2])),
)
# embedding leaves: (input|gate)_conv_agg of split, the conv stacks of the
# arsnn / rsnn samplers and of the snn embedding (as the reference's
# tdLayer, embedding_conv.layer)
_EMB_AGG = re.compile(r"(input_conv_agg|gate_conv_agg)_(kernel|bias)0$")
_EMB = re.compile(r"(input_conv|gate_conv|conv)_(kernel|bias)(\d+)$")
_EMB_STACK = {"input_conv": "input_conv", "gate_conv": "gate_conv",
              "conv": "embedding_conv.layer"}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _module_tokens(path: Tuple[str, ...], n5: int = -1) -> list:
    """JAX module path -> reference torch module tokens; ``n5`` is the
    ResLayer count of a Darknet's dark5 (-1: no Darknet)."""
    out = []
    for i, p in enumerate(path):
        if n5 >= 0 and any(pat.match(p) for pat, _ in _DARKNET):
            pat, fn = next((pat, fn) for pat, fn in _DARKNET if pat.match(p))
            out += fn(pat.match(p), n5)
        elif p in _DARK:
            out += _DARK[p]
        elif p == "stem" and path[:i] == ("backbone", "backbone"):
            out += ["stem", "0"]  # the whole-Focus SeqToANNContainer
        elif p == "PLIF_0":
            out.append("act")
        elif re.fullmatch(r"m\d+", p):
            out += ["m", p[1:]]
        else:
            for pat, fn in _HEAD:
                m = pat.match(p)
                if m and path[:1] == ("head",):
                    out += fn(m)
                    break
            else:
                out.append(p)
    return out


def state_dict_from_jax(variables: Mapping[str, Any], model=None
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's EASYOLOX variables (``{"params", "batch_stats"}``
    of numpy arrays), or those of its YOLOv3 (YOLOFPN over Darknet), as
    the port's state dict. Conv kernels go HWIO -> OIHW (a depthwise
    kernel (k, k, 1, C) to (C, 1, k, k)); every BN gains
    ``num_batches_tracked`` = 0. With a channel-sharded ``model``
    (``parallel.mesh.channel_shard_params``) the state dict holds this
    process's slices, by the same rule, ready for its
    ``load_state_dict``."""
    sd = _state_dict_from_jax(variables)
    if model is None:
        return sd
    from ..parallel.mesh import shard_state
    return shard_state(model, sd)


def _state_dict_from_jax(variables: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    params = variables["params"]
    n5 = -1  # dark5's ResLayers where the tree holds a Darknet
    for path, _ in _leaves(params):
        if "stem_conv" in path:
            darknet = params
            for p in path[:path.index("stem_conv")]:
                darknet = darknet[p]
            n5 = sum(k.startswith("dark5_res") for k in darknet)
            break
    spiking = set()  # JAX paths of BaseConvs that hold a PLIF
    for path, _ in _leaves(params):
        if "PLIF_0" in path:
            spiking.add(path[:path.index("PLIF_0")])
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        value = np.asarray(value)
        leaf, mod = path[-1], path[:-1]
        if mod == ("embedding",):
            m = _EMB_AGG.match(leaf)
            if m:
                name = f"embedding.{m[1]}." + (
                    "weight" if m[2] == "kernel" else "bias")
                sd[name] = _to_torch(value, m[2] == "kernel")
                continue
            m = _EMB.match(leaf)
            if m:
                # conv[ReLU conv]*: the i-th conv sits at Sequential index 2i
                name = f"embedding.{_EMB_STACK[m[1]]}.{2 * int(m[3])}." + (
                    "weight" if m[2] == "kernel" else "bias")
                sd[name] = _to_torch(value, m[2] == "kernel")
                continue
        tokens = _module_tokens(mod, n5)
        if mod[-1:] == ("bn",) or mod == ("emb_bn",):
            tokens.append(_BN[leaf])
        elif leaf == "alpha" and mod[-1:] == ("PLIF_0",):
            # patan's learnable alpha; a 'neuron' one (H, W, C) -> (C, H, W)
            tokens.append("asgl_alpha")
            if value.ndim == 3:
                value = value.transpose(2, 0, 1)
        elif leaf == "kernel":
            if mod[-1:] == ("conv",) and mod[:-1] in spiking:
                tokens.append("0")  # SeqToANNContainer around the conv
            tokens.append("weight")
        else:  # conv bias, PLIF w
            tokens.append(leaf)
        sd[".".join(tokens)] = _to_torch(value, leaf == "kernel")
    for path, value in _leaves(variables.get("batch_stats", {})):
        tokens = _module_tokens(path[:-1], n5)
        sd[".".join(tokens + [_BN[path[-1]]])] = _to_torch(np.asarray(value))
        if path[-1] == "mean":
            sd[".".join(tokens + ["num_batches_tracked"])] = torch.tensor(0)
    return sd


def _to_torch(value: np.ndarray, kernel: bool = False) -> torch.Tensor:
    if kernel:
        value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return torch.from_numpy(np.array(value, np.float32, order="C"))


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` (a state dict, or one under ``'model'``, keys
    possibly ``module.``-prefixed by DDP) as a plain state dict, for
    ``model.load_state_dict(sd, strict=True)``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("model", obj)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}
