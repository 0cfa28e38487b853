"""Experiments by file or by name (counterpart of
``eas_snn_tpu/exp/build.py``; reference yolox/exp/build.py:10-42).

A file is a user's Python module whose ``Exp`` class subclasses the
port's ``EventExp`` or its RGB ``YOLOXExp``; a name is one of the port's
presets (``exp/event_exp.py:_PRESETS`` and
``exp/yolox_base.py:RGB_PRESETS``; the JAX package's ``exps/`` files
import the JAX package, which the port does not import).
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys
from typing import Optional

from .event_exp import _PRESETS, EventExp
from .yolox_base import RGB_PRESETS, YOLOXExp

__all__ = ["get_exp", "get_exp_by_file", "get_exp_by_name", "exp_from_args"]

PRESETS = {**_PRESETS, **RGB_PRESETS}
_EXPS = (EventExp, YOLOXExp)

# an import of the JAX package (not of the port, eas_snn_tpu_torch)
_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+eas_snn_tpu(\.|\s|$)", re.M)


def get_exp_by_file(exp_file: str):
    """``Exp()`` of the module at ``exp_file``; its directory is on
    ``sys.path`` while it loads, so it may import its neighbours."""
    path = os.path.abspath(exp_file)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no exp file '{exp_file}'")
    with open(path) as f:
        if _JAX_IMPORT.search(f.read()):
            raise ValueError(
                f"{exp_file} imports the JAX package (eas_snn_tpu), which "
                "the port does not run; an exp file for the port subclasses "
                "eas_snn_tpu_torch.exp.EventExp or "
                "eas_snn_tpu_torch.exp.YOLOXExp")
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec = importlib.util.spec_from_file_location(
            os.path.basename(path).split(".")[0], path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.pop(0)
    cls = getattr(module, "Exp", None)
    if not (isinstance(cls, type) and issubclass(cls, _EXPS)):
        raise TypeError(f"{exp_file}: its 'Exp' must subclass the port's "
                        "EventExp or YOLOXExp (eas_snn_tpu_torch.exp)")
    return cls()


def get_exp_by_name(exp_name: str):
    """The port's preset ``exp_name`` ('-' and '_' alike)."""
    key = exp_name.replace("-", "_")
    if key not in PRESETS:
        raise KeyError(f"unknown exp '{exp_name}'; the port has "
                       f"{sorted(PRESETS)}")
    return PRESETS[key]()


def get_exp(exp_file: Optional[str] = None,
            exp_name: Optional[str] = None):
    """An experiment from ``exp_file``, else the preset ``exp_name``. A
    first argument that is no ``.py`` path is read as a name, so that
    ``get_exp("gen1_syolox_m")`` names a preset."""
    if exp_file is not None and not exp_file.endswith(".py"):
        exp_file, exp_name = None, exp_file
    if exp_file is not None:
        return get_exp_by_file(exp_file)
    if exp_name is None:
        raise ValueError("get_exp: pass an exp file or an exp name")
    return get_exp_by_name(exp_name)


def exp_from_args(exp_file: Optional[str], exp_name: Optional[str]):
    """``get_exp`` for a command line (``-f`` / ``-n``): what it refuses
    becomes a ``SystemExit`` with the reason."""
    if not exp_file and not exp_name:
        raise SystemExit("-f or -n: an exp file (whose Exp subclasses the "
                         "port's EventExp or YOLOXExp) or a preset of "
                         f"{sorted(PRESETS)}")
    try:
        return get_exp(exp_file or None, exp_name)
    except (LookupError, TypeError, ValueError, FileNotFoundError) as e:
        raise SystemExit(f"{'-f' if exp_file else '-n'}: {e}")
