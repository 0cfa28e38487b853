"""Experiments by file or by name (counterpart of
``eas_snn_tpu/exp/build.py``; reference yolox/exp/build.py:10-42).

A file is a user's Python module whose ``Exp`` class subclasses the
port's ``EventExp``; a name is one of the port's presets
(``exp/event_exp.py:_PRESETS``; the JAX package's ``exps/default`` files
import the JAX package, which the port does not import).
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys
from typing import Optional

from .event_exp import _PRESETS, EventExp

__all__ = ["get_exp", "get_exp_by_file", "get_exp_by_name", "exp_from_args"]

# an import of the JAX package (not of the port, eas_snn_tpu_torch)
_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+eas_snn_tpu(\.|\s|$)", re.M)


def get_exp_by_file(exp_file: str) -> EventExp:
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
                "eas_snn_tpu_torch.exp.EventExp")
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec = importlib.util.spec_from_file_location(
            os.path.basename(path).split(".")[0], path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.pop(0)
    cls = getattr(module, "Exp", None)
    if not (isinstance(cls, type) and issubclass(cls, EventExp)):
        raise TypeError(f"{exp_file}: its 'Exp' must subclass the port's "
                        "EventExp (eas_snn_tpu_torch.exp.EventExp)")
    return cls()


def get_exp_by_name(exp_name: str) -> EventExp:
    """The port's preset ``exp_name`` ('-' and '_' alike)."""
    key = exp_name.replace("-", "_")
    if key not in _PRESETS:
        raise KeyError(f"unknown exp '{exp_name}'; the port has "
                       f"{sorted(_PRESETS)}")
    return _PRESETS[key]()


def get_exp(exp_file: Optional[str] = None,
            exp_name: Optional[str] = None) -> EventExp:
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


def exp_from_args(exp_file: Optional[str], exp_name: Optional[str]
                  ) -> EventExp:
    """``get_exp`` for a command line (``-f`` / ``-n``): what it refuses
    becomes a ``SystemExit`` with the reason."""
    if not exp_file and not exp_name:
        raise SystemExit("-f or -n: an exp file (whose Exp subclasses the "
                         f"port's EventExp) or a preset of {sorted(_PRESETS)}")
    try:
        return get_exp(exp_file or None, exp_name)
    except (LookupError, TypeError, ValueError, FileNotFoundError) as e:
        raise SystemExit(f"{'-f' if exp_file else '-n'}: {e}")
