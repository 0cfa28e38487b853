"""The experiment contract (counterpart of ``eas_snn_tpu/exp/base_exp.py``;
reference yolox/exp/base_exp.py:16-90): an experiment is a Python class
that holds every knob; command-line ``key value`` pairs override its
fields through a type-coercing ``merge``; the factories are its methods.
"""

from __future__ import annotations

import ast
import pprint
from abc import ABC, abstractmethod
from typing import Sequence

__all__ = ["BaseExp"]


class BaseExp(ABC):
    seed = None
    output_dir = "./outputs"
    print_interval = 100
    eval_interval = 10
    dataset = None

    def merge(self, cfg_list: Sequence[str]) -> "BaseExp":
        """Command-line 'key value' overrides, each value coerced to the
        type of the field it replaces (reference base_exp.py:67-90). A
        field that is None (``seed``, ``data_dir``) takes the value as a
        Python literal where it parses as one (``seed 5`` an int), else as
        the string: the JAX package keeps the string, which its trainer
        cannot seed from."""
        if len(cfg_list) % 2:
            raise ValueError("overrides must be 'key value' pairs, got "
                             f"{list(cfg_list)}")
        for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
            k = k[2:] if k.startswith("--") else k
            if not hasattr(self, k):
                raise KeyError(f"unknown config key '{k}'")
            if not isinstance(getattr(self, k), str):
                try:
                    v = ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    pass
            setattr(self, k, v)
        return self

    def __repr__(self) -> str:
        items = {k: v for k, v in vars(self).items()
                 if not k.startswith("_") and not callable(v)}
        cls_items = {k: getattr(self, k) for k in dir(type(self))
                     if not k.startswith("_")
                     and not callable(getattr(type(self), k, None))
                     and not isinstance(getattr(type(self), k, None),
                                        property)
                     and k not in items}
        return pprint.pformat({**cls_items, **items})

    @abstractmethod
    def get_model(self, *args, **kwargs):
        ...

    @abstractmethod
    def get_dataset(self, *args, **kwargs):
        ...

    @abstractmethod
    def get_evaluator(self, *args, **kwargs):
        ...
