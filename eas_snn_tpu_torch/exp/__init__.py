from .base_exp import BaseExp
from .build import get_exp, get_exp_by_file, get_exp_by_name
from .event_exp import EventExp, detect, resolve_device

__all__ = ["BaseExp", "EventExp", "detect", "get_exp", "get_exp_by_file",
           "get_exp_by_name", "resolve_device"]
