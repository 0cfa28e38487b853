from .base_exp import BaseExp
from .build import get_exp, get_exp_by_file, get_exp_by_name
from .event_exp import EventExp, detect, resolve_device
from .yolox_base import YOLOXExp

__all__ = ["BaseExp", "EventExp", "YOLOXExp", "detect", "get_exp",
           "get_exp_by_file", "get_exp_by_name", "resolve_device"]
