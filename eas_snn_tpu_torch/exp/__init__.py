from .event_exp import EventExp, detect, get_exp, resolve_device

__all__ = ["EventExp", "detect", "get_exp", "resolve_device"]
