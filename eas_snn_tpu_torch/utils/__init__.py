from .metric import AverageMeter, MeterBuffer, hbm_usage_gb
from .model_info import count_params, get_model_info
from .model_surgery import freeze, freeze_labels, fuse_conv_bn
from .visualize import event_frame_to_image, vis_detections
from .weights import load_reference_state_dict, state_dict_from_jax

__all__ = ["AverageMeter", "MeterBuffer", "hbm_usage_gb", "count_params",
           "get_model_info", "freeze", "freeze_labels", "fuse_conv_bn",
           "load_reference_state_dict", "state_dict_from_jax",
           "event_frame_to_image", "vis_detections"]
