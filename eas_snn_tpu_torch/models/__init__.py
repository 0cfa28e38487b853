"""Modules of the port's detector (eval and train), NCHW inside, and the
model zoo (``build.py``)."""

from .blocks import BaseConv, Neuron
from .embedding import ARSNNEmbedding
from .yolox import EASYOLOX
from .build import MODEL_SPECS, ZOO_CKPTS, create_model, load_weights

__all__ = ["ARSNNEmbedding", "BaseConv", "EASYOLOX", "Neuron",
           "MODEL_SPECS", "ZOO_CKPTS", "create_model", "load_weights"]
