"""Modules of the port's detector (eval forward), NCHW inside."""

from .blocks import BaseConv, Neuron
from .embedding import ARSNNEmbedding
from .yolox import EASYOLOX

__all__ = ["ARSNNEmbedding", "BaseConv", "EASYOLOX", "Neuron"]
