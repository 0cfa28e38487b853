"""Modules of the port's detector (eval and train), NCHW inside."""

from .blocks import BaseConv, Neuron
from .embedding import ARSNNEmbedding
from .yolox import EASYOLOX

__all__ = ["ARSNNEmbedding", "BaseConv", "EASYOLOX", "Neuron"]
