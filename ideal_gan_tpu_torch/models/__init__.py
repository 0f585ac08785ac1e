"""Model zoo of the PyTorch port (the UNets, VET-Net and MDWF-Net)."""

from .attention import SelfAttention, adain
from .blocks import (ConvBlock, Norm, TEEncoder, Upsample, get_activation,
                     init_params)
from .convlstm import ConvLSTM
from .unet import MDWFNet, UNet, VETNet

__all__ = ["ConvBlock", "ConvLSTM", "MDWFNet", "Norm", "SelfAttention",
           "TEEncoder", "UNet", "Upsample", "VETNet", "adain",
           "get_activation", "init_params"]
