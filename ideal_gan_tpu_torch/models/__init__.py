"""Model zoo of the PyTorch port (AI-DEAL's UNets and VET-Net)."""

from .attention import SelfAttention, adain
from .blocks import (ConvBlock, Norm, TEEncoder, Upsample, get_activation,
                     init_params)
from .convlstm import ConvLSTM
from .unet import UNet, VETNet

__all__ = ["ConvBlock", "ConvLSTM", "Norm", "SelfAttention", "TEEncoder",
           "UNet", "Upsample", "VETNet", "adain", "get_activation",
           "init_params"]
