"""Model zoo of the PyTorch port (the AI-DEAL serving slice)."""

from .attention import SelfAttention
from .blocks import ConvBlock, Norm, Upsample, get_activation, init_params
from .convlstm import ConvLSTM
from .unet import UNet

__all__ = ["ConvBlock", "ConvLSTM", "Norm", "SelfAttention", "UNet",
           "Upsample", "get_activation", "init_params"]
