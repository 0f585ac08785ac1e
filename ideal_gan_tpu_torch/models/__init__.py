"""Model zoo of the PyTorch port (the UNets, VET-Net and MDWF-Net, the
PI-VAE encoder and decoder, the vector quantizer, the PatchGAN and the
latent-diffusion denoiser)."""

from .attention import SelfAttention, adain
from .blocks import (ConvBlock, Norm, ResidualBlock, SameConv2d, TEEncoder,
                     Upsample, get_activation, init_params, same_padding)
from .convlstm import ConvLSTM
from .discriminator import PatchGAN, SNConv2d
from .fourier import fourier_layer
from .ldm import DenoiseUNet, sinusoidal_pos_emb
from .unet import MDWFNet, UNet, VETNet
from .vae import Decoder, Encoder
from .vq import VectorQuantizer

__all__ = ["ConvBlock", "ConvLSTM", "Decoder", "DenoiseUNet", "Encoder",
           "MDWFNet", "Norm",
           "PatchGAN", "ResidualBlock", "SNConv2d", "SameConv2d",
           "SelfAttention", "TEEncoder", "UNet", "Upsample", "VETNet",
           "VectorQuantizer", "adain", "fourier_layer", "get_activation",
           "init_params", "same_padding", "sinusoidal_pos_emb"]
