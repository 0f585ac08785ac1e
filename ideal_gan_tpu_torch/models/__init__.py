"""Model zoo of the PyTorch port (the UNets, VET-Net and MDWF-Net, the
PI-VAE encoder and decoders with the Flipout layers, the vector quantizer,
the discriminators, the latent-diffusion denoiser and the complex U-Net)."""

from .attention import SelfAttention, adain
from .bayes import FlipoutConv, kl_sum
from .blocks import (ConvBlock, Norm, ResidualBlock, SameConv2d, TEEncoder,
                     Upsample, get_activation, init_params, same_padding)
from .complexnn import (ComplexBatchNorm, ComplexConv, ComplexConvTranspose,
                        PMComplex, cardioid, complex_max_pool_2x2, crelu,
                        modrelu, zrelu)
from .convlstm import ConvLSTM
from .discriminator import CriticZ, FlaxBatchNorm, PatchGAN, SGAN, SNConv2d
from .fourier import fourier_layer
from .ldm import DenoiseUNet, sinusoidal_pos_emb
from .unet import MDWFNet, UNet, VETNet
from .vae import BayesDecoder, Decoder, Encoder
from .vq import VectorQuantizer

__all__ = ["BayesDecoder", "ComplexBatchNorm", "ComplexConv",
           "ComplexConvTranspose", "ConvBlock", "ConvLSTM", "CriticZ",
           "Decoder", "DenoiseUNet", "Encoder", "FlaxBatchNorm",
           "FlipoutConv", "MDWFNet", "Norm", "PMComplex", "PatchGAN",
           "ResidualBlock", "SGAN", "SNConv2d", "SameConv2d",
           "SelfAttention", "TEEncoder", "UNet", "Upsample", "VETNet",
           "VectorQuantizer", "adain", "cardioid", "complex_max_pool_2x2",
           "crelu", "fourier_layer", "get_activation", "init_params",
           "kl_sum", "modrelu", "same_padding", "sinusoidal_pos_emb",
           "zrelu"]
