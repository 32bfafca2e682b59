"""Layers with the JAX package's conventions, the VAE and SPAIR networks and
the probe classifier (split_vae_tpu/nn)."""

from split_vae_torch.nn.classifier import Classifier
from split_vae_torch.nn.decoders import ConvDecoder
from split_vae_torch.nn.encoders import ConvEncoder, FCEncoder, GMVaeEncoder
from split_vae_torch.nn.spair_nets import (
    BackgroundModel,
    ImageDecoder,
    ImageDecoderDense,
    ImageEncoder,
    ImageEncoderDense,
    ObjDecoder,
    ObjEncoder,
    SpairDecoder,
    SpairEncoder,
    render,
)
