"""Flagship compute pipelines ("models") of the port: the batched stripe
codec as functions on tensors, built from the region kernels."""

from .stripe_codec import StripeCodec

__all__ = ["StripeCodec"]
