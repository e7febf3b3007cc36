"""Activation functions on tensors (counterpart of
``paddle_tpu/activation.py``; analog of
paddle/gserver/activations/ActivationFunction.cpp).

Each is a tiny class (v2-API style: ``activation.Relu()``) wrapping a
PyTorch function; ``resolve`` accepts an instance, a class, a registered
name, or None. The port has the activations of the LSTM classifier and
the NMT model and their cell options (linear, sigmoid, tanh, relu,
softmax, sequence_softmax).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.utils.registry import Registry

ACTIVATION_REGISTRY = Registry("activation")


class BaseActivation:
    name = "default"

    def __call__(self, x, mask=None):
        return self.apply(x, mask)

    def apply(self, x, mask=None):
        raise NotImplementedError

    def __repr__(self):
        return f"activation.{type(self).__name__}()"


def _register(name):
    def deco(cls):
        cls.name = name
        ACTIVATION_REGISTRY.register(name, cls)
        return cls
    return deco


@_register("linear")
class Linear(BaseActivation):
    def apply(self, x, mask=None):
        return x


Identity = Linear


@_register("sigmoid")
class Sigmoid(BaseActivation):
    def apply(self, x, mask=None):
        return torch.sigmoid(x)


@_register("tanh")
class Tanh(BaseActivation):
    def apply(self, x, mask=None):
        return torch.tanh(x)


@_register("relu")
class Relu(BaseActivation):
    def apply(self, x, mask=None):
        return torch.relu(x)


@_register("softmax")
class Softmax(BaseActivation):
    def apply(self, x, mask=None):
        # math in f32 at least, storage in the input dtype
        f32 = torch.promote_types(x.dtype, torch.float32)
        return torch.softmax(x.to(f32), dim=-1).to(x.dtype)


@_register("sequence_softmax")
class SequenceSoftmax(BaseActivation):
    """Softmax over the *time* axis of a sequence (feature size 1).
    Padding steps are set to -1e30 before the softmax and the result is
    multiplied by the mask, so they get zero probability."""

    def apply(self, x, mask=None):
        # x: [B, T] or [B, T, 1]
        squeeze = x.dim() == 3
        v = x[..., 0] if squeeze else x
        if mask is not None:
            v = torch.where(mask > 0, v, torch.full_like(v, -1e30))
        out = torch.softmax(v, dim=-1)
        if mask is not None:
            out = out * mask
        return out[..., None] if squeeze else out


def resolve(act) -> BaseActivation:
    """Accept an instance, a class, a registered name, or None (-> linear)."""
    if act is None:
        return Linear()
    if isinstance(act, BaseActivation):
        return act
    if isinstance(act, type) and issubclass(act, BaseActivation):
        return act()
    if isinstance(act, str):
        return ACTIVATION_REGISTRY.get(act)()
    raise TypeError(f"cannot resolve activation from {act!r}")
