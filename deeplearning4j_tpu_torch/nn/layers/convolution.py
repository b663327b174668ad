"""Convolution and pooling layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/convolution.py`` for
``ConvolutionLayer`` and ``SubsamplingLayer``. Activations are NCHW and
conv weights OIHW ``[n_out, n_in, kh, kw]``, so checkpoints map 1:1.
``ConvolutionLayer`` routes to the fused ``conv_block`` kernel when its
activation is one of the kernel's epilogues, in training too (its
backward is the kernels' backward). Pooling stays plain PyTorch, as it
stays plain XLA in the JAX package: MAX pads with -inf, AVG divides by
kh*kw with the padding counted, SUM is AVG's sum. MAX's gradient goes
to the first maximum of a window in row-major order, as the VJP of
XLA's ``reduce_window`` max does.
BatchNormalization and LRN come with the VGG-16 slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import LayerSpec, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops import SUPPORTED_EPILOGUES, conv_block
from deeplearning4j_tpu_torch.ops.conv_block import _pair, conv_output_size


@register_layer
@dataclass(frozen=True)
class ConvolutionLayer(LayerSpec):
    """2-D convolution. ``algo_mode`` is kept for the configuration and
    has no effect."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: tuple = (5, 5)
    stride: tuple = (1, 1)
    padding: tuple = (0, 0)
    algo_mode: str = "PREFER_FASTEST"
    activation: str = "identity"
    weight_init: str = "XAVIER"

    def input_kind(self) -> str:
        return "convolutional"

    def with_input_type(self, it: InputType) -> "ConvolutionLayer":
        if self.n_in == 0 and it.kind in ("convolutional",
                                          "convolutionalFlat"):
            return dataclasses.replace(self, n_in=it.channels)
        return self

    def output_type(self, it: InputType) -> InputType:
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        return InputType.convolutional(
            conv_output_size(it.height, kh, sh, ph),
            conv_output_size(it.width, kw, sw, pw),
            self.n_out,
        )

    def init_params(self, gen, dtype=torch.float32) -> dict:
        kh, kw = _pair(self.kernel_size)
        w = init_weights(
            gen, (self.n_out, self.n_in, kh, kw), self.weight_init,
            fan_in=self.n_in * kh * kw, fan_out=self.n_out * kh * kw,
            distribution=self.dist, dtype=dtype,
        )
        b = torch.full((self.n_out,), float(self.bias_init), dtype=dtype)
        return {"W": w, "b": b}

    def pre_output(self, params, x):
        return F.conv2d(x, params["W"], params["b"],
                        stride=_pair(self.stride),
                        padding=_pair(self.padding))

    def apply(self, params, x, state, *, train=False, gen=None, mask=None):
        self.check_train(train)
        act = self.activation.lower()
        if x.dim() == 4 and act in SUPPORTED_EPILOGUES:
            return conv_block(x, params["W"], params["b"],
                              stride=_pair(self.stride),
                              padding=_pair(self.padding),
                              activation=act), state
        return self.activate_fn()(self.pre_output(params, x)), state


@register_layer
@dataclass(frozen=True)
class SubsamplingLayer(LayerSpec):
    """Spatial pooling: MAX / AVG / SUM."""

    pooling_type: str = "MAX"
    kernel_size: tuple = (2, 2)
    stride: tuple = (2, 2)
    padding: tuple = (0, 0)
    activation: str = "identity"

    def input_kind(self) -> str:
        return "convolutional"

    def output_type(self, it: InputType) -> InputType:
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        return InputType.convolutional(
            conv_output_size(it.height, kh, sh, ph),
            conv_output_size(it.width, kw, sw, pw),
            it.channels,
        )

    def apply(self, params, x, state, *, train=False, gen=None, mask=None):
        self.check_train(train)
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        pt = self.pooling_type.upper()
        if pt == "MAX":
            if ph or pw:
                x = F.pad(x, (pw, pw, ph, ph), value=float("-inf"))
            return F.max_pool2d(x, (kh, kw), (sh, sw)), state
        if pt in ("AVG", "SUM"):
            if ph or pw:
                x = F.pad(x, (pw, pw, ph, ph))
            y = F.avg_pool2d(x, (kh, kw), (sh, sw), divisor_override=1)
            if pt == "AVG":
                y = y / (kh * kw)
            return y, state
        raise ValueError(f"Unknown pooling type '{self.pooling_type}'")
