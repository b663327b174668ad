"""Convolution and pooling layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/convolution.py`` for
``ConvolutionLayer``, ``SubsamplingLayer``, ``BatchNormalization`` and
``LocalResponseNormalization``. Activations are NCHW and
conv weights OIHW ``[n_out, n_in, kh, kw]``, so checkpoints map 1:1.
``ConvolutionLayer`` routes to the fused ``conv_block`` kernel when its
activation is one of the kernel's epilogues, in training too (its
backward is the kernels' backward). Pooling stays plain PyTorch, as it
stays plain XLA in the JAX package: MAX pads with -inf, AVG divides by
kh*kw with the padding counted, SUM is AVG's sum. MAX's gradient goes
to the first maximum of a window in row-major order, as the VJP of
XLA's ``reduce_window`` max does. BatchNormalization keeps its running
mean and variance in the layer state and normalizes through one
per-channel affine; at inference a Conv(identity) -> BN pair folds into
one ``conv_block`` launch whose epilogue takes that affine
(``maybe_fused_conv_bn``). Under ``global_batch_statistics`` (the
data-parallel trainer's ``batch_stats="sync"``) a training forward
takes its statistics over every rank's rows. LRN is plain PyTorch (the
JAX package has no kernel for it either). A convolution handed a
tensor-parallel shard of its out-channels (a ``ShardParams``, which
carries the mesh), and its inference fold with a BatchNormalization,
splits its product over the model ranks (``parallel/
tensor_parallel.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import LayerSpec, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops import SUPPORTED_EPILOGUES, conv_block
from deeplearning4j_tpu_torch.ops.conv_block import _pair, conv_output_size
from deeplearning4j_tpu_torch.parallel import tensor_parallel


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

    def supports_drop_connect(self) -> bool:
        return True

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        # drop-connect: the masked W goes into the kernel, and autograd
        # carries the kernel's dW back through the mask
        params = self.maybe_drop_connect(params, train=train, rng=rng)
        act = self.activation.lower()
        if tensor_parallel.holds_shard(params):
            return tensor_parallel.conv(
                self, params, x,
                act if act in SUPPORTED_EPILOGUES else None), state
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

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
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


# (all-reduce sum, ranks) while a data-parallel step wants global batch
# statistics; None: each forward's own batch
_GLOBAL_STATS: contextvars.ContextVar = contextvars.ContextVar(
    "dl4j_global_batch_statistics", default=None)


@contextlib.contextmanager
def global_batch_statistics(reduce_sum: Callable, ranks: int):
    """Within the block, a BatchNormalization training forward takes its
    mean and variance over the rows of all ``ranks`` ranks (equal
    shards): ``reduce_sum`` sums a tensor over the ranks and is
    differentiable, so the backward sees the global statistics too."""
    token = _GLOBAL_STATS.set((reduce_sum, int(ranks)))
    try:
        yield
    finally:
        _GLOBAL_STATS.reset(token)


@register_layer
@dataclass(frozen=True)
class BatchNormalization(LayerSpec):
    """Batch normalization over the channels of a CNN activation [b, c,
    h, w] or the features of an FF one [b, n]. The running mean and
    variance live in the layer state; a training forward normalizes by
    the batch's statistics (f32 / f64: the two-pass centred variance;
    bf16 / f16: one f32 pass of sums and sums of squares) and returns
    the state moved to ``decay * old + (1 - decay) * batch``; an
    inference forward normalizes by the running statistics."""

    n_out: int = 0
    decay: float = 0.9
    eps: float = 1e-5
    gamma_init: float = 1.0
    beta_init: float = 0.0
    lock_gamma_beta: bool = False
    activation: str = "identity"

    def input_kind(self) -> str:
        return "any"

    def with_input_type(self, it: InputType) -> "BatchNormalization":
        if self.n_out == 0:
            n = it.channels if it.kind == "convolutional" else it.flat_size()
            return dataclasses.replace(self, n_out=n)
        return self

    def output_type(self, it: InputType) -> InputType:
        return it

    def regularizable_params(self) -> tuple:
        return ()  # gamma and beta take no L1/L2 penalty

    def uses_batch_statistics(self) -> bool:
        return True

    def init_params(self, gen, dtype=torch.float32) -> dict:
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.full((self.n_out,), float(self.gamma_init),
                                    dtype=dtype),
                "beta": torch.full((self.n_out,), float(self.beta_init),
                                   dtype=dtype)}

    def init_state(self, dtype=torch.float32) -> dict:
        return {"mean": torch.zeros(self.n_out, dtype=dtype),
                "var": torch.ones(self.n_out, dtype=dtype)}

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        if x.dim() == 4:
            axes, bshape = (0, 2, 3), (1, -1, 1, 1)
        else:
            axes, bshape = (0,), (1, -1)
        if train:
            mean, var = self._batch_stats(x, axes, bshape)
            new_state = {
                k: (self.decay * state[k]
                    + (1 - self.decay) * v.detach().to(state[k].dtype))
                for k, v in (("mean", mean), ("var", var))}
        else:
            acc = torch.promote_types(x.dtype, torch.float32)
            mean, var = state["mean"].to(acc), state["var"].to(acc)
            new_state = state
        a, b = self._affine_from_stats(params, mean, var)
        y = x * a.to(x.dtype).reshape(bshape) + b.to(x.dtype).reshape(bshape)
        return self.activate_fn()(y), new_state

    def _batch_stats(self, x, axes, bshape):
        """(mean, variance) of the training batch: f32 / f64 in two
        passes (the centred variance), bf16 / f16 in one f32 pass of
        sums and sums of squares. Under ``global_batch_statistics`` the
        sums run over every rank's rows."""
        glob = _GLOBAL_STATS.get()
        if x.dtype in (torch.bfloat16, torch.float16):
            # one pass: the sums and the sums of squares in f32
            xf = x.float()
            sums = torch.stack([xf.sum(axes), (xf * xf).sum(axes)])
            cnt = float(x.numel() // x.shape[1])
            if glob is not None:
                sums, cnt = glob[0](sums), cnt * glob[1]
            mean = sums[0] / cnt
            return mean, torch.clamp(sums[1] / cnt - mean * mean, min=0.0)
        # sums over the count, the same ops with and without the ranks:
        # a world of one gives the single-device bits
        reduce_sum, ranks = glob if glob is not None else (None, 1)
        cnt = float(x.numel() // x.shape[1]) * ranks
        total = x.sum(axes)
        mean = (total if reduce_sum is None else reduce_sum(total)) / cnt
        centred = torch.square(x - mean.reshape(bshape)).sum(axes)
        if reduce_sum is not None:
            centred = reduce_sum(centred)
        return mean, centred / cnt

    def _affine_from_stats(self, params, mean, var):
        """The normalization as a per-channel ``(a, b)``, ``y = a*x +
        b``."""
        inv = torch.rsqrt(var + self.eps)
        if self.lock_gamma_beta:
            return inv, -mean * inv
        a = params["gamma"].to(inv.dtype) * inv
        return a, params["beta"].to(inv.dtype) - mean * a

    def folded_affine(self, params, state):
        """The inference normalization's ``(a, b)`` from the running
        statistics: what the conv->BN fold hands the conv kernel's
        epilogue."""
        acc = torch.promote_types(state["mean"].dtype, torch.float32)
        return self._affine_from_stats(params, state["mean"].to(acc),
                                       state["var"].to(acc))


@register_layer
@dataclass(frozen=True)
class LocalResponseNormalization(LayerSpec):
    """Cross-channel LRN in the Krizhevsky form: ``y = x / (k + alpha *
    sum of x_j^2 over a window of n channels)^beta``, the window padded
    by ``n // 2`` channels before and ``n - 1 - n // 2`` after."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75
    activation: str = "identity"

    def input_kind(self) -> str:
        return "convolutional"

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        half = self.n // 2
        sq = F.pad(x * x, (0, 0, 0, 0, half, self.n - 1 - half))
        # the windowed sum over channels: a sum pool along the c axis
        summed = F.avg_pool3d(sq[:, None], (self.n, 1, 1), stride=1,
                              divisor_override=1)[:, 0]
        return x / (self.k + self.alpha * summed) ** self.beta, state


def maybe_fused_conv_bn(conv, bn, conv_params, bn_params, bn_state, x
                        ) -> Optional[torch.Tensor]:
    """The inference peephole: Conv(identity) -> BatchNormalization(act)
    as one ``conv_block`` launch, the running statistics folded to the
    per-channel affine of the kernel's epilogue. Returns None where the
    pair does not fold (other layers, a conv with an activation, an
    epilogue the kernel lacks, no running statistics): the caller then
    walks the two layers. Never called in training, where the
    statistics come from the conv's own output."""
    if not (isinstance(conv, ConvolutionLayer)
            and isinstance(bn, BatchNormalization)
            and conv.activation.lower() == "identity"
            and x.dim() == 4
            and bn.n_out == conv.n_out
            and bn_state):
        return None
    act = bn.activation.lower()
    if act not in SUPPORTED_EPILOGUES:
        return None
    a, b = bn.folded_affine(bn_params, bn_state)
    if tensor_parallel.holds_shard(conv_params):
        return tensor_parallel.conv(conv, conv_params, x, act, a, b)
    return conv_block(x, conv_params["W"], conv_params["b"], a, b,
                      stride=_pair(conv.stride), padding=_pair(conv.padding),
                      activation=act)
