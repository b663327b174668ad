"""Recurrent layers: GravesLSTM, GravesBidirectionalLSTM, RnnOutputLayer.

Counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py``, with its
parameter names and layouts, so checkpoints move between the packages
1:1: ``W [n_in, 4n]``, ``RW [n, 4n]``, ``b [4n]`` (the forget block
starts at ``forget_gate_bias_init``), peepholes ``pI`` / ``pF`` / ``pO``
``[n]``, gate order i, f, o, g; the bidirectional layer suffixes the
forward pass's names with ``F`` and the backward pass's with ``B``.
Activations are ``[batch, size, time]``.

The input projection ``x @ W + b`` for all timesteps is one matmul,
hoisted out of the recurrence. The recurrence routes by the layer's
configuration alone, as the JAX package's ``_lstm_scan`` does
(``recurrent.py:93-146``):
- sigmoid gates and tanh, no peephole, no mask: ``lstm_sequence``, the
  whole-sequence kernels (one launch forward, one backward);
- sigmoid gates and tanh with a peephole or a features mask: one
  ``lstm_cell_diff`` a step (the per-step kernel), the mask applied
  around it: masked steps carry h and c through and output zeros;
- any other activation: the plain per-step math, on either device.
A CPU tensor takes each kernel's plain version.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import LayerSpec, register_layer
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    BaseOutputLayerSpec,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops import lstm_cell_diff, lstm_sequence


def _lstm_params(gen, n_in, n_out, weight_init, dist, forget_bias, dtype,
                 peephole: bool) -> dict:
    p = {
        "W": init_weights(gen, (n_in, 4 * n_out), weight_init, fan_in=n_in,
                          fan_out=n_out, distribution=dist, dtype=dtype),
        "RW": init_weights(gen, (n_out, 4 * n_out), weight_init,
                           fan_in=n_out, fan_out=n_out, distribution=dist,
                           dtype=dtype),
        "b": torch.cat([
            torch.zeros(n_out, dtype=dtype),                    # i
            torch.full((n_out,), float(forget_bias), dtype=dtype),  # f
            torch.zeros(2 * n_out, dtype=dtype),                # o, g
        ]),
    }
    if peephole:
        for name in ("pI", "pF", "pO"):
            p[name] = torch.zeros(n_out, dtype=dtype)
    return p


def _lstm_scan(p, x_bnt, h0, c0, mask_bt, gate: str, act: str,
               peephole: bool, reverse: bool = False):
    """Run the LSTM over [b, n_in, t] input; returns ([b, n, t] outputs,
    (hT, cT))."""
    x_tbi = x_bnt.permute(2, 0, 1)
    if reverse:
        x_tbi = x_tbi.flip(0)
    xin = torch.matmul(x_tbi, p["W"]) + p["b"]  # [t, b, 4n]
    m_tb = None
    if mask_bt is not None:
        m_tb = mask_bt.t()[:, :, None].to(xin.dtype)  # [t, b, 1]
        if reverse:
            m_tb = m_tb.flip(0)
    fused = gate.lower() == "sigmoid" and act.lower() == "tanh"
    if fused and not peephole and m_tb is None:
        outs, hT, cT = lstm_sequence(xin, h0, c0, p["RW"])
        if reverse:
            outs = outs.flip(0)
        return outs.permute(1, 2, 0), (hT, cT)

    gate_fn, act_fn = activations.get(gate), activations.get(act)
    peeps = (p["pI"], p["pF"], p["pO"]) if peephole else None
    n = h0.shape[-1]
    h, c = h0, c0
    outs = []
    for t in range(int(xin.shape[0])):
        if fused:
            h_new, c_new = lstm_cell_diff(xin[t], h, c, p["RW"], peeps)
        else:
            z = xin[t] + h @ p["RW"]
            zi, zf, zo, zg = (z[:, k * n:(k + 1) * n] for k in range(4))
            if peephole:
                zi = zi + c * p["pI"]
                zf = zf + c * p["pF"]
            i, f, g = gate_fn(zi), gate_fn(zf), act_fn(zg)
            c_new = f * c + i * g
            if peephole:
                zo = zo + c_new * p["pO"]
            h_new = gate_fn(zo) * act_fn(c_new)
        if m_tb is not None:
            m = m_tb[t]
            h_new = m * h_new + (1.0 - m) * h
            c_new = m * c_new + (1.0 - m) * c
            outs.append(m * h_new)
        else:
            outs.append(h_new)
        h, c = h_new, c_new
    y = torch.stack(outs)
    if reverse:
        y = y.flip(0)
    return y.permute(1, 2, 0), (h, c)


@register_layer
@dataclass(frozen=True)
class GravesLSTM(LayerSpec):
    """Graves-style LSTM with peepholes (reference ``GravesLSTM.java:40``
    + ``LSTMHelpers``)."""

    n_in: int = 0
    n_out: int = 0
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0
    peephole: bool = True

    def input_kind(self) -> str:
        return "recurrent"

    def is_recurrent(self) -> bool:
        return True

    def with_input_type(self, it: InputType) -> "GravesLSTM":
        if self.n_in == 0:
            return dataclasses.replace(self, n_in=it.size or it.flat_size())
        return self

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def regularizable_params(self) -> tuple:
        return ("W", "RW")

    def init_params(self, gen, dtype=torch.float32) -> dict:
        return _lstm_params(gen, self.n_in, self.n_out, self.weight_init,
                            self.dist, self.forget_gate_bias_init, dtype,
                            self.peephole)

    def init_stream_state(self, batch: int, dtype, device=None) -> dict:
        """Zero h / c carry: what ``apply`` returns between TBPTT chunks
        and ``rnn_time_step`` calls."""
        shape = (int(batch), self.n_out)
        return {"h": torch.zeros(shape, dtype=dtype, device=device),
                "c": torch.zeros(shape, dtype=dtype, device=device)}

    def supports_drop_connect(self) -> bool:
        return True

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        # the reference drops the input weights only (LSTMHelpers.java:93)
        params = self.maybe_drop_connect(params, train=train, rng=rng,
                                         keys=("W",))
        if "h" in state:
            h0, c0 = state["h"], state["c"]
        else:
            zero = self.init_stream_state(x.shape[0], x.dtype, x.device)
            h0, c0 = zero["h"], zero["c"]
        outs, (hT, cT) = _lstm_scan(params, x, h0, c0, mask,
                                    self.gate_activation, self.activation,
                                    self.peephole)
        # the carry leaves the graph: truncated BPTT backpropagates
        # within a chunk only
        return outs, {"h": hT.detach(), "c": cT.detach()}


@register_layer
@dataclass(frozen=True)
class GravesBidirectionalLSTM(GravesLSTM):
    """Bidirectional Graves LSTM (reference
    ``GravesBidirectionalLSTM.java``): forward and backward passes over
    the sequence, combined by ``mode``."""

    mode: str = "add"  # add | concat | average | mul

    def output_type(self, it: InputType) -> InputType:
        n = 2 * self.n_out if self.mode == "concat" else self.n_out
        return InputType.recurrent(n, it.timeseries_length)

    def regularizable_params(self) -> tuple:
        return ("WF", "RWF", "WB", "RWB")

    def init_params(self, gen, dtype=torch.float32) -> dict:
        out = {}
        for suffix in ("F", "B"):
            p = _lstm_params(gen, self.n_in, self.n_out, self.weight_init,
                             self.dist, self.forget_gate_bias_init, dtype,
                             self.peephole)
            out.update({k + suffix: v for k, v in p.items()})
        return out

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        params = self.maybe_drop_connect(params, train=train, rng=rng,
                                         keys=("WF", "WB"))
        zero = self.init_stream_state(x.shape[0], x.dtype, x.device)
        h0, c0 = zero["h"], zero["c"]
        pf = {k[:-1]: v for k, v in params.items() if k.endswith("F")}
        pb = {k[:-1]: v for k, v in params.items() if k.endswith("B")}
        of, _ = _lstm_scan(pf, x, h0, c0, mask, self.gate_activation,
                           self.activation, self.peephole)
        ob, _ = _lstm_scan(pb, x, h0, c0, mask, self.gate_activation,
                           self.activation, self.peephole, reverse=True)
        if self.mode == "add":
            y = of + ob
        elif self.mode == "average":
            y = 0.5 * (of + ob)
        elif self.mode == "mul":
            y = of * ob
        elif self.mode == "concat":
            y = torch.cat([of, ob], dim=1)
        else:
            raise ValueError(f"Unknown bidirectional mode '{self.mode}'")
        # no streaming carry: the backward pass needs the whole sequence
        return y, state

    def is_recurrent(self) -> bool:
        return False

    def can_stream(self) -> bool:
        return False


@register_layer
@dataclass(frozen=True)
class RnnOutputLayer(BaseOutputLayerSpec):
    """Per-timestep dense + loss on [b, n, t] activations (reference
    ``nn/layers/recurrent/RnnOutputLayer.java``)."""

    activation: str = "softmax"

    def input_kind(self) -> str:
        return "recurrent"

    def with_input_type(self, it: InputType) -> "RnnOutputLayer":
        if self.n_in == 0:
            return dataclasses.replace(self, n_in=it.size or it.flat_size())
        return self

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def pre_output(self, params, x):
        # [b, n_in, t] x [n_in, n_out] -> [b, n_out, t]
        return (torch.einsum("bit,io->bot", x, params["W"])
                + params["b"][None, :, None])

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        params = self.maybe_drop_connect(params, train=train, rng=rng)
        pre = self.pre_output(params, x)
        if self.activation == "softmax":
            return torch.softmax(pre, dim=1), state  # the class axis
        return self.activate_fn()(pre), state
