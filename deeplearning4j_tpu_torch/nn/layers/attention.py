"""Attention and normalization layers: MultiHeadSelfAttention,
TransformerBlock, LayerNormalization, PositionalEncoding.

Counterpart of ``deeplearning4j_tpu/nn/layers/attention.py``, with its
fields (so ``configuration.json`` moves between the packages), its
parameter names and layouts (``Wq Wk Wv [d, d]``, ``Wo [d, n_out]``,
``bo``; the block adds ``ln1_gamma ln1_beta ln2_gamma ln2_beta w_ff1
[d, h] b_ff1 w_ff2 [h, d] b_ff2``) and its numerics: activations are
``[batch, features, time]``, the norms run over axis 1 with the
population variance and eps inside the square root, the FFN's GELU is
the tanh approximation (``jax.nn.gelu``'s default), and masked scores
are filled with -1e9.

Routing:
- attention goes through ``ops.mha``: the flash-attention kernel
  without a key mask (on the card, every such call), the materialized
  reference with one;
- the incremental decode of ``rnn_time_step`` (a ``k_cache`` in the
  layer's state) attends over the whole fixed ``kv_cache`` buffer with
  the -1e9 fill past the filled prefix, in plain PyTorch, as the JAX
  layer does: it never reaches the kernel. The cache is updated in
  place (the JAX layer's functional update, without a copy of the
  buffer a step);
- the block's second FFN product and its residual add are one launch of
  the dense kernel's residual variant (``matmul_block(h, w_ff2, b_ff2,
  residual=x)``: ``(h @ w_ff2 + b_ff2) + x`` in f32, the JAX block's
  order of operations); under a features mask, which multiplies the
  product before the add, they stay two plain steps.

``TransformerBlock(n_experts > 0)`` swaps the dense FFN for the Switch
mixture-of-experts FFN (``parallel/expert.py``'s ``moe_ffn``: top-1
routing, per-call capacity, dispatch by slot index; its parameters
``router [d, E]``, ``w1 [E, d, h]``, ``b1``, ``w2 [E, h, d]``, ``b2``
replace ``w_ff*`` / ``b_ff*``); its residual add stays a plain step, as
in the JAX block. With ``seq_axis`` and ``seq_axis_size > 1`` the layer
reads its input as this rank's time shard of the sequence and attends
through ``parallel/sequence.py``'s ``ring_attention`` over the seq mesh
that ``build_seq_mesh`` installed in this process (without one it
raises); the KV-cache branch comes first, as in the JAX layer. Training
with a dropout rate drops the input of
both blocks (``SelfAttentionLayer`` and ``TransformerBlock``, through
``LayerSpec.maybe_dropout``) with the JAX package's masks bit for bit
(``nn/random.py``), as every layer does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.exceptions import DL4JInvalidConfigException
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import LayerSpec, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops import matmul_block, mha
from deeplearning4j_tpu_torch.parallel.sequence import neg_fill, ring_attention

_ATTN_PARAMS = ("Wq", "Wk", "Wv", "Wo", "bo")
_MOE_PARAMS = ("router", "w1", "b1", "w2", "b2")


def _layer_norm(x, gamma, beta, eps: float):
    """Normalize over axis 1 of [b, f] or [b, f, t] (population
    variance, eps inside the square root)."""
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, correction=0)
    if x.dim() == 3:
        gamma, beta = gamma[:, None], beta[:, None]
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


@register_layer
@dataclass(frozen=True)
class MultiHeadSelfAttention(LayerSpec):
    """Multi-head self-attention over the time axis; ``causal`` masks
    future positions, the features mask masks padded keys."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 4
    causal: bool = False
    activation: str = "identity"
    seq_axis: str = ""
    seq_axis_size: int = 0
    # most timesteps incremental decoding (rnn_time_step) can hold: the
    # KV cache is a fixed [b, h, kv_cache, hd] buffer
    kv_cache: int = 1024

    def input_kind(self) -> str:
        return "recurrent"

    # -- streaming (rnn_time_step) contract -------------------------------

    def streams_state(self) -> bool:
        return True

    def can_stream(self) -> bool:
        # a non-causal layer needs future timesteps
        return self.causal

    def stream_state_keys(self) -> tuple:
        return ("k_cache", "v_cache", "pos")

    def stream_capacity(self):
        return self.kv_cache

    def init_stream_state(self, batch: int, dtype, device=None) -> dict:
        shape = (int(batch), self.n_heads, self.kv_cache, self._head_dim())
        return {"k_cache": torch.zeros(shape, dtype=dtype, device=device),
                "v_cache": torch.zeros(shape, dtype=dtype, device=device),
                "pos": 0}

    def with_input_type(self, it: InputType) -> "MultiHeadSelfAttention":
        changes = {}
        if self.n_in == 0:
            changes["n_in"] = it.size or it.flat_size()
        if self.n_out == 0:
            changes["n_out"] = it.size or it.flat_size()
        return dataclasses.replace(self, **changes) if changes else self

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def regularizable_params(self) -> tuple:
        return ("Wq", "Wk", "Wv", "Wo")

    def _head_dim(self) -> int:
        if self.n_in % self.n_heads != 0:
            raise ValueError(f"n_in={self.n_in} not divisible by "
                             f"n_heads={self.n_heads}")
        return self.n_in // self.n_heads

    def init_params(self, gen, dtype=torch.float32) -> dict:
        d = self.n_in

        def mk(shape):
            return init_weights(gen, shape, self.weight_init,
                                fan_in=shape[0], fan_out=shape[1],
                                distribution=self.dist, dtype=dtype)

        return {"Wq": mk((d, d)), "Wk": mk((d, d)), "Wv": mk((d, d)),
                "Wo": mk((d, self.n_out)),
                "bo": torch.full((self.n_out,), float(self.bias_init),
                                 dtype=dtype)}

    def _decode(self, q, k, v, state):
        """One ``rnn_time_step`` chunk: write k, v into the cache at
        ``pos`` and attend over the whole buffer, keys past ``pos + t``
        (and after each query) filled with -1e9."""
        pos, t = int(state["pos"]), int(q.shape[2])
        kc, vc = state["k_cache"], state["v_cache"]
        if pos + t > self.kv_cache:
            raise ValueError(f"KV cache overflow: {pos} + {t} timesteps "
                             f"exceed kv_cache={self.kv_cache}")
        kc[:, :, pos:pos + t] = k.to(kc.dtype)
        vc[:, :, pos:pos + t] = v.to(vc.dtype)
        hd = int(q.shape[-1])
        scale = 1.0 / torch.sqrt(torch.full((), float(hd), dtype=q.dtype,
                                            device=q.device))
        s = torch.einsum("bhqd,bhkd->bhqk", q, kc) * scale
        key_idx = torch.arange(self.kv_cache, device=q.device)
        q_idx = pos + torch.arange(t, device=q.device)
        s = s.masked_fill(key_idx[None, :] > q_idx[:, None], neg_fill(s))
        o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vc)
        return o, {**state, "k_cache": kc, "v_cache": vc, "pos": pos + t}

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        b, _, t = x.shape
        h, hd = self.n_heads, self._head_dim()
        xt = x.transpose(1, 2)                                 # [b, t, f]

        def heads(w):                                          # [b, h, t, hd]
            return torch.matmul(xt, w).reshape(b, t, h, hd).transpose(1, 2)

        q, k, v = heads(params["Wq"]), heads(params["Wk"]), heads(
            params["Wv"])
        decoding = "k_cache" in state
        if decoding:
            o, state = self._decode(q, k, v, state)
        elif self.seq_axis and self.seq_axis_size > 1:
            # x is this rank's time shard of the sequence
            o = ring_attention(q, k, v, axis_name=self.seq_axis,
                               axis_size=self.seq_axis_size,
                               causal=self.causal, mask=mask)
        else:
            o = mha(q, k, v, causal=self.causal, mask=mask)
        o = o.transpose(1, 2).reshape(b, t, h * hd)
        y = torch.matmul(o, params["Wo"]) + params["bo"]       # [b, t, n_out]
        if mask is not None and not decoding:
            y = y * mask[:, :, None]
        return self.activate_fn()(y).transpose(1, 2), state    # [b, n_out, t]


@register_layer
@dataclass(frozen=True)
class TransformerBlock(LayerSpec):
    """Pre-norm transformer block: LN -> multi-head self-attention ->
    residual, LN -> FFN -> residual (``[batch, features, time]``)."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 4
    ffn_hidden: int = 0   # 0 -> 4 * n_in
    causal: bool = True
    n_experts: int = 0    # 0 -> dense FFN; > 0 -> Switch MoE
    capacity_factor: float = 1.25
    activation: str = "identity"
    seq_axis: str = ""
    seq_axis_size: int = 0
    kv_cache: int = 1024  # incremental-decode cache (see MHSA)

    def input_kind(self) -> str:
        return "recurrent"

    def with_input_type(self, it: InputType) -> "TransformerBlock":
        changes = {}
        if self.n_in == 0:
            changes["n_in"] = it.size or it.flat_size()
        width = changes.get("n_in", self.n_in)
        if self.n_out == 0:
            changes["n_out"] = width
        if changes.get("n_out", self.n_out) != width:
            raise DL4JInvalidConfigException(
                "TransformerBlock is residual: n_out must equal n_in")
        return dataclasses.replace(self, **changes) if changes else self

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timeseries_length)

    def regularizable_params(self) -> tuple:
        return ("Wq", "Wk", "Wv", "Wo", "w_ff1", "w_ff2", "w1", "w2")

    def _attn(self) -> MultiHeadSelfAttention:
        return MultiHeadSelfAttention(
            n_in=self.n_in, n_out=self.n_in, n_heads=self.n_heads,
            causal=self.causal, seq_axis=self.seq_axis,
            seq_axis_size=self.seq_axis_size, kv_cache=self.kv_cache,
            weight_init=self.weight_init, dist=self.dist)

    # -- streaming: the attention sublayer's cache (LN / FFN carry nothing)

    def streams_state(self) -> bool:
        return True

    def can_stream(self) -> bool:
        return self.causal

    def stream_state_keys(self) -> tuple:
        return ("k_cache", "v_cache", "pos")

    def stream_capacity(self):
        return self.kv_cache

    def init_stream_state(self, batch: int, dtype, device=None) -> dict:
        return self._attn().init_stream_state(batch, dtype, device)

    def init_params(self, gen, dtype=torch.float32) -> dict:
        d = self.n_in
        h = self.ffn_hidden or 4 * d
        p = dict(self._attn().init_params(gen, dtype))
        for ln in ("ln1", "ln2"):
            p[f"{ln}_gamma"] = torch.ones(d, dtype=dtype)
            p[f"{ln}_beta"] = torch.zeros(d, dtype=dtype)
        if self.n_experts > 0:
            from deeplearning4j_tpu_torch.parallel.expert import (
                init_moe_params,
            )

            p.update(init_moe_params(gen, d, h, self.n_experts, dtype))
            return p
        p["w_ff1"] = init_weights(gen, (d, h), self.weight_init, fan_in=d,
                                  fan_out=h, distribution=self.dist,
                                  dtype=dtype)
        p["b_ff1"] = torch.zeros(h, dtype=dtype)
        p["w_ff2"] = init_weights(gen, (h, d), self.weight_init, fan_in=h,
                                  fan_out=d, distribution=self.dist,
                                  dtype=dtype)
        p["b_ff2"] = torch.zeros(d, dtype=dtype)
        return p

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        # attention sublayer (pre-norm); a KV cache in the state passes
        # through to the attention and back out
        h1 = _layer_norm(x, params["ln1_gamma"], params["ln1_beta"], 1e-5)
        a, state = self._attn().apply(
            {k: params[k] for k in _ATTN_PARAMS}, h1, state, mask=mask)
        x = x + a
        # FFN sublayer (pre-norm), its residual add fused into the
        # second product where no mask comes between them
        h2 = _layer_norm(x, params["ln2_gamma"], params["ln2_beta"], 1e-5)
        b, f, t = h2.shape
        rows = h2.transpose(1, 2).reshape(b * t, f)
        if self.n_experts > 0:
            from deeplearning4j_tpu_torch.parallel.expert import moe_ffn

            upd = moe_ffn({k: params[k] for k in _MOE_PARAMS}, rows,
                          self.capacity_factor,
                          mask.reshape(b * t) if mask is not None else None)
            x = x + upd.reshape(b, t, f).transpose(1, 2)
            return self.activate_fn()(x), state
        hidden = activations.get("gelu")(
            torch.matmul(rows, params["w_ff1"]) + params["b_ff1"])
        if mask is None:
            skip = x.transpose(1, 2).reshape(b * t, f).contiguous()
            y = matmul_block(hidden, params["w_ff2"], params["b_ff2"],
                             skip)
            x = y.reshape(b, t, f).transpose(1, 2)
        else:
            ff = torch.matmul(hidden, params["w_ff2"]) + params["b_ff2"]
            x = x + ff.reshape(b, t, f).transpose(1, 2) * mask[:, None, :]
        return self.activate_fn()(x), state


@register_layer
@dataclass(frozen=True)
class LayerNormalization(LayerSpec):
    """Layer norm over the feature axis of [b, f] or [b, f, t]."""

    n_out: int = 0
    # `eps`, not `epsilon` (the optimizer's field of LayerSpec)
    eps: float = 1e-5
    activation: str = "identity"

    def input_kind(self) -> str:
        return "any"

    def with_input_type(self, it: InputType) -> "LayerNormalization":
        if self.n_out == 0:
            return dataclasses.replace(self, n_out=it.size or it.flat_size())
        return self

    def regularizable_params(self) -> tuple:
        return ()

    def init_params(self, gen, dtype=torch.float32) -> dict:
        return {"gamma": torch.ones(self.n_out, dtype=dtype),
                "beta": torch.zeros(self.n_out, dtype=dtype)}

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        y = _layer_norm(x, params["gamma"], params["beta"], self.eps)
        return self.activate_fn()(y), state


@register_layer
@dataclass(frozen=True)
class PositionalEncoding(LayerSpec):
    """Sinusoidal positional encoding added to [b, n, t] activations
    (Vaswani et al. 2017); parameter-free. Under ``rnn_time_step`` it
    carries the absolute position of the next timestep."""

    max_wavelength: float = 10000.0

    def input_kind(self) -> str:
        return "recurrent"

    def streams_state(self) -> bool:
        return True

    def stream_state_keys(self) -> tuple:
        return ("pos",)

    def init_stream_state(self, batch: int, dtype, device=None) -> dict:
        return {"pos": 0}

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        n, t = int(x.shape[1]), int(x.shape[2])
        off = 0
        if "pos" in state:
            off = int(state["pos"])
            state = {**state, "pos": off + t}
        pos = (off + torch.arange(t, device=x.device)).to(x.dtype)
        i = torch.arange(n, device=x.device)
        # filled on the device: a copy from the host could not be
        # captured in a CUDA graph (the scan path's chunk)
        freq = torch.full((), self.max_wavelength, dtype=x.dtype,
                          device=x.device) ** (
            -((i // 2) * 2 / n).to(x.dtype))
        angle = freq[:, None] * pos[None, :]                  # [n, t]
        pe = torch.where((i % 2 == 0)[:, None], torch.sin(angle),
                         torch.cos(angle))
        return x + pe[None].to(x.dtype), state
