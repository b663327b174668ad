"""Tensor parallelism over the mesh's ``model`` axis, with explicit
collectives.

The JAX trainer shards its parameters with ``default_partition_rules``
and lets GSPMD insert the collectives; here the layers call them
(``DistributedTrainer(tensor_parallel=True)`` shards the parameters and
marks the model with its layout, ``model._tp_layout = {"mesh": mesh,
"params": {layer: {param: (axis, shard shape)}}}``; the engines' forward
hands that layout down, and ``layer_params`` gives each layer its
parameters as it reads them). Two autograd Functions carry it:

- ``copy_to_model``: the identity forward; the backward all-reduces the
  gradient over the model group (a replicated input of a sharded
  product: each rank's gradient is a partial sum);
- ``gather_from_model``: the ranks' shards concatenated along an axis
  forward; the backward keeps this rank's slice of the gradient.

The layers:

- dense and output layers, ``W [in, out]`` split by columns (their
  parameters a ``ShardParams``, which carries the mesh): the rank's
  ``matmul_block`` at ``out / model`` with its slice of the replicated
  bias (an elementwise activation stays the kernel's epilogue; softmax
  follows the gather), then the columns gathered;
- convolutions, ``W [out, in, kh, kw]`` split on out-channels: the
  rank's ``conv_block`` at ``out / model`` (bias or the inference
  BatchNormalization fold's affine sliced alike), then the channels
  gathered; the kernels' backward gives dW at the shard's shape and the
  shard's dx, which ``copy_to_model`` sums;
- embeddings, ``W [vocab, dim]`` split by rows: the rank looks up the
  rows it owns, the others ``-0.0``, and one all-reduce sums (the row
  exchange of ``row_exchange.py``, exact); the backward scatters the
  gradient of the rows it owns into its shard;
- every other layer a rule shards (the recurrent layers' ``W``, ``RW``,
  ``WF``, ``WB``, ``RWF``, ``RWB``, by columns): its whole weight is
  gathered before the layer (``layer_params``) and the weight's gradient
  sliced back, so its compute is replicated and its parameters and
  updater state are not.

A gather is ``all_gather_into_tensor`` on NCCL and the all-reduce of
zero-filled buffers on gloo (which has no all-gather on CUDA tensors):
the choice follows the group's backend alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

def default_partition_rules(layer, param_name: str, shape) -> Tuple:
    """The JAX trainer's ``default_partition_rules``: per axis of a
    parameter, ``"model"`` where it is split over the model axis, else
    None (``()``: replicated). Conv ``W [out, in, kh, kw]`` on its
    out-channels, an embedding's ``W [vocab, dim]`` on its rows, every
    other ``W`` / ``RW`` / ``WF`` / ``WB`` / ``RWF`` / ``RWB`` of two or
    more axes on its columns; biases and vectors replicated."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.feedforward import EmbeddingLayer

    if len(shape) >= 2:
        if isinstance(layer, ConvolutionLayer) and param_name == "W":
            return ("model", None, None, None)
        if isinstance(layer, EmbeddingLayer) and param_name == "W":
            return ("model", None)
        if param_name in ("W", "RW", "WF", "WB", "RWF", "RWB"):
            return (None, "model")
    return ()


def spec_for(layer, param_name: str, shape, model: int) -> Optional[int]:
    """The axis ``param_name`` splits on over ``model`` ranks, or None
    (replicated): the rule's, falling back to replication where the
    axis does not divide (JAX ``_spec_for``, silently)."""
    spec = default_partition_rules(layer, param_name, tuple(shape))
    axes = [i for i, a in enumerate(spec) if a is not None]
    if not axes or shape[axes[0]] % model != 0:
        return None
    return axes[0]


def gather_group(t: torch.Tensor, dim: int, group, n: int,
                 index: int) -> torch.Tensor:
    """The ``n`` ranks of ``group``'s ``t`` concatenated along ``dim`` in
    group order (``index``: this rank's place), no gradient:
    ``all_gather_into_tensor`` on NCCL, the all-reduce of zero-filled
    buffers on gloo."""
    if dist.get_backend(group) == "nccl":
        moved = t.movedim(dim, 0).contiguous()
        out = moved.new_empty((n * moved.shape[0], *moved.shape[1:]))
        dist.all_gather_into_tensor(out, moved, group=group)
        return out.movedim(0, dim)
    from deeplearning4j_tpu_torch.parallel.row_exchange import stack_ranks

    buf = stack_ranks(t.contiguous(), n, index, group=group)
    return torch.cat(buf.unbind(0), dim=dim)


class _CopyToGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, dim, group, n, index):
        ctx.dim, ctx.index, ctx.size = dim, index, t.shape[dim]
        return gather_group(t, dim, group, n, index)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.size
        return (g.narrow(ctx.dim, lo, ctx.size).contiguous(), None, None,
                None, None)


class _SumGroup(torch.autograd.Function):
    """A sum over a group's ranks whose result enters each rank's
    (replicated) loss: the backward is the identity."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` unchanged; its gradient all-reduced over ``group`` (a
    replicated input of a sharded computation)."""
    return _CopyToGroup.apply(t, group)


def gather_along(t: torch.Tensor, dim: int, group, n: int,
                 index: int) -> torch.Tensor:
    """``group``'s shards of ``t`` concatenated along ``dim``; the
    gradient's slice of this rank goes back."""
    return _GatherGroup.apply(t, dim % t.dim(), group, n, index)


def sum_group(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks; the gradient is each rank's
    own (every rank's loss is the one replicated loss)."""
    return _SumGroup.apply(t, group)


def copy_to_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` unchanged; its gradient all-reduced over the model group."""
    return copy_to_group(t, mesh.model_group)


def gather_from_model(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The model ranks' shards of ``t`` concatenated along ``dim``; the
    gradient's slice of this rank goes back."""
    return gather_along(t, dim, mesh.model_group, mesh.model,
                        mesh.model_index)


class ShardParams(dict):
    """The parameters of a layer that splits its own product over the
    model ranks (``native``), as that layer reads them: its shards, and
    the ``mesh`` they lie on."""

    def __init__(self, params: dict, mesh):
        super().__init__(params)
        self.mesh = mesh


def holds_shard(params) -> bool:
    """True where a layer's ``params`` hold tensor-parallel shards (the
    layer then splits its product over ``params.mesh``'s model ranks)."""
    return isinstance(params, ShardParams)


def _cols(mesh, n_shard: int) -> slice:
    lo = mesh.model_index * n_shard
    return slice(lo, lo + n_shard)


def dense(layer, params, x: torch.Tensor, act: Optional[str]):
    """A column-sharded dense product ``x @ W + b`` over the model ranks:
    the rank's ``matmul_block`` with the epilogue ``act`` (None: the
    identity, and the layer's activation after the gather; "pre": the
    pre-output, no activation), then the columns gathered."""
    from deeplearning4j_tpu_torch.ops import matmul_block

    mesh = params.mesh
    w = params["W"]
    b = copy_to_model(params["b"], mesh)[_cols(mesh, w.shape[1])]
    epi = act if act not in (None, "pre") else "identity"
    y = matmul_block(copy_to_model(x, mesh), w, b, activation=epi)
    y = gather_from_model(y, -1, mesh)
    return layer.activate_fn()(y) if act is None else y


def conv(layer, params, x: torch.Tensor, act: Optional[str],
         bn_scale=None, bn_shift=None):
    """An out-channel-sharded ``conv_block`` over the model ranks (the
    bias and the BatchNormalization affine sliced to the rank's
    channels), then the channels gathered; ``act`` None: the layer's
    activation after the gather."""
    from deeplearning4j_tpu_torch.ops import conv_block
    from deeplearning4j_tpu_torch.ops.conv_block import _pair

    mesh = params.mesh
    w = params["W"]
    ch = _cols(mesh, w.shape[0])

    def mine(v):
        return None if v is None else copy_to_model(v, mesh)[ch]

    y = conv_block(copy_to_model(x, mesh), w, mine(params["b"]),
                   mine(bn_scale), mine(bn_shift),
                   stride=_pair(layer.stride), padding=_pair(layer.padding),
                   activation=act or "identity")
    y = gather_from_model(y, 1, mesh)
    return layer.activate_fn()(y) if act is None else y


class _VocabLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, shard, ids, mesh):
        rows = shard.shape[0]
        local = ids - mesh.model_index * rows
        owned = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        out = torch.where(owned[:, None], shard[local],
                          shard.new_full((), -0.0))
        dist.all_reduce(out, group=mesh.model_group)
        ctx.save_for_backward(local, owned)
        ctx.rows = rows
        return out

    @staticmethod
    def backward(ctx, g):
        local, owned = ctx.saved_tensors
        upd = torch.where(owned[:, None], g, g.new_zeros(()))
        grad = g.new_zeros((ctx.rows, g.shape[1])).index_add_(0, local, upd)
        return grad, None, None


def lookup(params: ShardParams, ids: torch.Tensor) -> torch.Tensor:
    """The rows ``ids`` of a table whose rows (``params["W"]``) are split
    over the model ranks (every model rank passes the same ids)."""
    return _VocabLookup.apply(params["W"], ids.reshape(-1).long(),
                              params.mesh)


def layer_params(tp: Optional[dict], name: str, layer, params: dict) -> dict:
    """``params`` of layer ``name`` as the layer reads them under the
    model's tensor-parallel layout ``tp`` (``model._tp_layout``; None:
    nothing is sharded): a layer that splits its own product (dense,
    output, convolution, embedding) takes its shards as a
    ``ShardParams``; any other's sharded weights are gathered whole here
    (the gradient's slice goes back to the shard)."""
    axes = tp["params"].get(name) if tp else None
    if not axes:
        return params
    if native(layer):
        return ShardParams(params, tp["mesh"])
    out = dict(params)
    for pn, (axis, _) in axes.items():
        out[pn] = gather_from_model(params[pn], axis, tp["mesh"])
    return out


def native(layer) -> bool:
    """True for the layers whose forward splits its own product over
    the model ranks."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        DenseLayer,
        EmbeddingLayer,
        OutputLayer,
    )

    return type(layer) in (DenseLayer, OutputLayer, ConvolutionLayer,
                           EmbeddingLayer)


def penalty_term(tp: Optional[dict], name: str, pn: str, term):
    """A parameter's L1/L2 penalty term as the whole parameter's: a
    shard's term (under the model's layout ``tp``) summed over the model
    ranks."""
    if not tp or pn not in tp["params"].get(name, {}):
        return term
    return sum_group(term, tp["mesh"].model_group)


def gather_whole(t: torch.Tensor, axis: int, mesh) -> torch.Tensor:
    """A shard's whole tensor (no gradient): a checkpoint's layout."""
    with torch.no_grad():
        return gather_group(t, axis, mesh.model_group, mesh.model,
                            mesh.model_index).contiguous()


def shard_of(full: torch.Tensor, axis: int, mesh) -> torch.Tensor:
    """This model rank's slice of ``full`` along ``axis`` (a copy)."""
    n = full.shape[axis] // mesh.model
    return full.narrow(axis, mesh.model_index * n, n).clone()
