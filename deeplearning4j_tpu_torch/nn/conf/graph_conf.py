"""ComputationGraph configuration: a DAG of vertices.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph_conf.py``: the vertex
registry and the 13 vertex types (each with its forward, ``apply``, its
InputType rule, ``output_type``, and its JSON), the immutable
``ComputationGraphConfiguration`` with its Kahn ``topological_order``
(ties in sorted name order, then in order of discovery, as there), the
``GraphBuilder`` and the InputType shape inference that fills each
layer's nIn and inserts the shape preprocessors. ``to_dict`` /
``from_dict`` write and read the JAX package's ``configuration.json``
(same ``format`` tag, same keys), so a graph saved by either package
loads in the other.

The whole-net transform hints (``scan_layers``, ``remat``,
``loss_scale``) ride on the configuration unserialized, as in
``multi_layer.py``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor,
    ShapeContext,
)
# a module reference, as in multi_layer.py: layers/base.py imports
# nn.conf while this module may still be loading
from deeplearning4j_tpu_torch.nn.layers import base as layer_base

FORMAT = "deeplearning4j_tpu.ComputationGraphConfiguration"

VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclass(frozen=True)
class GraphVertexSpec:
    """Base vertex: its configuration and its forward."""

    def apply(self, params, inputs: Sequence, state, *, train=False,
              rng=None, mask=None):
        raise NotImplementedError

    def output_type(self, input_types: Sequence[InputType]) -> InputType:
        return input_types[0]

    def init_params(self, gen, dtype=torch.float32) -> dict:
        return {}

    def init_state(self, dtype=torch.float32) -> dict:
        return {}

    def layer(self) -> Optional[layer_base.LayerSpec]:
        return None

    def to_json(self) -> dict:
        d = {"@class": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, layer_base.LayerSpec):
                v = {"@layer": True, **layer_base.layer_to_json(v)}
            elif isinstance(v, InputPreProcessor):
                v = {"@preproc": True, **v.to_json()}
            elif isinstance(v, tuple):
                v = list(v)
            d[f.name] = v
        return d

    @staticmethod
    def from_json(d: dict) -> "GraphVertexSpec":
        d = dict(d)
        name = d.pop("@class")
        try:
            cls = VERTEX_REGISTRY[name]
        except KeyError:
            raise ValueError(f"Unknown vertex type '{name}' (known: "
                             f"{sorted(VERTEX_REGISTRY)})") from None
        kwargs = {}
        names = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k not in names:
                continue
            if isinstance(v, dict) and v.get("@layer"):
                v = layer_base.layer_from_json(
                    {kk: vv for kk, vv in v.items() if kk != "@layer"})
            elif isinstance(v, dict) and v.get("@preproc"):
                v = InputPreProcessor.from_json(
                    {kk: vv for kk, vv in v.items() if kk != "@preproc"})
            elif isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)


@register_vertex
@dataclass(frozen=True)
class LayerVertex(GraphVertexSpec):
    """A layer, with an optional input preprocessor."""

    layer_conf: layer_base.LayerSpec = None  # type: ignore[assignment]
    preprocessor: Optional[InputPreProcessor] = None

    def layer(self) -> Optional[layer_base.LayerSpec]:
        return self.layer_conf

    def init_params(self, gen, dtype=torch.float32) -> dict:
        return self.layer_conf.init_params(gen, dtype)

    def init_state(self, dtype=torch.float32) -> dict:
        return self.layer_conf.init_state(dtype)

    def layer_input(self, x, ctx: Optional[ShapeContext] = None):
        """The vertex input as the layer sees it. ``ctx`` is the
        engine's shape context of the whole minibatch: a flattened
        ``[b*t, f]`` input no longer tells its batch or time."""
        if self.preprocessor is None:
            return x
        if ctx is None:
            ctx = ShapeContext(batch=int(x.shape[0]),
                               time=int(x.shape[2]) if x.dim() == 3 else -1)
        return self.preprocessor.preprocess(x, ctx)

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None, ctx: Optional[ShapeContext] = None):
        if len(inputs) != 1:
            raise ValueError("LayerVertex expects exactly one input")
        x = self.layer_input(inputs[0], ctx).contiguous()
        return self.layer_conf.apply(params, x, state, train=train, rng=rng,
                                     mask=mask)

    def output_type(self, input_types):
        it = input_types[0]
        if self.preprocessor is not None:
            it = self.preprocessor.output_type(it)
        return self.layer_conf.output_type(it)


@register_vertex
@dataclass(frozen=True)
class MergeVertex(GraphVertexSpec):
    """Concatenate along the feature axis (axis 1 of [b, n], [b, n, t]
    and [b, c, h, w])."""

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None):
        return torch.cat(list(inputs), dim=1), state

    def output_type(self, input_types):
        it = input_types[0]
        if it.kind == "convolutional":
            return InputType.convolutional(
                it.height, it.width, sum(t.channels for t in input_types))
        total = sum(t.size or t.flat_size() for t in input_types)
        if it.kind == "recurrent":
            return InputType.recurrent(total, it.timeseries_length)
        return InputType.feed_forward(total)


@register_vertex
@dataclass(frozen=True)
class ElementWiseVertex(GraphVertexSpec):
    """Add / Subtract / Product / Average / Max of same-shaped inputs."""

    op: str = "Add"

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None):
        op = self.op.lower()
        if op == "add":
            out = sum(inputs)
        elif op == "subtract":
            if len(inputs) != 2:
                raise ValueError("Subtract requires exactly 2 inputs")
            out = inputs[0] - inputs[1]
        elif op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
        elif op == "average":
            out = sum(inputs) / len(inputs)
        elif op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(f"Unknown ElementWise op '{self.op}'")
        return out, state


@register_vertex
@dataclass(frozen=True)
class SubsetVertex(GraphVertexSpec):
    """Features ``from_idx`` .. ``to_idx``, both included."""

    from_idx: int = 0
    to_idx: int = 0

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None):
        return inputs[0][:, self.from_idx:self.to_idx + 1], state

    def output_type(self, input_types):
        n = self.to_idx - self.from_idx + 1
        it = input_types[0]
        if it.kind == "recurrent":
            return InputType.recurrent(n, it.timeseries_length)
        return InputType.feed_forward(n)


@register_vertex
@dataclass(frozen=True)
class L2Vertex(GraphVertexSpec):
    """Row-wise L2 distance between two inputs -> [b, 1]."""

    eps: float = 1e-8

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None):
        a, b = inputs
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=1, keepdim=True)
                          + self.eps), state

    def output_type(self, input_types):
        return InputType.feed_forward(1)


@register_vertex
@dataclass(frozen=True)
class L2NormalizeVertex(GraphVertexSpec):
    """Rows scaled to unit L2 norm."""

    eps: float = 1e-8

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None):
        x = inputs[0]
        flat = x.reshape(x.shape[0], -1)
        norm = torch.sqrt(torch.sum(flat * flat, dim=1) + self.eps)
        return x / norm.reshape((-1,) + (1,) * (x.dim() - 1)), state


@register_vertex
@dataclass(frozen=True)
class StackVertex(GraphVertexSpec):
    """Stack along the batch axis."""

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None):
        return torch.cat(list(inputs), dim=0), state


@register_vertex
@dataclass(frozen=True)
class UnstackVertex(GraphVertexSpec):
    """Chunk ``from_idx`` of ``stack_size`` equal batch chunks."""

    from_idx: int = 0
    stack_size: int = 1

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_idx * n:(self.from_idx + 1) * n], state


@register_vertex
@dataclass(frozen=True)
class PreprocessorVertex(GraphVertexSpec):
    """A preprocessor as a vertex of its own."""

    preprocessor: InputPreProcessor = None  # type: ignore[assignment]

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None):
        x = inputs[0]
        t = int(x.shape[2]) if x.dim() == 3 else -1
        return self.preprocessor.preprocess(
            x, ShapeContext(batch=int(x.shape[0]), time=t)), state

    def output_type(self, input_types):
        return self.preprocessor.output_type(input_types[0])


@register_vertex
@dataclass(frozen=True)
class ScaleVertex(GraphVertexSpec):
    """Multiply by a fixed scalar."""

    scale: float = 1.0

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None):
        return inputs[0] * self.scale, state


@register_vertex
@dataclass(frozen=True)
class ShiftVertex(GraphVertexSpec):
    """Add a fixed scalar."""

    shift: float = 0.0

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None):
        return inputs[0] + self.shift, state


@register_vertex
@dataclass(frozen=True)
class LastTimeStepVertex(GraphVertexSpec):
    """[b, n, t] -> [b, n]: each row's last unmasked timestep (the last
    one without a mask)."""

    mask_input: str = ""

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None):
        x = inputs[0]
        if mask is None:
            return x[:, :, -1], state
        t = int(x.shape[2])
        # the last 1 of each [t] mask row (argmax takes the first max)
        idx = (t - 1) - torch.argmax(torch.flip(mask, dims=(1,)), dim=1)
        idx = idx.reshape(-1, 1, 1).expand(-1, x.shape[1], 1)
        return torch.gather(x, 2, idx)[:, :, 0], state

    def output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)


@register_vertex
@dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(GraphVertexSpec):
    """[b, n] -> [b, n, t] repeated over time; t is the length of the
    ``reference_input``'s series."""

    reference_input: str = ""

    def apply(self, params, inputs, state, *, train=False, rng=None,
              mask=None, time: int = 1):
        x = inputs[0]
        return x[:, :, None].expand(-1, -1, int(time)), state

    def output_type(self, input_types):
        return InputType.recurrent(input_types[0].size
                                   or input_types[0].flat_size())


# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ComputationGraphConfiguration:
    """Immutable DAG configuration: ``vertices`` by name, each with the
    names it reads (``vertex_inputs``), the graph's ``inputs`` and
    ``outputs``."""

    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    vertices: Dict[str, GraphVertexSpec]
    vertex_inputs: Dict[str, Tuple[str, ...]]
    seed: int = 12345
    iterations: int = 1
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "Standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    input_types: Optional[Tuple[InputType, ...]] = None
    optimization_algo: str = "STOCHASTIC_GRADIENT_DESCENT"
    max_num_line_search_iterations: int = 5
    # whole-net transform hints (nn/core.py), not serialized
    scan_layers: bool = False
    remat: str = "none"  # none | dots_saveable | full
    loss_scale: Optional[float] = None  # f16 dynamic loss scaling

    def topological_order(self) -> List[str]:
        """Kahn order of the vertex names: the sources in sorted order,
        then each vertex once its last input is placed, in the order the
        inputs were placed. Raises on an unknown input or a cycle."""
        indeg = {name: 0 for name in self.vertices}
        children: Dict[str, List[str]] = {name: [] for name in self.vertices}
        for name, ins in self.vertex_inputs.items():
            for src in ins:
                if src in self.vertices:
                    indeg[name] += 1
                    children[src].append(name)
                elif src not in self.inputs:
                    raise ValueError(
                        f"Vertex '{name}' references unknown input '{src}'")
        queue = sorted(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for c in children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
        if len(order) != len(self.vertices):
            cyc = set(self.vertices) - set(order)
            raise ValueError(f"Graph has a cycle involving: {sorted(cyc)}")
        return order

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "format": FORMAT,
            "inputs": list(self.inputs),
            "outputs": list(self.outputs),
            "vertices": {n: v.to_json() for n, v in self.vertices.items()},
            "vertex_inputs": {n: list(i)
                              for n, i in self.vertex_inputs.items()},
            "seed": self.seed,
            "iterations": self.iterations,
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "input_types": ([t.to_json() for t in self.input_types]
                            if self.input_types else None),
            "optimization_algo": self.optimization_algo,
            "max_num_line_search_iterations":
                self.max_num_line_search_iterations,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        fmt = d.get("format", FORMAT)
        if fmt != FORMAT:
            raise ValueError(
                f"not a ComputationGraphConfiguration: format {fmt!r}")
        return ComputationGraphConfiguration(
            inputs=tuple(d["inputs"]),
            outputs=tuple(d["outputs"]),
            vertices={n: GraphVertexSpec.from_json(v)
                      for n, v in d["vertices"].items()},
            vertex_inputs={n: tuple(i)
                           for n, i in d["vertex_inputs"].items()},
            seed=d.get("seed", 12345),
            iterations=d.get("iterations", 1),
            dtype=d.get("dtype", "float32"),
            compute_dtype=d.get("compute_dtype"),
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            backprop_type=d.get("backprop_type", "Standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            input_types=(tuple(InputType.from_json(t)
                               for t in d["input_types"])
                         if d.get("input_types") else None),
            optimization_algo=d.get("optimization_algo",
                                    "STOCHASTIC_GRADIENT_DESCENT"),
            max_num_line_search_iterations=d.get(
                "max_num_line_search_iterations", 5),
        )

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))


class GraphBuilder:
    """Reference ``ComputationGraphConfiguration.GraphBuilder``; made by
    ``NeuralNetConfiguration.Builder().graph_builder()``, whose globals
    resolve into every layer added."""

    def __init__(self, parent=None):
        from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
            NeuralNetConfiguration,
        )

        self._parent = parent or NeuralNetConfiguration.Builder()
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, GraphVertexSpec] = {}
        self._vertex_inputs: Dict[str, Tuple[str, ...]] = {}
        self._input_types: Optional[List[InputType]] = None
        self._backprop = True
        self._pretrain = False
        self._backprop_type = "Standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def add_inputs(self, *names: str) -> "GraphBuilder":
        for n in names:
            if n in self._inputs or n in self._vertices:
                raise ValueError(f"Duplicate vertex/input name '{n}'")
            self._inputs.append(n)
        return self

    def add_layer(self, name: str, layer: layer_base.LayerSpec, *inputs: str,
                  preprocessor: Optional[InputPreProcessor] = None
                  ) -> "GraphBuilder":
        self._check_name(name)
        self._vertices[name] = LayerVertex(
            layer_conf=self._parent._resolve_layer(layer),
            preprocessor=preprocessor)
        self._vertex_inputs[name] = tuple(inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertexSpec,
                   *inputs: str) -> "GraphBuilder":
        self._check_name(name)
        self._vertices[name] = vertex
        self._vertex_inputs[name] = tuple(inputs)
        return self

    def _check_name(self, name: str) -> None:
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"Duplicate vertex/input name '{name}'")

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def backprop(self, b: bool) -> "GraphBuilder":
        self._backprop = b
        return self

    def pretrain(self, p: bool) -> "GraphBuilder":
        self._pretrain = p
        return self

    def backprop_type(self, t: str) -> "GraphBuilder":
        self._backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_fwd = n
        return self

    def t_bptt_backward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_back = n
        return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs:
            raise ValueError("Graph needs addInputs(...)")
        if not self._outputs:
            raise ValueError("Graph needs setOutputs(...)")
        for out in self._outputs:
            if out not in self._vertices:
                raise ValueError(f"Output '{out}' is not a vertex")
        p = self._parent
        conf = ComputationGraphConfiguration(
            inputs=tuple(self._inputs),
            outputs=tuple(self._outputs),
            vertices=dict(self._vertices),
            vertex_inputs=dict(self._vertex_inputs),
            seed=p._seed,
            iterations=p._iterations,
            dtype=p._dtype,
            compute_dtype=p._compute_dtype,
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_types=(tuple(self._input_types)
                         if self._input_types else None),
            optimization_algo=p._optimization_algo,
            max_num_line_search_iterations=p._max_num_line_search_iterations,
            scan_layers=p._scan_layers,
            remat=p._remat,
            loss_scale=p._loss_scale,
        )
        if self._input_types is not None:
            conf = _infer_shapes(conf)
        conf.topological_order()  # checks the references and acyclicity
        return conf


def _infer_shapes(conf: ComputationGraphConfiguration
                  ) -> ComputationGraphConfiguration:
    """Carry the InputTypes through the topological order: fill each
    layer vertex's nIn and insert a shape preprocessor where the
    incoming family differs from the layer's (e.g. CNN -> FF before the
    first dense layer, flattening in (c, h, w) order)."""
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        _auto_preprocessor,
    )

    types: Dict[str, InputType] = dict(zip(conf.inputs,
                                           conf.input_types or ()))
    if len(types) != len(conf.inputs):
        raise ValueError("setInputTypes must cover every graph input")
    new_vertices = dict(conf.vertices)
    for name in conf.topological_order():
        v = new_vertices[name]
        in_types = [types[i] for i in conf.vertex_inputs[name]]
        if isinstance(v, LayerVertex):
            it = in_types[0]
            if v.preprocessor is not None:
                it = v.preprocessor.output_type(it)
            else:
                auto = _auto_preprocessor(it, v.layer_conf.input_kind())
                if auto is not None:
                    v = dataclasses.replace(v, preprocessor=auto)
                    it = auto.output_type(it)
            layer = v.layer_conf.with_input_type(it)
            v = dataclasses.replace(v, layer_conf=layer)
            new_vertices[name] = v
        types[name] = v.output_type(in_types)
    return dataclasses.replace(conf, vertices=new_vertices)
