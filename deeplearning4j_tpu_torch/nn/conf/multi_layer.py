"""Network configuration DSL.

Counterpart of ``deeplearning4j_tpu/nn/conf/multi_layer.py``: the
``NeuralNetConfiguration.Builder`` / ``ListBuilder`` pair and the
immutable ``MultiLayerConfiguration``, whose JSON is the JAX package's
``configuration.json`` as written (same ``format`` tag, same keys), so
a configuration saved by either package loads in the other. Builder
globals resolve into every layer that kept its class default, and
InputType shape inference fills each layer's nIn and inserts the shape
preprocessors, as there.

The whole-net transform hints (``scan_layers``, ``remat``,
``loss_scale``) ride on the configuration as in the JAX package and are
deliberately not serialized: they change how a step runs, never the
model, so a checkpoint trained with them off restores into a model
running them on (``nn/core.py`` ``set_transforms`` overrides them at
run time).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    InputPreProcessor,
    RnnToFeedForwardPreProcessor,
)
# a module reference, not names: importing the layers package imports
# nn.conf (layers/base.py needs InputType), which lands here while
# layers/base.py is still half-initialized
from deeplearning4j_tpu_torch.nn.layers import base as layer_base

FORMAT = "deeplearning4j_tpu.MultiLayerConfiguration"

# Builder-global fields that flow into every layer that kept its class
# default (reference: per-layer clone of the global conf).
_GLOBAL_LAYER_FIELDS = (
    "activation", "weight_init", "dist", "bias_init", "dropout",
    "drop_connect", "updater", "learning_rate", "bias_learning_rate",
    "momentum", "adam_mean_decay", "adam_var_decay", "rho", "rms_decay",
    "epsilon", "l1", "l2", "gradient_normalization",
    "gradient_normalization_threshold", "lr_policy",
    "lr_policy_decay_rate", "lr_policy_steps", "lr_policy_power",
    "lr_schedule",
)


@dataclass(frozen=True)
class MultiLayerConfiguration:
    """Immutable resolved config."""

    layers: Tuple[layer_base.LayerSpec, ...]
    preprocessors: Dict[int, InputPreProcessor] = field(default_factory=dict)
    seed: int = 12345
    iterations: int = 1
    dtype: str = "float32"
    # forward compute dtype (e.g. "bfloat16") while params keep
    # ``dtype``; None = compute in ``dtype``
    compute_dtype: Optional[str] = None
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "Standard"  # Standard | TruncatedBPTT
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    input_type: Optional[InputType] = None
    optimization_algo: str = "STOCHASTIC_GRADIENT_DESCENT"
    max_num_line_search_iterations: int = 5
    minimize: bool = True
    # whole-net transform hints (nn/core.py), not serialized
    scan_layers: bool = False
    remat: str = "none"  # none | dots_saveable | full
    loss_scale: Optional[float] = None  # f16 dynamic loss scaling

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def to_dict(self) -> dict:
        return {
            "format": FORMAT,
            "layers": [layer_base.layer_to_json(l) for l in self.layers],
            "preprocessors": {
                str(i): p.to_json() for i, p in self.preprocessors.items()
            },
            "seed": self.seed,
            "iterations": self.iterations,
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "input_type": (self.input_type.to_json()
                           if self.input_type else None),
            "optimization_algo": self.optimization_algo,
            "max_num_line_search_iterations":
                self.max_num_line_search_iterations,
            "minimize": self.minimize,
        }

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        fmt = d.get("format", FORMAT)
        if fmt != FORMAT:
            raise ValueError(f"not a MultiLayerConfiguration: format {fmt!r}")
        return MultiLayerConfiguration(
            layers=tuple(layer_base.layer_from_json(l)
                         for l in d["layers"]),
            preprocessors={
                int(i): InputPreProcessor.from_json(p)
                for i, p in d.get("preprocessors", {}).items()
            },
            seed=d.get("seed", 12345),
            iterations=d.get("iterations", 1),
            dtype=d.get("dtype", "float32"),
            compute_dtype=d.get("compute_dtype"),
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            backprop_type=d.get("backprop_type", "Standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            input_type=(InputType.from_json(d["input_type"])
                        if d.get("input_type") else None),
            optimization_algo=d.get("optimization_algo",
                                    "STOCHASTIC_GRADIENT_DESCENT"),
            max_num_line_search_iterations=d.get(
                "max_num_line_search_iterations", 5),
            minimize=d.get("minimize", True),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    def layer_name(self, i: int) -> str:
        return self.layers[i].name or str(i)


def _auto_preprocessor(current: InputType,
                       wanted: str) -> Optional[InputPreProcessor]:
    """The adapter the reference's InputType machinery would insert."""
    have = current.kind
    if wanted == "any" or have == wanted:
        return None
    if wanted == "feedforward":
        if have == "convolutional":
            return CnnToFeedForwardPreProcessor(
                current.height, current.width, current.channels
            )
        if have == "recurrent":
            return RnnToFeedForwardPreProcessor()
        if have == "convolutionalFlat":
            return None  # already flat rows
    if wanted == "convolutional":
        if have in ("feedforward", "convolutionalFlat"):
            if current.height and current.width:
                return FeedForwardToCnnPreProcessor(
                    current.height, current.width, max(current.channels, 1)
                )
            raise ValueError(
                "Cannot infer CNN input shape from a plain feed-forward "
                "input; use InputType.convolutionalFlat(h, w, c)"
            )
        if have == "recurrent":
            raise ValueError("RnnToCnn requires explicit h/w/c preprocessor")
    if wanted == "recurrent":
        if have in ("feedforward", "convolutionalFlat"):
            return FeedForwardToRnnPreProcessor()
        if have == "convolutional":
            return CnnToRnnPreProcessor(
                current.height, current.width, current.channels
            )
    return None


class ListBuilder:
    """Reference ``NeuralNetConfiguration.ListBuilder``."""

    def __init__(self, parent: "NeuralNetConfiguration.Builder"):
        self._parent = parent
        self._layers: list = []
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = "Standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._input_type: Optional[InputType] = None

    def layer(self, index_or_layer, maybe_layer=None) -> "ListBuilder":
        """Accepts ``.layer(conf)`` or reference-style ``.layer(i, conf)``."""
        if maybe_layer is None:
            self._layers.append(index_or_layer)
        else:
            i = int(index_or_layer)
            while len(self._layers) <= i:
                self._layers.append(None)
            self._layers[i] = maybe_layer
        return self

    def input_pre_processor(self, i: int,
                            p: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[int(i)] = p
        return self

    def backprop(self, b: bool) -> "ListBuilder":
        self._backprop = b
        return self

    def pretrain(self, p: bool) -> "ListBuilder":
        self._pretrain = p
        return self

    def backprop_type(self, t: str) -> "ListBuilder":
        self._backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = n
        return self

    def t_bptt_backward_length(self, n: int) -> "ListBuilder":
        self._tbptt_back = n
        return self

    def set_input_type(self, it: InputType) -> "ListBuilder":
        self._input_type = it
        return self

    def build(self) -> MultiLayerConfiguration:
        layers = [l for l in self._layers if l is not None]
        resolved = [self._parent._resolve_layer(l) for l in layers]
        preprocessors = dict(self._preprocessors)
        it = self._input_type
        final = []
        if it is not None:
            # InputType-driven shape inference + preprocessor insertion
            for i, layer in enumerate(resolved):
                if i in preprocessors:
                    it = preprocessors[i].output_type(it)
                else:
                    auto = _auto_preprocessor(it, layer.input_kind())
                    if auto is not None:
                        preprocessors[i] = auto
                        it = auto.output_type(it)
                layer = layer.with_input_type(it)
                final.append(layer)
                it = layer.output_type(it)
        else:
            # chain nIn from the previous nOut where possible
            prev: Optional[InputType] = None
            for i, layer in enumerate(resolved):
                if prev is not None:
                    if i in preprocessors:
                        prev = preprocessors[i].output_type(prev)
                    layer = layer.with_input_type(prev)
                final.append(layer)
                try:
                    prev = layer.output_type(
                        prev if prev is not None
                        else InputType.feed_forward(getattr(layer, "n_in", 0))
                    )
                except ValueError:
                    prev = None
        p = self._parent
        return MultiLayerConfiguration(
            layers=tuple(final),
            preprocessors=preprocessors,
            seed=p._seed,
            iterations=p._iterations,
            dtype=p._dtype,
            compute_dtype=p._compute_dtype,
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_type=self._input_type,
            optimization_algo=p._optimization_algo,
            max_num_line_search_iterations=(
                p._max_num_line_search_iterations),
            minimize=p._minimize,
            scan_layers=p._scan_layers,
            remat=p._remat,
            loss_scale=p._loss_scale,
        )


class NeuralNetConfiguration:
    """Namespace mirroring the reference class; use
    ``NeuralNetConfiguration.Builder()``."""

    class Builder:
        def __init__(self):
            self._seed = 12345
            self._iterations = 1
            self._dtype = "float32"
            self._compute_dtype = None
            self._optimization_algo = "STOCHASTIC_GRADIENT_DESCENT"
            self._max_num_line_search_iterations = 5
            self._minimize = True
            self._scan_layers = False
            self._remat = "none"
            self._loss_scale = None
            self._globals: dict = {}

        def seed(self, s: int):
            self._seed = int(s)
            return self

        def iterations(self, n: int):
            self._iterations = int(n)
            return self

        def data_type(self, dtype: str):
            self._dtype = dtype
            return self

        def compute_data_type(self, dtype):
            """Run the forward in ``dtype`` (e.g. bf16) while params
            keep the storage ``data_type``."""
            self._compute_dtype = dtype
            return self

        def optimization_algo(self, algo: str):
            self._optimization_algo = algo
            return self

        def max_num_line_search_iterations(self, n: int):
            self._max_num_line_search_iterations = int(n)
            return self

        def minimize(self, m: bool):
            self._minimize = m
            return self

        def scan_layers(self, enabled: bool = True):
            """Whole-net transform hint: the JAX package runs homogeneous
            layer runs under one ``lax.scan``; the port's eager layer
            loop is the same either way. Trajectory-neutral."""
            self._scan_layers = bool(enabled)
            return self

        def remat(self, policy: str = "full"):
            """Whole-net transform hint: activation rematerialization
            (``none | dots_saveable | full``), recompute for memory in
            the backward."""
            from deeplearning4j_tpu_torch.nn.core import check_remat_policy

            self._remat = check_remat_policy(policy)
            return self

        def loss_scale(self, scale=True):
            """Dynamic loss scaling for ``compute_data_type("float16")``
            (True: the default 2**15 initial scale; a number: the
            initial scale; None / 0: off). bf16 is unaffected."""
            self._loss_scale = scale
            return self

        def use_drop_connect(self, use: bool = True):
            self._globals["drop_connect"] = bool(use)
            return self

        def regularization(self, use: bool):
            if not use:
                self._globals["l1"] = 0.0
                self._globals["l2"] = 0.0
            return self

        def __getattr__(self, name):
            # generic global setter for any per-layer field:
            # .activation("relu"), .learning_rate(0.1), .updater("ADAM")
            if name.startswith("_"):
                raise AttributeError(name)
            if name in _GLOBAL_LAYER_FIELDS:
                def setter(value):
                    self._globals[name] = value
                    return self
                return setter
            raise AttributeError(
                f"Unknown builder option '{name}'. Per-layer fields: "
                f"{_GLOBAL_LAYER_FIELDS}"
            )

        def list(self) -> ListBuilder:
            return ListBuilder(self)

        def graph_builder(self):
            """Reference ``NeuralNetConfiguration.Builder.graphBuilder()``:
            a ``GraphBuilder`` that resolves these globals into its
            layers."""
            from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
                GraphBuilder,
            )

            return GraphBuilder(self)

        def _resolve_layer(self, layer: layer_base.LayerSpec
                           ) -> layer_base.LayerSpec:
            """Apply builder globals to fields the layer left at class
            default; a default the layer class redefined (e.g.
            OutputLayer.activation = "softmax") is protected."""
            updates = {}
            cls = type(layer)
            base_fields = layer_base.LayerSpec.__dataclass_fields__
            for fname, value in self._globals.items():
                fdef = cls.__dataclass_fields__.get(fname)
                if fdef is None:
                    continue
                default = (fdef.default
                           if fdef.default is not dataclasses.MISSING
                           else None)
                if getattr(layer, fname) != default:
                    continue  # user set it on the layer instance
                bdef = base_fields.get(fname)
                if (bdef is not None
                        and bdef.default is not dataclasses.MISSING
                        and default != bdef.default):
                    continue  # subclass redefined the default
                updates[fname] = value
            if updates:
                layer = dataclasses.replace(layer, **updates)
            return layer
