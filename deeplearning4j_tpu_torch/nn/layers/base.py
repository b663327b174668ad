"""Layer contract and registry.

Counterpart of ``deeplearning4j_tpu/nn/layers/base.py``. A layer is a
frozen dataclass that is at once its JSON-serializable configuration
and its forward; the fields (names, order, defaults) are the JAX
package's, so ``configuration.json`` files move between the two
packages unchanged.

Contract:
- ``init_params(gen, dtype) -> {name: tensor}`` on the CPU generator,
  named like the reference's param keys (``"W"``, ``"b"``).
- ``apply(params, x, state, *, train=False, gen=None) -> (y, state)``:
  the forward; with ``train`` it is differentiable (autograd through
  the kernels' backward). ``gen`` is the explicit ``torch.Generator``
  that dropout will draw from. Dropout and drop-connect train with the
  AlexNet-training slice: a training forward of a layer that sets a
  dropout rate raises (``check_train``) instead of ignoring it.
- ``output_type(input)`` / ``with_input_type(input)`` implement the
  reference's InputType shape inference.
- ``updater_settings()`` / ``regularizable_params()``: what the updater
  and the L1/L2 penalty read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Type

import torch

from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.updaters import UpdaterSettings
from deeplearning4j_tpu_torch.nn.weights import Distribution

LAYER_REGISTRY: Dict[str, Type["LayerSpec"]] = {}


def register_layer(cls):
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_to_json(layer: "LayerSpec") -> dict:
    d = {"@class": type(layer).__name__}
    for f in dataclasses.fields(layer):
        v = getattr(layer, f.name)
        if isinstance(v, Distribution):
            v = {"@dist": True, **v.to_json()}
        elif isinstance(v, InputType):
            v = {"@input_type": True, **v.to_json()}
        elif isinstance(v, LayerSpec):
            v = layer_to_json(v)
        elif isinstance(v, tuple):
            v = list(v)
        d[f.name] = v
    return d


def layer_from_json(d: dict) -> "LayerSpec":
    d = dict(d)
    name = d.pop("@class")
    try:
        cls = LAYER_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown layer type '{name}' (ported so far: "
            f"{sorted(LAYER_REGISTRY)}); register custom layers with "
            f"@register_layer before deserializing"
        ) from None
    kwargs = {}
    field_names = {f.name for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in field_names:
            continue  # forward compat: ignore unknown fields
        if isinstance(v, dict) and v.get("@dist"):
            v = Distribution.from_json({
                kk: vv for kk, vv in v.items() if kk != "@dist"
            })
        elif isinstance(v, dict) and v.get("@input_type"):
            v = InputType.from_json({
                kk: vv for kk, vv in v.items() if kk != "@input_type"
            })
        elif isinstance(v, dict) and "@class" in v:
            v = layer_from_json(v)
        elif isinstance(v, list):
            v = tuple(
                layer_from_json(x) if isinstance(x, dict) and "@class" in x
                else x
                for x in v
            )
        kwargs[k] = v
    return cls(**kwargs)


@dataclass(frozen=True)
class LayerSpec:
    """Base config + forward of all layers (reference
    ``nn/conf/layers/Layer.java`` bean fields)."""

    name: str = ""
    activation: str = "sigmoid"
    weight_init: str = "XAVIER"
    dist: Distribution | None = None
    bias_init: float = 0.0
    dropout: float = 0.0
    drop_connect: bool = False
    # optimizer settings (per-layer overrides)
    updater: str = "SGD"
    learning_rate: float = 0.1
    bias_learning_rate: float | None = None
    momentum: float = 0.9
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    rho: float = 0.95
    rms_decay: float = 0.95
    epsilon: float = 1e-8
    l1: float = 0.0
    l2: float = 0.0
    gradient_normalization: str = "None"
    gradient_normalization_threshold: float = 1.0
    lr_policy: str = "None"
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_power: float = 1.0
    lr_schedule: dict | None = None

    # -- shape inference ---------------------------------------------------

    def with_input_type(self, input_type: InputType) -> "LayerSpec":
        """A copy with nIn etc. inferred (reference ``Layer.setNIn``)."""
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    # -- params / state ----------------------------------------------------

    def init_params(self, gen: torch.Generator,
                    dtype=torch.float32) -> dict:
        return {}

    def init_state(self, dtype=torch.float32) -> dict:
        return {}

    def regularizable_params(self) -> tuple:
        return ("W",)

    # -- forward -----------------------------------------------------------

    def apply(self, params, x, state, *, train=False, gen=None):
        raise NotImplementedError

    def check_train(self, train: bool) -> None:
        """Dropout (on the input, or on the weights with drop-connect)
        is not ported yet: refuse to train such a layer rather than
        train it without its regularization."""
        if train and self.dropout > 0.0:
            kind = "drop-connect" if self.drop_connect else "dropout"
            raise NotImplementedError(
                f"{type(self).__name__} '{self.name}': training with "
                f"{kind} (rate {self.dropout}) arrives with the "
                "AlexNet-training slice"
            )

    def activate_fn(self):
        return activations.get(self.activation)

    def updater_settings(self) -> UpdaterSettings:
        return UpdaterSettings(
            updater=self.updater,
            learning_rate=self.learning_rate,
            bias_learning_rate=self.bias_learning_rate,
            momentum=self.momentum,
            adam_mean_decay=self.adam_mean_decay,
            adam_var_decay=self.adam_var_decay,
            rho=self.rho,
            rms_decay=self.rms_decay,
            epsilon=self.epsilon,
            l1=self.l1,
            l2=self.l2,
            gradient_normalization=self.gradient_normalization,
            gradient_normalization_threshold=(
                self.gradient_normalization_threshold),
            lr_policy=self.lr_policy,
            lr_policy_decay_rate=self.lr_policy_decay_rate,
            lr_policy_steps=self.lr_policy_steps,
            lr_policy_power=self.lr_policy_power,
            lr_schedule=self.lr_schedule,
            regularizable=self.regularizable_params(),
        )

    def has_loss(self) -> bool:
        return False

    def input_kind(self) -> str:
        """Data family this layer consumes: feedforward | convolutional
        | recurrent | any. Drives auto-preprocessor insertion."""
        return "feedforward"


@dataclass(frozen=True)
class FeedForwardLayerSpec(LayerSpec):
    """Base for layers with nIn/nOut."""

    n_in: int = 0
    n_out: int = 0

    def with_input_type(self, input_type: InputType) -> "FeedForwardLayerSpec":
        if self.n_in == 0:
            return dataclasses.replace(self, n_in=input_type.flat_size())
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)
