"""Input preprocessors: shape adapters between layer families.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py``, all ten
adapters with the same reshape orders and the same JSON (each
registered by its ``@class``): between convolutional and feed-forward
layers (``[b, c, h, w] <-> [b, c*h*w]``), between recurrent and
feed-forward layers (``[b, size, t] <-> [b*t, size]``, one row per
timestep), between convolutional and recurrent layers (``[b*t, c, h,
w] <-> [b, c*h*w, t]``: the frames of a sequence stacked along the
batch, timestep-major within each example), a free-form reshape, the
per-minibatch standardizers (``ZeroMeanPrePreProcessor``,
``UnitVarianceProcessor``: population statistics over the batch axis)
and a composition. A ``ShapeContext`` carries the minibatch size and
the sequence length, which the adapters into the recurrent layout
need. Backprop through them is autograd's, as it is ``jax.grad``'s in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Type

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

PREPROCESSOR_REGISTRY: Dict[str, Type["InputPreProcessor"]] = {}


def register_preprocessor(cls):
    PREPROCESSOR_REGISTRY[cls.__name__] = cls
    return cls


@dataclass(frozen=True)
class ShapeContext:
    batch: int = 0
    time: int = -1


@dataclass(frozen=True)
class InputPreProcessor:
    def preprocess(self, x, ctx: ShapeContext):
        return x

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def to_json(self) -> dict:
        d = {"@class": type(self).__name__}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    @staticmethod
    def from_json(d: dict) -> "InputPreProcessor":
        d = dict(d)
        name = d.pop("@class")
        try:
            cls = PREPROCESSOR_REGISTRY[name]
        except KeyError:
            raise ValueError(
                f"Preprocessor '{name}' is not ported yet (known: "
                f"{sorted(PREPROCESSOR_REGISTRY)})"
            ) from None
        if cls.from_json is not InputPreProcessor.from_json:
            return cls.from_json({"@class": cls.__name__, **d})
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in d.items() if k in names
        })


@register_preprocessor
@dataclass(frozen=True)
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, c, h, w] -> [b, c*h*w]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def preprocess(self, x, ctx):
        return x.reshape(x.shape[0], -1)

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(it.channels * it.height * it.width)


@register_preprocessor
@dataclass(frozen=True)
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[b, c*h*w] -> [b, c, h, w]."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def preprocess(self, x, ctx):
        return x.reshape(x.shape[0], self.channels, self.height, self.width)

    def output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclass(frozen=True)
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, size, t] -> [b*t, size]: dense layers see one row per
    timestep (reference ``RnnToFeedForwardPreProcessor.java``)."""

    def preprocess(self, x, ctx):
        return x.permute(0, 2, 1).reshape(-1, x.shape[1])

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(it.size)


@register_preprocessor
@dataclass(frozen=True)
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[b*t, size] -> [b, size, t]."""

    def preprocess(self, x, ctx):
        return x.reshape(-1, ctx.time, x.shape[-1]).permute(0, 2, 1)

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.size)


@register_preprocessor
@dataclass(frozen=True)
class CnnToRnnPreProcessor(InputPreProcessor):
    """[b*t, c, h, w] (the frames of each sequence stacked along the
    batch) -> [b, c*h*w, t]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def preprocess(self, x, ctx):
        flat = x.reshape(x.shape[0], -1)                     # [b*t, chw]
        return flat.reshape(-1, ctx.time, flat.shape[-1]).permute(0, 2, 1)

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.channels * it.height * it.width)


@register_preprocessor
@dataclass(frozen=True)
class RnnToCnnPreProcessor(InputPreProcessor):
    """[b, c*h*w, t] -> [b*t, c, h, w]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def preprocess(self, x, ctx):
        rows = x.permute(0, 2, 1).reshape(-1, x.shape[1])
        return rows.reshape(-1, self.channels, self.height, self.width)

    def output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


@register_preprocessor
@dataclass(frozen=True)
class ReshapePreProcessor(InputPreProcessor):
    """A free-form reshape keeping the batch axis (reference
    ``ReshapePreProcessor.java``)."""

    shape: tuple = ()

    def preprocess(self, x, ctx):
        return x.reshape((x.shape[0],) + tuple(self.shape))


@register_preprocessor
@dataclass(frozen=True)
class ZeroMeanPrePreProcessor(InputPreProcessor):
    """Subtract the minibatch's mean over the batch axis."""

    def preprocess(self, x, ctx):
        return x - x.mean(dim=0, keepdim=True)


@register_preprocessor
@dataclass(frozen=True)
class UnitVarianceProcessor(InputPreProcessor):
    """Divide by the minibatch's population standard deviation over the
    batch axis (plus 1e-8)."""

    def preprocess(self, x, ctx):
        return x / (x.std(dim=0, keepdim=True, correction=0) + 1e-8)


@register_preprocessor
@dataclass(frozen=True)
class ComposableInputPreProcessor(InputPreProcessor):
    """The given preprocessors applied in order."""

    processors: tuple = ()

    def preprocess(self, x, ctx):
        for p in self.processors:
            x = p.preprocess(x, ctx)
        return x

    def output_type(self, it: InputType) -> InputType:
        for p in self.processors:
            it = p.output_type(it)
        return it

    def to_json(self) -> dict:
        return {"@class": type(self).__name__,
                "processors": [p.to_json() for p in self.processors]}

    @staticmethod
    def from_json(d: dict) -> "ComposableInputPreProcessor":
        return ComposableInputPreProcessor(processors=tuple(
            InputPreProcessor.from_json(p) for p in d["processors"]))
