"""Input preprocessors: shape adapters between layer families.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py`` for the
two adapters the convolutional stacks use (``[b, c, h, w] <-> [b,
c*h*w]``) and the two between recurrent and feed-forward layers (``[b,
size, t] <-> [b*t, size]``, one row per timestep), with the same
reshape orders and the same JSON. A ``ShapeContext`` carries the
minibatch size and the sequence length, which the 2-d -> 3-d adapter
needs. The CNN <-> RNN adapters and the rest are not ported yet; a
configuration that names one fails to load with a clear error.
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
