"""Input types for shape inference.

Copy of ``deeplearning4j_tpu/nn/conf/inputs.py`` (the port imports
nothing of the JAX package). Shape conventions are the reference's:
feed-forward ``[batch, size]``, convolutional ``[batch, channels,
height, width]`` (NCHW), recurrent ``[batch, size, time]``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class InputType:
    kind: str  # "feedforward" | "recurrent" | "convolutional" | "convolutionalFlat"
    size: int = 0  # feedforward / recurrent feature size
    height: int = 0
    width: int = 0
    channels: int = 0
    timeseries_length: int = -1  # -1: unknown/variable

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="feedforward", size=int(size))

    @staticmethod
    def recurrent(size: int, timeseries_length: int = -1) -> "InputType":
        return InputType(
            kind="recurrent", size=int(size),
            timeseries_length=int(timeseries_length),
        )

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(
            kind="convolutional", height=int(height), width=int(width),
            channels=int(channels),
        )

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputType":
        """Flattened image rows, e.g. MNIST 784."""
        return InputType(
            kind="convolutionalFlat", height=int(height), width=int(width),
            channels=int(channels), size=int(height * width * channels),
        )

    def flat_size(self) -> int:
        if self.kind in ("feedforward", "recurrent", "convolutionalFlat"):
            return (self.size if self.size
                    else self.height * self.width * self.channels)
        return self.channels * self.height * self.width

    def to_json(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_json(d: dict) -> "InputType":
        return InputType(**d)
