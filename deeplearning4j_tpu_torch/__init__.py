"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for NVIDIA Hopper (H100).

The module layout mirrors the JAX package's, so each module here has
its counterpart under the same path there. Every TPU kernel the port
has reached is a hand-written CUDA kernel under ``csrc/`` with a plain
PyTorch version beside it (``ops/``). Entry points run on ``"cuda"``
unless the caller passes ``device="cpu"``.

Importing the package is light: no kernel is built and no device is
touched until a kernel is launched.
"""

__version__ = "0.1.0"
