"""Hand-written Hopper kernels and their plain PyTorch versions.

Importing this package builds nothing: the CUDA library is compiled at
the first kernel launch (``_build.load``).
"""

from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.ops.conv_block import (
    SUPPORTED_EPILOGUES,
    conv_block,
    conv_block_reference,
    conv_bwd_data,
    conv_bwd_data_reference,
    conv_bwd_w,
    conv_bwd_w_reference,
)
from deeplearning4j_tpu_torch.ops.matmul_block import (
    matmul_block,
    matmul_block_reference,
)

__all__ = [
    "SUPPORTED_EPILOGUES",
    "conv_block",
    "conv_block_reference",
    "conv_bwd_data",
    "conv_bwd_data_reference",
    "conv_bwd_w",
    "conv_bwd_w_reference",
    "dispatch",
    "matmul_block",
    "matmul_block_reference",
]
