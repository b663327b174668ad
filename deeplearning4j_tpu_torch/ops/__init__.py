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
from deeplearning4j_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    mha,
)
from deeplearning4j_tpu_torch.ops.lstm_cell import (
    lstm_cell,
    lstm_cell_diff,
    lstm_cell_reference,
    lstm_seq_bwd,
    lstm_seq_bwd_reference,
    lstm_seq_fwd,
    lstm_seq_fwd_reference,
    lstm_sequence,
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
    "flash_attention",
    "flash_attention_reference",
    "lstm_cell",
    "lstm_cell_diff",
    "lstm_cell_reference",
    "lstm_seq_bwd",
    "lstm_seq_bwd_reference",
    "lstm_seq_fwd",
    "lstm_seq_fwd_reference",
    "lstm_sequence",
    "matmul_block",
    "matmul_block_reference",
    "mha",
]
