"""Datasets and iterators."""

from deeplearning4j_tpu_torch.datasets.api import (  # noqa: F401
    DataSet,
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataSetIterator,
)
