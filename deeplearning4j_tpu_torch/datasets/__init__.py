"""Datasets and iterators."""

from deeplearning4j_tpu_torch.datasets.api import (  # noqa: F401
    DataSet,
    DataSetIterator,
    ListDataSetIterator,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.datasets.cifar import (  # noqa: F401
    CifarDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataSetIterator,
)
