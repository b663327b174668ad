"""Datasets and iterators."""

from deeplearning4j_tpu_torch.datasets.api import (  # noqa: F401
    ChunkedDataSet,
    DataSet,
    DataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
    MultiDataSet,
    PlacedChunk,
    PlacedDataSet,
)
from deeplearning4j_tpu_torch.datasets.cifar import (  # noqa: F401
    CifarDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    AsyncDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.prefetch import (  # noqa: F401
    PrefetchIterator,
)
from deeplearning4j_tpu_torch.datasets.validate import (  # noqa: F401
    BatchSchema,
    BatchValidator,
    QuarantineStore,
    ValidatingIterator,
)
