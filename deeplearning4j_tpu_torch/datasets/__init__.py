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
from deeplearning4j_tpu_torch.datasets.curves import (  # noqa: F401
    CurvesDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.iris import (  # noqa: F401
    IrisDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.lfw import (  # noqa: F401
    LFWDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.record_reader import (  # noqa: F401
    CollectionRecordReader,
    CollectionSequenceRecordReader,
    CSVRecordReader,
    CSVSequenceRecordReader,
    RecordReader,
    RecordReaderDataSetIterator,
    RecordReaderMultiDataSetIterator,
    SequenceRecordReader,
    SequenceRecordReaderDataSetIterator,
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
