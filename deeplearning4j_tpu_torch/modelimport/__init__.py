"""Keras model import (reference ``deeplearning4j-modelimport``)."""

from deeplearning4j_tpu_torch.modelimport.keras import (
    IncompatibleKerasConfigurationException,
    import_functional_api_config,
    import_functional_api_model,
    import_sequential_model,
    import_sequential_model_arrays,
    import_sequential_model_config,
)

__all__ = [
    "IncompatibleKerasConfigurationException",
    "import_functional_api_config",
    "import_functional_api_model",
    "import_sequential_model",
    "import_sequential_model_arrays",
    "import_sequential_model_config",
]
