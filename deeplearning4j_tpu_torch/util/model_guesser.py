"""Load "whatever model file this is" (reference ``ModelGuesser``).

Counterpart of ``deeplearning4j_tpu/util/model_guesser.py``: each known
artifact format is tried in turn and the right model object returned,
on ``device`` (default the card; ``"cpu"`` for the plain versions).

Order tried:
1. checkpoint zip (the ModelSerializer layout: ``configuration.json`` +
   ``coefficients.npz``, ``util/model_serializer.py``) →
   MultiLayerNetwork / ComputationGraph,
2. Keras HDF5 (.h5) → imported MultiLayerNetwork (``modelimport``),
3. bare configuration JSON → un-initialized model from its conf.
"""

from __future__ import annotations

import json
import os
import zipfile


class ModelGuessingException(ValueError):
    pass


def load_model_guess(path: str, device=None):
    """A model for any supported artifact (reference
    ``ModelGuesser.loadModelGuess``)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
        if "configuration.json" in names:
            from deeplearning4j_tpu_torch.util.model_serializer import (
                restore_model,
            )

            return restore_model(path, device=device)
    # HDF5 magic
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(b"\x89HDF\r\n\x1a\n"):
        from deeplearning4j_tpu_torch.modelimport import keras as keras_import

        try:
            return keras_import.import_sequential_model(path, device=device)
        except Exception:
            return keras_import.import_functional_api_model(path,
                                                            device=device)
    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ModelGuessingException(
            f"{path!r} is not a checkpoint zip, Keras HDF5, or "
            f"configuration JSON ({e})"
        )
    return config_guess(d, device=device)


def config_guess(d, device=None):
    """An un-initialized model from a conf dict or JSON text (reference
    ``ModelGuesser.loadConfigGuess``)."""
    if isinstance(d, str):
        d = json.loads(d)
    fmt = d.get("format", "")
    if "MultiLayerConfiguration" in fmt:
        from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
            MultiLayerConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        return MultiLayerNetwork(MultiLayerConfiguration.from_dict(d),
                                 device=device)
    if "ComputationGraphConfiguration" in fmt:
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            ComputationGraphConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        return ComputationGraph(ComputationGraphConfiguration.from_dict(d),
                                device=device)
    raise ModelGuessingException(
        f"unrecognized configuration format {fmt!r}"
    )
