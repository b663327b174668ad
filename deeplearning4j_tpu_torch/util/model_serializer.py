"""Checkpoint save/restore, and the bridge that carries the JAX
package's parameters into the port.

Counterpart of ``deeplearning4j_tpu/util/model_serializer.py`` for the
inference slice: the checkpoint is the same zip, holding
``configuration.json`` (``{"model_type", "configuration",
"iteration_count", "epoch_count"}``) and ``coefficients.npz`` (one
array per ``"<layer>/<param>"``), so a zip written by either package
restores in the other. Updater state and layer state members are
neither read nor written yet (training and BatchNormalization come in
later slices). Writes are atomic and durable: temp file, fsync, rename,
directory fsync.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
from typing import Dict

import numpy as np
import torch

CONFIG_NAME = "configuration.json"
COEFFICIENTS_NAME = "coefficients.npz"
MODEL_TYPE = "MultiLayerNetwork"


def params_from_numpy(flat: Dict[str, np.ndarray], device
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"<layer>/<param>": array}`` (the npz layout, or a JAX model's
    parameters flattened the same way) -> ``{layer: {param: tensor}}``
    on ``device``. Layer names may hold '/', param names never do."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, arr in flat.items():
        ln, pn = key.rsplit("/", 1)
        out.setdefault(ln, {})[pn] = torch.from_numpy(
            np.array(arr, copy=True)).to(device)
    return out


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``: host copies keyed
    ``"<layer>/<param>"``."""
    return {f"{ln}/{pn}": t.detach().cpu().numpy()
            for ln, lp in params.items() for pn, t in lp.items()}


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_model(model, path) -> None:
    """Write ``model`` (a ``MultiLayerNetwork``) as a checkpoint zip."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if not isinstance(model, MultiLayerNetwork):
        raise ValueError(f"Cannot serialize {type(model).__name__}")
    if model.params is None:
        model.init()
    doc = {
        "model_type": MODEL_TYPE,
        "configuration": model.conf.to_dict(),
        "iteration_count": model.iteration_count,
        "epoch_count": model.epoch_count,
    }
    buf = io.BytesIO()
    np.savez(buf, **params_to_numpy(model.params))
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED) as zf:
                zf.writestr(CONFIG_NAME, json.dumps(doc, indent=2))
                zf.writestr(COEFFICIENTS_NAME, buf.getvalue())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def restore_multi_layer_network(path, device=None):
    """Reference ``ModelSerializer.restoreMultiLayerNetwork``: the
    network on ``device`` (default ``"cuda"``, raising without a card)."""
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(path, "r") as zf:
        doc = json.loads(zf.read(CONFIG_NAME))
        if doc.get("model_type") != MODEL_TYPE:
            raise ValueError(
                f"Checkpoint holds a {doc.get('model_type')}; the port "
                f"restores only a {MODEL_TYPE} so far"
            )
        with np.load(io.BytesIO(zf.read(COEFFICIENTS_NAME)),
                     allow_pickle=False) as npz:
            flat = {k: npz[k] for k in npz.files}
    model = MultiLayerNetwork(
        MultiLayerConfiguration.from_dict(doc["configuration"]),
        device=device,
    )
    model.init(params=params_from_numpy(flat, model.device))
    model.iteration_count = doc.get("iteration_count", 0)
    model.epoch_count = doc.get("epoch_count", 0)
    return model


restore_model = restore_multi_layer_network
