"""Checkpoint save/restore, and the bridge that carries the JAX
package's parameters into the port.

Counterpart of ``deeplearning4j_tpu/util/model_serializer.py``: the
checkpoint is the same zip, holding ``configuration.json``
(``{"model_type", "configuration", "iteration_count", "epoch_count"}``),
``coefficients.npz`` (one array per ``"<layer>/<param>"``) and
``updaterState.npz`` (one array per ``"<layer>/<param>/<i>"``, the i-th
moment of that parameter's updater) and, where a layer keeps state,
``layerState.npz`` (``"<layer>/<key>"``: BatchNormalization's running
``mean`` and ``var``), so a zip written by either package restores, and
resumes training, in the other. bf16 arrays cross as the JAX package
writes them: numpy has no bf16, so each lands in the npz as its raw
2-byte patterns, a ``|V2`` array (``to_numpy`` / ``from_numpy``); f16
and f32 are numpy's own. A ``ComputationGraph`` is written the
same way, keyed by vertex name, with ``"model_type":
"ComputationGraph"``. Writes are atomic and durable: temp file, fsync,
rename, directory fsync.
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
UPDATER_NAME = "updaterState.npz"
LAYER_STATE_NAME = "layerState.npz"
MODEL_TYPE = "MultiLayerNetwork"
GRAPH_MODEL_TYPE = "ComputationGraph"


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; a bf16 tensor as its raw 2-byte patterns
    (a ``|V2`` array), the form ``np.asarray`` gives the JAX package's
    bf16 arrays in a checkpoint."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(arr) -> torch.Tensor:
    """A CPU tensor of a host array: a 2-byte void array (a ``|V2`` npz
    entry, or an ``ml_dtypes`` bf16 array) is bf16 bit patterns, taken
    as they are; anything else is numpy's own dtype."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(
            np.array(arr.view(np.int16), copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_numpy(flat: Dict[str, np.ndarray], device
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"<layer>/<param>": array}`` (the npz layout, or a JAX model's
    parameters flattened the same way) -> ``{layer: {param: tensor}}``
    on ``device``. Layer names may hold '/', param names never do."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, arr in flat.items():
        ln, pn = key.rsplit("/", 1)
        out.setdefault(ln, {})[pn] = from_numpy(arr).to(device)
    return out


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``: host copies keyed
    ``"<layer>/<param>"``."""
    return {f"{ln}/{pn}": to_numpy(t)
            for ln, lp in params.items() for pn, t in lp.items()}


def updater_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Updater state ``{layer: {param: (tensor, ...)}}`` -> host copies
    keyed ``"<layer>/<param>/<i>"`` (the ``updaterState.npz`` layout)."""
    return {f"{ln}/{pn}/{i}": to_numpy(t)
            for ln, lp in state.items() for pn, tup in lp.items()
            for i, t in enumerate(tup)}


def updater_state_from_numpy(flat: Dict[str, np.ndarray], template
                             ) -> Dict[str, Dict[str, tuple]]:
    """``{"<layer>/<param>/<i>": array}`` -> updater state shaped like
    ``template`` (a network's ``updater_state``: it gives the layers,
    the number of moments of each parameter, their device and dtype).
    A moment the template expects and ``flat`` lacks raises KeyError."""
    return {ln: {pn: tuple(
        from_numpy(flat[f"{ln}/{pn}/{i}"]).to(device=t.device,
                                              dtype=t.dtype)
        for i, t in enumerate(tup)) for pn, tup in lp.items()}
        for ln, lp in template.items()}


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


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


def _model_type(model) -> str:
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if isinstance(model, MultiLayerNetwork):
        return MODEL_TYPE
    if isinstance(model, ComputationGraph):
        return GRAPH_MODEL_TYPE
    raise ValueError(f"Cannot serialize {type(model).__name__}")


def write_model(model, path) -> None:
    """Write ``model`` (a ``MultiLayerNetwork`` or a
    ``ComputationGraph``) as a checkpoint zip, its layer state and
    updater state included. A model whose updater state a ``zero=True``
    trainer sharded over several ranks is written in the canonical
    layout: every rank calls this (one all-gather), each writes the same
    zip."""
    from deeplearning4j_tpu_torch.nn import core

    model_type = _model_type(model)
    if model.params is None:
        model.init()
    doc = {
        "model_type": model_type,
        "configuration": model.conf.to_dict(),
        "iteration_count": model.iteration_count,
        "epoch_count": model.epoch_count,
    }
    members = {COEFFICIENTS_NAME: _npz_bytes(params_to_numpy(model.params))}
    state = {ln: st for ln, st in model.state.items() if st}
    if state:
        members[LAYER_STATE_NAME] = _npz_bytes(params_to_numpy(state))
    if model.updater_state is not None:
        upd = model.updater_state
        layout = getattr(model, "_zero_layout", None)
        if layout:
            # ZeRO-1 slices: gathered (a collective every rank joins) to
            # the parameter-shaped moments, so the zip is world-free
            upd = core.zero_gather_updater_state(upd, model.params,
                                                 layout["shards"])
        members[UPDATER_NAME] = _npz_bytes(updater_state_to_numpy(upd))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(CONFIG_NAME, json.dumps(doc, indent=2))
        for name, data in members.items():
            zf.writestr(name, data)
    atomic_write_bytes(path, buf.getvalue())


def atomic_write_bytes(path, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically and durably: temp file,
    fsync, rename, directory fsync."""
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
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


def _read_npz(zf: zipfile.ZipFile, name: str) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(zf.read(name)), allow_pickle=False) as npz:
        return {k: npz[k] for k in npz.files}


def _restore(path, device, expect):
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(path, "r") as zf:
        doc = json.loads(zf.read(CONFIG_NAME))
        model_type = doc.get("model_type")
        if model_type not in (MODEL_TYPE, GRAPH_MODEL_TYPE):
            raise ValueError(f"Checkpoint holds a {model_type}; the port "
                             f"restores a {MODEL_TYPE} or a "
                             f"{GRAPH_MODEL_TYPE}")
        if expect is not None and model_type != expect:
            raise ValueError(f"Checkpoint holds a {model_type}, not a "
                             f"{expect}")
        names = set(zf.namelist())
        flat = _read_npz(zf, COEFFICIENTS_NAME)
        state = (_read_npz(zf, LAYER_STATE_NAME)
                 if LAYER_STATE_NAME in names else {})
        upd = _read_npz(zf, UPDATER_NAME) if UPDATER_NAME in names else None
    if model_type == MODEL_TYPE:
        model = MultiLayerNetwork(
            MultiLayerConfiguration.from_dict(doc["configuration"]),
            device=device)
    else:
        model = ComputationGraph(
            ComputationGraphConfiguration.from_dict(doc["configuration"]),
            device=device)
    model.init(params=params_from_numpy(flat, model.device))
    for ln, st in params_from_numpy(state, model.device).items():
        model.state[ln] = st
    if upd is not None:
        model.updater_state = updater_state_from_numpy(
            upd, model.updater_state)
    model.iteration_count = doc.get("iteration_count", 0)
    model.epoch_count = doc.get("epoch_count", 0)
    return model


def restore_multi_layer_network(path, device=None):
    """Reference ``ModelSerializer.restoreMultiLayerNetwork``: the
    network on ``device`` (default ``"cuda"``, raising without a card),
    with its layer state and updater state where the zip holds them
    (else they start fresh)."""
    return _restore(path, device, MODEL_TYPE)


def restore_computation_graph(path, device=None):
    """Reference ``ModelSerializer.restoreComputationGraph``: as
    ``restore_multi_layer_network``, for a ``ComputationGraph``."""
    return _restore(path, device, GRAPH_MODEL_TYPE)


def restore_model(path, device=None):
    """Either kind of model, as the zip's ``model_type`` says."""
    return _restore(path, device, None)
