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

A save is split in two, as the JAX package's is, so a write-behind
checkpoint runs its costly half off the training thread:
``snapshot_model`` takes buffer-isolated host copies (on the card,
optionally non-blocking into pinned staging on the compute stream, an
event recorded after them) and ``write_snapshot`` serializes a snapshot
from any thread. ``snapshot_flat_arrays`` / ``model_from_flat`` give
the same state as one flat ``{section/layer/param: array}`` map, the
unit of the sharded ``<prefix>-<step>/shard-<rank>.npz`` layout.
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


# --- the snapshot: the training thread's half of a save --------------------


def _map_leaves(fn, tree):
    """``fn`` over the tensors of ``{a: {b: tensor or tuple}}``."""
    return {ln: {k: (tuple(fn(t) for t in v) if isinstance(v, tuple)
                     else fn(v)) for k, v in lp.items()}
            for ln, lp in tree.items()}


def host_snapshot_tree(tree, pinned=None):
    """A buffer-isolated host copy of ``{a: {b: tensor or tuple}}``
    (JAX ``core.host_snapshot_tree``): every leaf a CPU tensor sharing
    no storage with the live tree, so a background thread may serialize
    it while the model trains on. Without ``pinned`` the copies are
    synchronous. With ``pinned`` (a tree of pinned host tensors of the
    same structure, ``pinned_like``) each device leaf is copied into
    its pinned buffer non-blocking on the current stream: the steps
    enqueued after it write the parameters only once the copy has read
    them (stream order), and the caller records an event after the
    copies that the reader waits on."""
    if pinned is None:
        return _map_leaves(lambda t: t.detach().to("cpu", copy=True), tree)
    out = {}
    for ln, lp in tree.items():
        out[ln] = {}
        for k, v in lp.items():
            dst = pinned[ln][k]
            if isinstance(v, tuple):
                for d, t in zip(dst, v):
                    d.copy_(t.detach(), non_blocking=True)
            else:
                dst.copy_(v.detach(), non_blocking=True)
            out[ln][k] = dst
    return out


def pinned_like(tree):
    """Pinned host tensors shaped like the leaves of ``tree`` (a
    write-behind save's staging)."""
    return _map_leaves(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                             pin_memory=True), tree)


def tree_signature(tree) -> tuple:
    """The structure, shapes and dtypes of ``{a: {b: tensor or
    tuple}}`` (whether a pinned staging set fits)."""
    return tuple((ln, k, tuple((tuple(t.shape), t.dtype) for t in (
        v if isinstance(v, tuple) else (v,))))
        for ln, lp in tree.items() for k, v in lp.items())


def snapshot_trees(model, save_updater: bool = True) -> dict:
    """The device trees a checkpoint holds: the parameters, the layer
    state of the layers that keep some, and the canonical updater state
    (None without one, or with ``save_updater=False``). A ZeRO-1 model's
    moment slices and a row-sharded table's rows are gathered first
    (``core.canonical_trees``: collectives every rank joins), so the
    file is the one a replicated run writes."""
    from deeplearning4j_tpu_torch.nn import core

    if model.params is None:
        model.init()
    params, upd = core.canonical_trees(model)
    return {"params": params,
            "state": {ln: st for ln, st in model.state.items() if st},
            "updater": upd if save_updater else None}


def snapshot_model(model, save_updater: bool = True, pinned=None) -> dict:
    """Everything ``write_model`` persists as host copies (JAX
    ``snapshot_model``): the configuration document, the parameters,
    the layer state and the canonical updater state. The only part of
    a save that runs on the training thread. ``pinned``: a pinned
    staging set for ``snapshot_trees(model)`` (``pinned_like``); the
    copies then run non-blocking on the current stream and ``ready``
    holds the event recorded after them (``write_snapshot`` waits on
    it), else the copies are synchronous and ``ready`` is None."""
    trees = snapshot_trees(model, save_updater)
    ready = None
    if pinned is not None:
        host = {k: (None if v is None else
                    host_snapshot_tree(v, pinned[k]))
                for k, v in trees.items()}
        ready = torch.cuda.Event()
        ready.record()
    else:
        host = {k: (None if v is None else host_snapshot_tree(v))
                for k, v in trees.items()}
    return {
        "model_type": _model_type(model),
        "configuration": model.conf.to_dict(),
        "iteration_count": int(model.iteration_count),
        "epoch_count": int(model.epoch_count),
        "params": host["params"], "state": host["state"],
        "updater": host["updater"], "ready": ready,
    }


def snapshot_conf_doc(snap: dict) -> dict:
    """The ``configuration.json`` document of a snapshot (also what a
    sharded checkpoint's ``manifest.json`` embeds)."""
    return {"model_type": snap["model_type"],
            "configuration": snap["configuration"],
            "iteration_count": snap["iteration_count"],
            "epoch_count": snap["epoch_count"]}


def _snapshot_ready(snap: dict) -> None:
    """Wait for a snapshot's non-blocking copies (none to wait for
    after a synchronous snapshot)."""
    ready = snap.get("ready")
    if ready is not None:
        ready.synchronize()


def snapshot_flat_arrays(snap: dict) -> Dict[str, np.ndarray]:
    """A snapshot as one flat ``{section/layer/param: array}`` map
    (sections ``coefficients``, ``layerState``, ``updaterState``): the
    unit a sharded checkpoint deals out over its ranks."""
    _snapshot_ready(snap)
    flat: Dict[str, np.ndarray] = {}
    for k, v in params_to_numpy(snap["params"]).items():
        flat[f"coefficients/{k}"] = v
    for k, v in params_to_numpy(snap["state"]).items():
        flat[f"layerState/{k}"] = v
    if snap["updater"] is not None:
        for k, v in updater_state_to_numpy(snap["updater"]).items():
            flat[f"updaterState/{k}"] = v
    return flat


def write_snapshot(snap: dict, path) -> None:
    """A snapshot as a checkpoint zip: host work only, safe on any
    thread (it first waits for the snapshot's copies). A path gets the
    atomic, durable write; a file-like object is written as it is."""
    _snapshot_ready(snap)
    members = {COEFFICIENTS_NAME: _npz_bytes(params_to_numpy(snap["params"]))}
    if snap["state"]:
        members[LAYER_STATE_NAME] = _npz_bytes(params_to_numpy(snap["state"]))
    if snap["updater"] is not None:
        members[UPDATER_NAME] = _npz_bytes(
            updater_state_to_numpy(snap["updater"]))

    def write_to(dest) -> None:
        with zipfile.ZipFile(dest, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(CONFIG_NAME,
                        json.dumps(snapshot_conf_doc(snap), indent=2))
            for name, data in members.items():
                zf.writestr(name, data)

    if hasattr(path, "write"):
        write_to(path)
        return
    buf = io.BytesIO()
    write_to(buf)
    atomic_write_bytes(path, buf.getvalue())


def write_model(model, path, save_updater: bool = True) -> None:
    """Write ``model`` (a ``MultiLayerNetwork`` or a
    ``ComputationGraph``) as a checkpoint zip, its layer state and
    updater state included. A model whose updater state a ``zero=True``
    trainer sharded over several ranks is written in the canonical
    layout: every rank calls this (one all-gather), each writes the same
    zip."""
    write_snapshot(snapshot_model(model, save_updater=save_updater), path)


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


def _build_model(doc: dict, expect, device):
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    model_type = doc.get("model_type")
    if model_type not in (MODEL_TYPE, GRAPH_MODEL_TYPE):
        raise ValueError(f"Checkpoint holds a {model_type}; the port "
                         f"restores a {MODEL_TYPE} or a "
                         f"{GRAPH_MODEL_TYPE}")
    if expect is not None and model_type != expect:
        raise ValueError(f"Checkpoint holds a {model_type}, not a "
                         f"{expect}")
    if model_type == MODEL_TYPE:
        return MultiLayerNetwork(
            MultiLayerConfiguration.from_dict(doc["configuration"]),
            device=device)
    return ComputationGraph(
        ComputationGraphConfiguration.from_dict(doc["configuration"]),
        device=device)


def _assemble(doc, flat, state, upd, device, expect=None):
    """A model of ``doc`` on ``device`` from its parameter, layer-state
    and (or None) updater-state arrays."""
    model = _build_model(doc, expect, device)
    model.init(params=params_from_numpy(flat, model.device))
    for ln, st in params_from_numpy(state, model.device).items():
        model.state[ln] = st
    if upd:
        model.updater_state = updater_state_from_numpy(
            upd, model.updater_state)
    model.iteration_count = int(doc.get("iteration_count", 0))
    model.epoch_count = int(doc.get("epoch_count", 0))
    return model


def model_from_flat(conf_doc: dict, flat, load_updater: bool = True,
                    device=None):
    """A model from a configuration document and the merged flat map of
    ``snapshot_flat_arrays`` (the restore half of a sharded checkpoint,
    whatever number of shards the map was gathered from)."""
    sections = {"coefficients": {}, "layerState": {}, "updaterState": {}}
    for key, arr in flat.items():
        section, rest = key.split("/", 1)
        if section not in sections:
            raise ValueError(f"Unknown checkpoint shard section: {key}")
        sections[section][rest] = arr
    return _assemble(conf_doc, sections["coefficients"],
                     sections["layerState"],
                     sections["updaterState"] if load_updater else None,
                     device)


def _restore(path, device, expect, load_updater: bool = True):
    with zipfile.ZipFile(path, "r") as zf:
        doc = json.loads(zf.read(CONFIG_NAME))
        names = set(zf.namelist())
        flat = _read_npz(zf, COEFFICIENTS_NAME)
        state = (_read_npz(zf, LAYER_STATE_NAME)
                 if LAYER_STATE_NAME in names else {})
        upd = (_read_npz(zf, UPDATER_NAME)
               if load_updater and UPDATER_NAME in names else None)
    return _assemble(doc, flat, state, upd, device, expect)


def restore_multi_layer_network(path, device=None,
                                load_updater: bool = True):
    """Reference ``ModelSerializer.restoreMultiLayerNetwork``: the
    network on ``device`` (default ``"cuda"``, raising without a card),
    with its layer state and updater state where the zip holds them
    (else they start fresh)."""
    return _restore(path, device, MODEL_TYPE, load_updater)


def restore_computation_graph(path, device=None,
                              load_updater: bool = True):
    """Reference ``ModelSerializer.restoreComputationGraph``: as
    ``restore_multi_layer_network``, for a ``ComputationGraph``."""
    return _restore(path, device, GRAPH_MODEL_TYPE, load_updater)


def restore_model(path, device=None, load_updater: bool = True):
    """Either kind of model, as the zip's ``model_type`` says."""
    return _restore(path, device, None, load_updater)


def restore_model_from_bytes(data: bytes, device=None,
                             load_updater: bool = True):
    """A model from an in-memory checkpoint zip (an object store's
    ``read``), without a temporary file."""
    return _restore(io.BytesIO(data), device, None, load_updater)
