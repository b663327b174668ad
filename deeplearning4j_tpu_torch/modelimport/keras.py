"""Keras 1.x model import into the port.

Counterpart of ``deeplearning4j_tpu/modelimport/keras.py`` (reference
``deeplearning4j-modelimport``: ``keras/Model.java:58``
importSequentialModel / ``:78`` importFunctionalApiModel / ``:148``
config+weights variants; ``ModelConfiguration.java`` layer-dict
mapping). The same configuration mapping, merge passes, gate packing,
conv-kernel handling and exceptions; the imported network is the port's
``MultiLayerNetwork``, on the card unless ``device`` names the CPU.
``h5py`` is imported only by the functions that read ``.h5`` files, so
the package imports without it, and
``import_sequential_model_arrays`` takes a config and arrays directly.

Supported layers mirror the reference's ``buildLayer`` switch: Dense /
TimeDistributedDense, LSTM, Convolution2D, MaxPooling2D, Flatten
(skipped: the InputType machinery inserts the reshape), plus the merge
passes for Dropout (folded into the following layer) and Activation
(folded into the preceding layer). Embedding is additionally supported.
Divergences from the reference, on purpose, as in the JAX package:

- the final Dense becomes an OutputLayer with a loss inferred from its
  activation (softmax→MCXENT, sigmoid→XENT, else MSE) so the imported
  model is trainable; the reference leaves it a plain DenseLayer.
- Theano-ordered conv kernels are already [out, in, kh, kw] and are
  used as-is (the reference permutes them, ``Model.java:383``).

Like the JAX package, the rows of the first Dense after a ``tf``
Flatten are taken as they are, though Keras flattens H, W, C and the
port C, H, W (ROADMAP.md §3 records what the tests found).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration


class IncompatibleKerasConfigurationException(ValueError):
    """Reference ``IncompatibleKerasConfigurationException.java``."""


_ACTIVATION_MAP = {
    "linear": "identity",
    "relu": "relu",
    "sigmoid": "sigmoid",
    "hard_sigmoid": "hardsigmoid",
    "tanh": "tanh",
    "softmax": "softmax",
    "softplus": "softplus",
    "softsign": "softsign",
}

_INIT_MAP = {
    "uniform": "UNIFORM",
    "zero": "ZERO",
    "glorot_normal": "XAVIER",
    "glorot_uniform": "XAVIER_UNIFORM",
    "he_normal": "RELU",
    "he_uniform": "RELU_UNIFORM",
    "lecun_uniform": "UNIFORM",
    "normal": "NORMAL",
}


def _map_activation(name: Optional[str]) -> str:
    if name is None:
        return "identity"
    if name not in _ACTIVATION_MAP:
        raise IncompatibleKerasConfigurationException(
            f"unsupported Keras activation {name!r}"
        )
    return _ACTIVATION_MAP[name]


def _map_init(name: Optional[str]) -> str:
    # unknown inits fall back to XAVIER, like the reference
    # (LayerConfiguration.mapWeightInitialization)
    return _INIT_MAP.get(name or "", "XAVIER")


def _reg(cfg: dict, key: str) -> Tuple[float, float]:
    reg = cfg.get(key) or {}
    return float(reg.get("l1", 0.0) or 0.0), float(reg.get("l2", 0.0)
                                                  or 0.0)


def _infer_loss(activation: str) -> str:
    return {"softmax": "MCXENT", "sigmoid": "XENT"}.get(activation, "MSE")


# ---------------------------------------------------------------------------
# Config import
# ---------------------------------------------------------------------------


def _merge_passes(layer_dicts: List[dict]) -> List[dict]:
    """First pass of ``importSequentialModelConfig``: fold Dropout into
    the next layer, Activation into the previous layer, drop Flatten."""
    merged: List[dict] = []
    pending_dropout = 0.0
    # a dropped leading Dropout/Flatten may carry the model's input
    # shape — hoist it onto the next kept layer instead of losing it
    pending_input: dict = {}
    for entry in layer_dicts:
        cls = entry["class_name"]
        cfg = dict(entry.get("config", {}))
        cfg["keras_class"] = cls
        if cls in ("Dropout", "Flatten"):
            if not merged:
                for k in ("batch_input_shape", "input_shape",
                          "dim_ordering"):
                    if cfg.get(k) is not None and k not in pending_input:
                        pending_input[k] = cfg[k]
            if cls == "Dropout":
                pending_dropout = 1.0 - (1.0 - pending_dropout) * (
                    1.0 - float(cfg.get("p", 0.0))
                )
            # Flatten: our InputType shape inference inserts the
            # CNN→FF reshape
            continue
        if cls == "Activation":
            if not merged:
                raise IncompatibleKerasConfigurationException(
                    "Activation layer found with no preceding layer"
                )
            merged[-1]["activation"] = cfg.get("activation")
            continue
        if pending_dropout > 0:
            old = float(cfg.get("dropout", 0.0) or 0.0)
            cfg["dropout"] = 1.0 - (1.0 - pending_dropout) * (1.0 - old)
            pending_dropout = 0.0
        if not merged and pending_input:
            for k, v in pending_input.items():
                if cfg.get(k) is None:
                    cfg[k] = v
            pending_input = {}
        merged.append(cfg)
    return merged


def _build_layer(cfg: dict, is_output: bool):
    """``LayerConfiguration.buildLayer`` analog — returns a LayerSpec
    or None for structural layers."""
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer,
        DenseLayer,
        EmbeddingLayer,
        GravesLSTM,
        OutputLayer,
        SubsamplingLayer,
    )

    cls = cfg["keras_class"]
    name = cfg.get("name", "")
    act = _map_activation(cfg.get("activation"))
    init = _map_init(cfg.get("init"))
    l1, l2 = _reg(cfg, "W_regularizer")
    dropout = float(cfg.get("dropout", 0.0) or 0.0)

    if cls in ("Dense", "TimeDistributedDense"):
        if is_output:
            return OutputLayer(
                name=name, n_out=int(cfg["output_dim"]), activation=act,
                weight_init=init, dropout=dropout, l1=l1, l2=l2,
                loss=_infer_loss(act),
            )
        return DenseLayer(
            name=name, n_out=int(cfg["output_dim"]), activation=act,
            weight_init=init, dropout=dropout, l1=l1, l2=l2,
        )
    if cls == "LSTM":
        dropout_w = float(cfg.get("dropout_W", 0.0) or 0.0)
        return GravesLSTM(
            name=name, n_out=int(cfg["output_dim"]),
            activation=act if cfg.get("activation") else "tanh",
            gate_activation=_map_activation(
                cfg.get("inner_activation", "hard_sigmoid")
            ),
            forget_gate_bias_init=(
                1.0 if cfg.get("forget_bias_init", "one") == "one" else 0.0
            ),
            weight_init=init, dropout=dropout_w, l1=l1, l2=l2,
            peephole=False,  # Keras LSTMs have no peepholes
        )
    if cls == "Convolution2D":
        stride = cfg.get("subsample", [1, 1])
        border = cfg.get("border_mode", "valid")
        if border not in ("valid", "same"):
            raise IncompatibleKerasConfigurationException(
                f"unsupported border_mode {border!r}"
            )
        kh, kw = int(cfg["nb_row"]), int(cfg["nb_col"])
        padding = (kh // 2, kw // 2) if border == "same" else (0, 0)
        return ConvolutionLayer(
            name=name, n_out=int(cfg["nb_filter"]),
            kernel_size=(kh, kw),
            stride=(int(stride[0]), int(stride[1])), padding=padding,
            activation=act, weight_init=init, dropout=dropout,
            l1=l1, l2=l2,
        )
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        pool = cfg.get("pool_size", [2, 2])
        stride = cfg.get("strides") or pool
        return SubsamplingLayer(
            name=name,
            pooling_type="MAX" if cls == "MaxPooling2D" else "AVG",
            kernel_size=(int(pool[0]), int(pool[1])),
            stride=(int(stride[0]), int(stride[1])),
        )
    if cls == "Embedding":
        return EmbeddingLayer(
            name=name, n_in=int(cfg["input_dim"]),
            n_out=int(cfg["output_dim"]), weight_init=init,
        )
    raise IncompatibleKerasConfigurationException(
        f"Unsupported keras layer type {cls}"
    )


def import_sequential_model_config(config_json: str):
    """Keras Sequential to_json() → MultiLayerConfiguration (reference
    ``ModelConfiguration.importSequentialModelConfig``)."""
    keras = json.loads(config_json)
    if keras.get("class_name") != "Sequential":
        raise IncompatibleKerasConfigurationException(
            f'Expected "Sequential" model config, found '
            f'{keras.get("class_name")!r}'
        )
    layer_dicts = keras.get("config", [])
    merged = _merge_passes(layer_dicts)

    batch_input_shape = None
    dim_ordering = None
    is_recurrent = is_conv = False
    built = []
    for i, cfg in enumerate(merged):
        if "batch_input_shape" in cfg:
            if i > 0:
                raise IncompatibleKerasConfigurationException(
                    'Non-input layer should not specify '
                    '"batch_input_shape"'
                )
            batch_input_shape = cfg["batch_input_shape"]
        elif i == 0:
            raise IncompatibleKerasConfigurationException(
                'Input layer must specify "batch_input_shape"'
            )
        if "dim_ordering" in cfg:
            do = cfg["dim_ordering"]
            if do not in ("th", "tf"):
                raise IncompatibleKerasConfigurationException(
                    f"Unknown Keras backend {do!r}"
                )
            if dim_ordering is not None and do != dim_ordering:
                raise IncompatibleKerasConfigurationException(
                    "Found layers with conflicting Keras backends"
                )
            dim_ordering = do
        layer = _build_layer(cfg, is_output=(i == len(merged) - 1))
        if layer is None:
            continue
        from deeplearning4j_tpu_torch.nn.layers import (
            ConvolutionLayer as _Conv,
            GravesLSTM as _Lstm,
        )
        is_recurrent |= isinstance(layer, _Lstm)
        is_conv |= isinstance(layer, _Conv)
        built.append(layer)

    builder = NeuralNetConfiguration.Builder().list()
    for layer in built:
        builder.layer(layer)
    if is_recurrent and is_conv:
        raise IncompatibleKerasConfigurationException(
            "Recurrent convolutional architecture not supported"
        )
    if is_recurrent:
        builder.set_input_type(InputType.recurrent(
            int(batch_input_shape[2])
        ))
        if batch_input_shape[1] is not None:
            seq = int(batch_input_shape[1])
            builder.t_bptt_forward_length(seq)
            builder.t_bptt_backward_length(seq)
    elif is_conv:
        if dim_ordering == "tf":
            h, w, c = batch_input_shape[1:4]
        else:
            c, h, w = batch_input_shape[1:4]
        builder.set_input_type(
            InputType.convolutional(int(h), int(w), int(c))
        )
    else:
        builder.set_input_type(InputType.feed_forward(
            int(batch_input_shape[-1])
        ))
    return builder.build()


def import_functional_api_config(config_json: str):
    """Functional-API config import — not implemented at this version,
    matching the reference (``Model.java:229``
    ``UnsupportedOperationException``)."""
    raise NotImplementedError(
        "Keras Functional API models are not supported (the reference "
        "throws UnsupportedOperationException at this version)"
    )


# ---------------------------------------------------------------------------
# Weight import
# ---------------------------------------------------------------------------


def _read_weights_h5(group) -> Dict[str, Dict[str, np.ndarray]]:
    """Walk the HDF5 group tree collecting datasets into
    {layer: {param: array}} (reference ``readWeightsFromHdf5``).
    Handles both naming styles: '<layer>_<param>' dataset names and
    'param_N' datasets nested under a layer group."""
    import h5py

    weights: Dict[str, Dict[str, np.ndarray]] = {}

    def visit(name, obj):
        if not isinstance(obj, h5py.Dataset):
            return
        arr = np.asarray(obj[()], np.float32)
        parts = name.split("/")
        dsname = parts[-1]
        # strip TensorFlow's ":0" suffix
        if ":" in dsname:
            dsname = dsname.split(":")[0]
        parent = parts[-2] if len(parts) > 1 else ""
        if dsname.startswith("param_"):
            layer, param = parent or dsname, dsname
        elif parent and dsname.startswith(parent + "_"):
            # Keras layout: group per layer, datasets named
            # "<layer>_<param>" — covers multi-token params like the
            # LSTM's "lstm_1_W_i"
            layer, param = parent, dsname[len(parent) + 1:]
        else:
            # flat layout: "dense_1_W" → layer "dense_1", param "W"
            toks = dsname.split("_")
            layer = "_".join(toks[:-1]) if len(toks) > 1 else (
                parent or dsname
            )
            param = toks[-1]
        weights.setdefault(layer, {})[param] = arr

    group.visititems(visit)
    return weights


def _lstm_pack(w: Dict[str, np.ndarray]):
    """Keras 1.x per-gate LSTM arrays (W_i/U_i/b_i, W_c.., W_f.., W_o..)
    → our fused [in,4n]/[n,4n]/[4n] in i,f,o,g gate order (g = Keras
    'c' cell candidate)."""
    order = ("i", "f", "o", "c")
    W = np.concatenate([w[f"W_{g}"] for g in order], axis=1)
    RW = np.concatenate([w[f"U_{g}"] for g in order], axis=1)
    b = np.concatenate([w[f"b_{g}"] for g in order])
    return W, RW, b


def _set_model_weights(net, weights: Dict[str, Dict[str, np.ndarray]],
                       backend: str) -> None:
    """Put Keras-layout arrays into an initialized ``net``: LSTM gates
    packed, ``tf`` conv kernels permuted to OIHW, every other array as
    it is; a layer, parameter or shape the net lacks raises."""
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer,
        GravesLSTM,
    )

    for lname, params in weights.items():
        if lname not in net.params:
            raise IncompatibleKerasConfigurationException(
                f"weights for unknown layer {lname!r}; model layers: "
                f"{list(net.params)}"
            )
        idx = net.layer_names.index(lname)
        layer = net.conf.layers[idx]
        new = dict(net.params[lname])
        gate_keys = {f"{m}_{g}" for m in ("W", "U", "b")
                     for g in ("i", "f", "c", "o")}
        if isinstance(layer, GravesLSTM) and gate_keys <= set(params):
            W, RW, b = _lstm_pack(params)
            for pname, arr in (("W", W), ("RW", RW), ("b", b)):
                new[pname] = net._to_device(arr, new[pname].dtype)
            net.params[lname] = new
            continue
        for pname, arr in params.items():
            if isinstance(layer, ConvolutionLayer) and pname == "W":
                if backend == "tf":
                    # [kh, kw, in, out] → [out, in, kh, kw]
                    arr = np.transpose(arr, (3, 2, 0, 1))
                # th already stores [out, in, kh, kw]
            if pname not in new:
                raise IncompatibleKerasConfigurationException(
                    f"unknown param {pname!r} for layer {lname!r} "
                    f"(has {list(new)})"
                )
            if tuple(new[pname].shape) != tuple(arr.shape):
                raise IncompatibleKerasConfigurationException(
                    f"shape mismatch for {lname}.{pname}: model "
                    f"{tuple(new[pname].shape)} vs weights {arr.shape}"
                )
            new[pname] = net._to_device(np.ascontiguousarray(arr),
                                        new[pname].dtype)
        net.params[lname] = new


def _extract_backend(config_json: str) -> str:
    keras = json.loads(config_json)
    backend = keras.get("keras_backend")
    if backend:
        return backend
    for entry in keras.get("config", []):
        do = entry.get("config", {}).get("dim_ordering")
        if do:
            return do
    return "th"


def import_sequential_model(model_or_config_path: str,
                            weights_path: Optional[str] = None,
                            device=None):
    """Import a Keras Sequential model into a MultiLayerNetwork on
    ``device`` (default the card; reference
    ``Model.importSequentialModel``): one argument reads a combined
    save_model() HDF5 with a 'model_config' attribute and
    '/model_weights'; two take to_json()'s config and save_weights()'s
    HDF5."""
    import h5py

    if weights_path is None:
        with h5py.File(model_or_config_path, "r") as f:
            raw = f.attrs.get("model_config")
            if raw is None:
                raise IncompatibleKerasConfigurationException(
                    f"{model_or_config_path!r} has no 'model_config' "
                    "attribute; for a weights-only file pass the config "
                    "JSON path as the first argument"
                )
            config_json = (
                raw.decode() if isinstance(raw, bytes) else str(raw)
            )
            group = (
                f["model_weights"] if "model_weights" in f else f["/"]
            )
            weights = _read_weights_h5(group)
    else:
        with open(model_or_config_path, "r", encoding="utf-8") as fh:
            config_json = fh.read()
        with h5py.File(weights_path, "r") as f:
            weights = _read_weights_h5(f["/"])
    return import_sequential_model_arrays(config_json, weights, device)


def import_sequential_model_arrays(config_json: str,
                                   weights: Dict[str, Dict[str, np.ndarray]],
                                   device=None):
    """A Keras Sequential config (to_json()'s text) and its weights as
    ``{layer: {param: array}}`` in Keras's own layout (what
    ``_read_weights_h5`` reads from a file: Dense ``W`` [in, out], conv
    ``W`` [out, in, kh, kw] under ``th`` or [kh, kw, in, out] under
    ``tf``, LSTM per-gate ``W_i`` / ``U_i`` / ``b_i``...) as a
    MultiLayerNetwork on ``device`` (default the card). Needs no
    ``h5py``."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = import_sequential_model_config(config_json)
    net = MultiLayerNetwork(conf, device=device).init()
    _set_model_weights(net, weights, _extract_backend(config_json))
    return net


def import_functional_api_model(model_path: str,
                                weights_path: Optional[str] = None,
                                device=None):
    """Reference ``Model.importFunctionalApiModel`` — throws at this
    version (``Model.java:229``)."""
    raise NotImplementedError(
        "Keras Functional API models are not supported (matches the "
        "reference, which throws UnsupportedOperationException)"
    )
