"""The port's Keras import (``deeplearning4j_tpu_torch/modelimport``)
against the JAX package's, on JAX ``tests/test_modelimport.py``'s h5
fixtures (Keras 1.x files written with h5py): the same configuration,
the same weights, the same outputs at kernel_tols; the MLP in both
file layouts, the CNN in ``th`` and ``tf``, the LSTM's gate packing,
the shape mismatch and the functional API's refusal; and the same
import from a config and arrays, without h5py."""

import json

import h5py
import numpy as np
import pytest

from conftest import kernel_tols
from deeplearning4j_tpu import modelimport as jax_import
from deeplearning4j_tpu_torch import modelimport as torch_import
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    GravesLSTM,
    OutputLayer,
    SubsamplingLayer,
)


def _mlp_config_json():
    return json.dumps({
        "class_name": "Sequential",
        "config": [
            {"class_name": "Dense", "config": {
                "name": "dense_1", "output_dim": 8,
                "activation": "relu", "init": "glorot_uniform",
                "batch_input_shape": [None, 4],
            }},
            {"class_name": "Dropout", "config": {"p": 0.5}},
            {"class_name": "Dense", "config": {
                "name": "dense_2", "output_dim": 3,
                "activation": "linear",
            }},
            {"class_name": "Activation", "config": {
                "activation": "softmax",
            }},
        ],
    })


def _write_mlp_h5(path, rng):
    """Keras 1.x save_model layout: model_config attr +
    model_weights/<layer>/<layer>_<param> datasets."""
    W1 = rng.randn(4, 8).astype(np.float32)
    b1 = rng.randn(8).astype(np.float32)
    W2 = rng.randn(8, 3).astype(np.float32)
    b2 = rng.randn(3).astype(np.float32)
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = np.bytes_(_mlp_config_json())
        g = f.create_group("model_weights")
        g1 = g.create_group("dense_1")
        g1.create_dataset("dense_1_W", data=W1)
        g1.create_dataset("dense_1_b", data=b1)
        g2 = g.create_group("dense_2")
        g2.create_dataset("dense_2_W", data=W2)
        g2.create_dataset("dense_2_b", data=b2)
    return W1, b1, W2, b2


def _both(*args):
    return (jax_import.import_sequential_model(*args),
            torch_import.import_sequential_model(*args, device="cpu"))


def _same_params(jnet, tnet):
    assert list(jnet.params) == list(tnet.params)
    for ln, lp in jnet.params.items():
        assert set(lp) == set(tnet.params[ln])
        for pn, a in lp.items():
            np.testing.assert_array_equal(np.asarray(a),
                                          tnet.params[ln][pn].numpy())


def _same_output(jnet, tnet, x):
    import jax

    rtol, atol = kernel_tols()
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jnet.output(x))
    np.testing.assert_allclose(tnet.output(x).numpy(), want, rtol=rtol,
                               atol=atol)
    return want


def test_mlp_config_matches_the_jax_import():
    j = jax_import.import_sequential_model_config(_mlp_config_json())
    t = torch_import.import_sequential_model_config(_mlp_config_json())
    assert [type(x).__name__ for x in t.layers] == \
        [type(x).__name__ for x in j.layers]
    assert isinstance(t.layers[0], DenseLayer)
    assert isinstance(t.layers[1], OutputLayer)
    assert t.layers[0].n_in == 4 and t.layers[0].n_out == 8
    assert t.layers[1].dropout == pytest.approx(0.5)
    assert t.layers[1].activation == "softmax"
    assert t.layers[1].loss == j.layers[1].loss == "MCXENT"
    assert t.to_json() == j.to_json()


def test_mlp_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "model.h5")
    W1, b1, W2, b2 = _write_mlp_h5(path, rng)
    jnet, tnet = _both(path)
    _same_params(jnet, tnet)
    x = rng.rand(5, 4).astype(np.float32)
    got = _same_output(jnet, tnet, x)
    h = np.maximum(x @ W1 + b1, 0.0)
    logits = h @ W2 + b2
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    np.testing.assert_allclose(got, e / e.sum(axis=1, keepdims=True),
                               rtol=1e-4, atol=1e-5)


def test_config_plus_weights_files(tmp_path):
    rng = np.random.RandomState(1)
    cfg_path = tmp_path / "model.json"
    cfg_path.write_text(_mlp_config_json())
    wpath = str(tmp_path / "weights.h5")
    with h5py.File(wpath, "w") as f:
        for name, shape in (("dense_1", ((4, 8), (8,))),
                            ("dense_2", ((8, 3), (3,)))):
            g = f.create_group(name)
            g.create_dataset(f"{name}_W",
                             data=rng.randn(*shape[0]).astype(np.float32))
            g.create_dataset(f"{name}_b",
                             data=rng.randn(*shape[1]).astype(np.float32))
    jnet, tnet = _both(str(cfg_path), wpath)
    _same_params(jnet, tnet)
    _same_output(jnet, tnet, rng.rand(3, 4).astype(np.float32))


def _lstm_fixture(tmp_path, rng, n_in=5, n_out=7):
    cfg = json.dumps({
        "class_name": "Sequential",
        "config": [
            {"class_name": "LSTM", "config": {
                "name": "lstm_1", "output_dim": n_out,
                "batch_input_shape": [None, 9, n_in],
                "activation": "tanh", "inner_activation": "sigmoid",
            }},
            {"class_name": "Dense", "config": {
                "name": "out", "output_dim": 2, "activation": "softmax",
            }},
        ],
    })
    gates = {}
    wpath = str(tmp_path / "w.h5")
    with h5py.File(wpath, "w") as f:
        g = f.create_group("lstm_1")
        for gate in ("i", "f", "c", "o"):
            gates[f"W_{gate}"] = rng.randn(n_in, n_out).astype(np.float32)
            gates[f"U_{gate}"] = rng.randn(n_out, n_out).astype(np.float32)
            gates[f"b_{gate}"] = rng.randn(n_out).astype(np.float32)
            for m in ("W", "U", "b"):
                g.create_dataset(f"lstm_1_{m}_{gate}",
                                 data=gates[f"{m}_{gate}"])
        go = f.create_group("out")
        go.create_dataset("out_W", data=rng.randn(n_out, 2)
                          .astype(np.float32))
        go.create_dataset("out_b", data=np.zeros(2, np.float32))
    cfg_path = tmp_path / "m.json"
    cfg_path.write_text(cfg)
    return str(cfg_path), wpath, gates


def test_lstm_gate_packing(tmp_path):
    rng = np.random.RandomState(2)
    n_out = 7
    cfg_path, wpath, gates = _lstm_fixture(tmp_path, rng, n_out=n_out)
    jnet, tnet = _both(cfg_path, wpath)
    assert isinstance(tnet.conf.layers[0], GravesLSTM)
    assert not tnet.conf.layers[0].peephole
    assert tnet.conf.tbptt_fwd_length == jnet.conf.tbptt_fwd_length == 9
    _same_params(jnet, tnet)
    packed = tnet.params["lstm_1"]["W"].numpy()
    for i, gate in enumerate(("i", "f", "o", "c")):  # i, f, o, g(=c)
        np.testing.assert_array_equal(
            packed[:, i * n_out:(i + 1) * n_out], gates[f"W_{gate}"])
    out = _same_output(jnet, tnet, rng.rand(3, 5, 9).astype(np.float32))
    assert out.shape == (3 * 9, 2)  # rnn -> ff folds time into batch


def _cnn_fixture(tmp_path, rng, order):
    shape = [None, 8, 8, 1] if order == "tf" else [None, 1, 8, 8]
    cfg = json.dumps({
        "class_name": "Sequential",
        "config": [
            {"class_name": "Convolution2D", "config": {
                "name": "conv1", "nb_filter": 2, "nb_row": 3, "nb_col": 3,
                "subsample": [1, 1], "dim_ordering": order,
                "activation": "relu", "batch_input_shape": shape,
            }},
            {"class_name": "MaxPooling2D", "config": {
                "name": "pool1", "pool_size": [2, 2], "strides": [2, 2],
                "dim_ordering": order}},
            {"class_name": "Flatten", "config": {}},
            {"class_name": "Dense", "config": {
                "name": "out", "output_dim": 2, "activation": "softmax",
            }},
        ],
    })
    w = rng.randn(*((3, 3, 1, 2) if order == "tf" else (2, 1, 3, 3))
                  ).astype(np.float32)
    b = rng.randn(2).astype(np.float32)
    w_out = rng.randn(18, 2).astype(np.float32)
    wpath = str(tmp_path / f"w_{order}.h5")
    with h5py.File(wpath, "w") as f:
        g = f.create_group("conv1")
        g.create_dataset("conv1_W", data=w)
        g.create_dataset("conv1_b", data=b)
        go = f.create_group("out")
        go.create_dataset("out_W", data=w_out)
        go.create_dataset("out_b", data=np.zeros(2, np.float32))
    cfg_path = tmp_path / f"m_{order}.json"
    cfg_path.write_text(cfg)
    return str(cfg_path), wpath, w, b, w_out


def _keras_cnn_forward(x_nchw, w_oihw, b, w_out, order):
    """Keras 1.x's own forward of the fixture: a valid 3 x 3 conv, relu,
    2 x 2 max pool, Flatten in the backend's layout (th: C, H, W; tf:
    H, W, C), softmax."""
    n = x_nchw.shape[0]
    o = w_oihw.shape[0]
    y = np.zeros((n, o, 6, 6), np.float64)
    for i in range(3):
        for j in range(3):
            y += np.einsum("nchw,oc->nohw", x_nchw[:, :, i:i + 6, j:j + 6],
                           w_oihw[:, :, i, j])
    y = np.maximum(y + b[None, :, None, None], 0.0)
    p = y.reshape(n, o, 3, 2, 3, 2).max(axis=(3, 5))
    flat = (p.reshape(n, -1) if order == "th"
            else p.transpose(0, 2, 3, 1).reshape(n, -1))
    z = flat @ w_out
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("order", ["th", "tf"])
def test_cnn_import_in_both_orderings(tmp_path, order):
    rng = np.random.RandomState(3)
    cfg_path, wpath, w, b, w_out = _cnn_fixture(tmp_path, rng, order)
    jnet, tnet = _both(cfg_path, wpath)
    assert isinstance(tnet.conf.layers[0], ConvolutionLayer)
    assert isinstance(tnet.conf.layers[1], SubsamplingLayer)
    _same_params(jnet, tnet)
    w_oihw = np.transpose(w, (3, 2, 0, 1)) if order == "tf" else w
    np.testing.assert_array_equal(tnet.params["conv1"]["W"].numpy(), w_oihw)
    x = rng.rand(4, 1, 8, 8).astype(np.float32)  # the nets take NCHW
    got = _same_output(jnet, tnet, x)
    keras = _keras_cnn_forward(x.astype(np.float64), w_oihw, b, w_out, order)
    if order == "th":  # exact: Keras and the port both flatten C, H, W
        np.testing.assert_allclose(got, keras, rtol=1e-4, atol=1e-6)
    else:
        # the reference's fault, followed by the port (ROADMAP.md §3):
        # the Dense rows after a tf Flatten are taken as they are, though
        # Keras flattened H, W, C; with two channels the orders differ
        assert not np.allclose(got, keras, rtol=1e-3, atol=1e-4)


def test_shape_mismatch_raises(tmp_path):
    cfg_path = tmp_path / "m.json"
    cfg_path.write_text(_mlp_config_json())
    wpath = str(tmp_path / "w.h5")
    with h5py.File(wpath, "w") as f:
        g = f.create_group("dense_1")
        g.create_dataset("dense_1_W", data=np.zeros((4, 9), np.float32))
    for mod in (jax_import, torch_import):
        kw = {} if mod is jax_import else {"device": "cpu"}
        with pytest.raises(mod.IncompatibleKerasConfigurationException,
                           match="shape mismatch"):
            mod.import_sequential_model(str(cfg_path), wpath, **kw)


@pytest.mark.parametrize("bad,match", [
    ({"class_name": "Model", "config": {}}, "Sequential"),
    ({"class_name": "Sequential", "config": [{"class_name": "Dense",
                                             "config": {"output_dim": 2}}]},
     "batch_input_shape"),
    ({"class_name": "Sequential", "config": [
        {"class_name": "Activation", "config": {"activation": "relu"}}]},
     "no preceding layer"),
    ({"class_name": "Sequential", "config": [
        {"class_name": "Dense", "config": {
            "output_dim": 2, "activation": "elu",
            "batch_input_shape": [None, 3]}}]}, "activation"),
    ({"class_name": "Sequential", "config": [
        {"class_name": "GRU", "config": {
            "output_dim": 2, "batch_input_shape": [None, 3, 4]}}]},
     "Unsupported keras layer"),
])
def test_the_same_refusals(bad, match):
    for mod in (jax_import, torch_import):
        with pytest.raises(mod.IncompatibleKerasConfigurationException,
                           match=match):
            mod.import_sequential_model_config(json.dumps(bad))


def test_functional_api_is_refused():
    with pytest.raises(NotImplementedError):
        torch_import.import_functional_api_config("{}")
    with pytest.raises(NotImplementedError):
        torch_import.import_functional_api_model("whatever.h5")


def test_arrays_import_is_the_h5_import(tmp_path):
    """``import_sequential_model_arrays`` (a config and a weights dict,
    no h5py) gives the h5 import's network."""
    rng = np.random.RandomState(4)
    path = str(tmp_path / "model.h5")
    W1, b1, W2, b2 = _write_mlp_h5(path, rng)
    from_h5 = torch_import.import_sequential_model(path, device="cpu")
    from_arrays = torch_import.import_sequential_model_arrays(
        _mlp_config_json(), {"dense_1": {"W": W1, "b": b1},
                             "dense_2": {"W": W2, "b": b2}}, device="cpu")
    x = rng.rand(3, 4).astype(np.float32)
    np.testing.assert_array_equal(from_h5.output(x).numpy(),
                                  from_arrays.output(x).numpy())


def test_import_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_import.import_sequential_model_arrays(_mlp_config_json(), {})
