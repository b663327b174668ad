"""bf16 checkpoints across the port and the JAX package, on the CPU.

numpy has no bf16, so the JAX package writes each bf16 leaf through
``np.asarray`` as its raw 2-byte patterns: a ``|V2`` array in the npz (a
bf16 1.0 reads back as the bits 0x3F80). The port writes and reads the
same bytes (``model_serializer.to_numpy`` / ``from_numpy``) for the
coefficients, the updater state and the layer state of both engines.

- A JAX bf16 LeNet and a JAX bf16 ComputationGraph (a tiny ResNet, whose
  BatchNormalization keeps a layer state) restore into the port with
  bitwise-equal parameters, updater and layer state; the restored
  port's output is bitwise the output of a port model given the JAX
  weights in memory, and within bf16 rounding of JAX's own.
- The port's bf16 checkpoints carry the bytes the JAX package writes for
  the same trees, and load into the JAX package bitwise. (The JAX
  package's own ``restore_model`` cannot read a ``|V2`` entry back, its
  own bf16 zips included; the JAX side here views the bytes as
  ``jnp.bfloat16`` itself.)

Tolerance against JAX's output: bf16 outputs of f32 sums in other
orders, so one bf16 rounding: rtol 2e-2, atol 8e-3 (``kernel_tols``'
bf16 branch).
"""

import io
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu.zoo import lenet as jlenet
from deeplearning4j_tpu.zoo import resnet50 as jresnet50
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import (
    from_numpy,
    params_from_numpy,
    restore_model,
    to_numpy,
    write_model,
)

RTOL, ATOL = 2e-2, 8e-3
TINY_RESNET = dict(height=8, width=8, channels=1, n_classes=3,
                   cifar_stem=True, depths=(1, 1), base_width=4,
                   dtype="bfloat16")


def _bits(a):
    """int16 bit patterns of a bf16 leaf: a torch tensor, a JAX array or
    a ``|V2`` / ml_dtypes numpy array."""
    if torch.is_tensor(a):
        assert a.dtype == torch.bfloat16, a.dtype
        return a.detach().cpu().view(torch.int16).numpy()
    arr = np.asarray(a)
    assert arr.dtype.itemsize == 2 and arr.dtype.kind == "V", arr.dtype
    return arr.view(np.int16)


def _npz(path, name):
    with zipfile.ZipFile(path) as zf:
        if name not in zf.namelist():
            return {}
        with np.load(io.BytesIO(zf.read(name))) as d:
            return {k: d[k] for k in d.files}


def _leaves(tree):
    """{key: leaf} of params / state ({a: {b: x}}) or updater state
    ({a: {b: (x, ...)}}), keyed as in the npz."""
    out = {}
    for ln, lp in tree.items():
        for pn, v in lp.items():
            if isinstance(v, tuple):
                for i, t in enumerate(v):
                    out[f"{ln}/{pn}/{i}"] = t
            else:
                out[f"{ln}/{pn}"] = v
    return out


def _assert_same_bits(got_tree, want_tree):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert got.keys() == want.keys()
    for key in want:
        w = want[key]
        dt = np.asarray(w).dtype
        if dt.itemsize == 2 and dt.kind == "V":
            np.testing.assert_array_equal(_bits(got[key]), _bits(w),
                                          err_msg=key)
        else:  # BN's running statistics stay f32
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(w), err_msg=key)


# NESTEROVS: pure-bf16 Adam's bias correction 1 - 0.999**t rounds to 0
# in bf16 at t 1 (in both packages), so its first step divides by zero
BF16_LENET = dict(dense_width=16, dtype="bfloat16", updater="NESTEROVS")


def _jax_trained_lenet():
    jnet = JMultiLayerNetwork(jlenet(**BF16_LENET)).init()
    rng = np.random.RandomState(0)
    x = rng.rand(8, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)]
    jnet.fit(JDataSet(x, y))  # velocities and a step count to carry
    return jnet, x


def _jax_trained_graph():
    jg = JGraph(jresnet50(learning_rate=0.01, **TINY_RESNET)).init()
    rng = np.random.RandomState(1)
    x = rng.rand(4, 1, 8, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
    jg.fit(JDataSet(x, y))  # NESTEROVS velocities and BN statistics
    return jg, x


def test_jax_bf16_leaves_are_raw_v2_records(tmp_path):
    """What the JAX package writes: ``|V2`` arrays of bf16 bits."""
    jnet, _ = _jax_trained_lenet()
    path = tmp_path / "j.zip"
    jax_serializer.write_model(jnet, str(path))
    coef = _npz(path, "coefficients.npz")
    upd = _npz(path, "updaterState.npz")
    assert coef and upd
    for arrays in (coef, upd):
        for a in arrays.values():
            assert a.dtype == np.dtype("V2")
    one = to_numpy(torch.ones(1, dtype=torch.bfloat16))
    assert one.dtype == np.dtype("V2") and one.view(np.int16)[0] == 0x3F80
    assert torch.equal(from_numpy(one), torch.ones(1, dtype=torch.bfloat16))


def test_jax_bf16_lenet_restores_into_the_port_bitwise(tmp_path):
    jnet, x = _jax_trained_lenet()
    path = tmp_path / "j.zip"
    jax_serializer.write_model(jnet, str(path))
    net = restore_model(str(path), device="cpu")
    assert isinstance(net, MultiLayerNetwork)
    assert net.iteration_count == jnet.iteration_count == 1
    _assert_same_bits(net.params, jnet.params)
    _assert_same_bits(net.updater_state, jnet.updater_state)
    # the restored model computes what a model given the weights in
    # memory computes, bit for bit; and JAX's output to bf16 rounding
    direct = MultiLayerNetwork(
        MultiLayerConfiguration.from_dict(jnet.conf.to_dict()),
        device="cpu").init(params=params_from_numpy(
            {k: np.asarray(v) for k, v in _leaves(jnet.params).items()},
            "cpu"))
    out = net.output(x)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, direct.output(x))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jnet.output(x), np.float32),
                               rtol=RTOL, atol=ATOL)


def test_jax_bf16_graph_restores_into_the_port_bitwise(tmp_path):
    jg, x = _jax_trained_graph()
    path = tmp_path / "g.zip"
    jax_serializer.write_model(jg, str(path))
    assert _npz(path, "layerState.npz")  # BN's running statistics
    g = restore_model(str(path), device="cpu")
    assert isinstance(g, ComputationGraph)
    _assert_same_bits(g.params, jg.params)
    _assert_same_bits(g.updater_state, jg.updater_state)
    _assert_same_bits({ln: st for ln, st in g.state.items() if st},
                      {ln: st for ln, st in jg.state.items() if st})
    out = g.output(x)[0]
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jg.output(x)[0], np.float32),
                               rtol=RTOL, atol=ATOL)


def _jax_view(arrays):
    """The JAX side of a port zip: ``|V2`` entries viewed as
    ``jnp.bfloat16`` (the JAX package's reader cannot take them)."""
    return {k: (jnp.asarray(a.view(jnp.bfloat16))
                if a.dtype == np.dtype("V2") else jnp.asarray(a))
            for k, a in arrays.items()}


def _nest(flat):
    out = {}
    for key, a in flat.items():
        ln, pn = key.rsplit("/", 1)
        out.setdefault(ln, {})[pn] = a
    return out


@pytest.mark.parametrize("engine", ["multilayer", "graph"])
def test_port_bf16_checkpoint_loads_into_jax_bitwise(tmp_path, engine):
    """The port trains a bf16 model one step and writes it; the zip holds
    the bytes the JAX package writes for the same trees, and JAX takes
    them back bitwise, with an output within bf16 rounding of the
    port's."""
    rng = np.random.RandomState(2)
    if engine == "multilayer":
        jmodel = JMultiLayerNetwork(jlenet(**BF16_LENET)).init()
        model = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
            jmodel.conf.to_dict()), device="cpu").init()
        x = rng.rand(8, 784).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)]
    else:
        jmodel = JGraph(jresnet50(learning_rate=0.01, **TINY_RESNET)).init()
        model = ComputationGraph(ComputationGraphConfiguration.from_dict(
            jmodel.conf.to_dict()), device="cpu").init()
        x = rng.rand(4, 1, 8, 8).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
    model.fit(DataSet(x, y))
    path = tmp_path / "p.zip"
    write_model(model, str(path))
    coef = _npz(path, "coefficients.npz")
    upd = _npz(path, "updaterState.npz")
    for key, t in _leaves(model.params).items():
        assert coef[key].dtype == np.dtype("V2")
        np.testing.assert_array_equal(coef[key].view(np.int16), _bits(t))
    for key, t in _leaves(model.updater_state).items():
        np.testing.assert_array_equal(upd[key].view(np.int16), _bits(t))
    # the JAX package writes the same bytes for the same trees
    jmodel.params = {**jmodel.params, **_nest(_jax_view(coef))}
    jmodel.state = {**jmodel.state, **_nest(_jax_view(
        _npz(path, "layerState.npz")))}
    jpath = tmp_path / "j.zip"
    jax_serializer.write_model(jmodel, str(jpath))
    jcoef = _npz(jpath, "coefficients.npz")
    assert jcoef.keys() == coef.keys()
    for key in coef:
        assert jcoef[key].dtype == coef[key].dtype
        np.testing.assert_array_equal(jcoef[key].view(np.int16),
                                      coef[key].view(np.int16))
    _assert_same_bits(model.params, jmodel.params)
    ref = model.output(x)
    got = jmodel.output(x)
    if engine == "graph":
        ref, got = ref[0], got[0]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               ref.float().numpy(), rtol=RTOL, atol=ATOL)


def test_f16_and_f32_leaves_stay_numpy_dtypes():
    for dt, np_dt in ((torch.float16, np.float16),
                      (torch.float32, np.float32)):
        t = torch.arange(6, dtype=dt).reshape(2, 3) / 3
        a = to_numpy(t)
        assert a.dtype == np_dt
        assert torch.equal(from_numpy(a), t)
