"""Training in the port (``MultiLayerNetwork.fit``) against the JAX
package, on the CPU.

A narrow LeNet (LeNet-5's layer sequence at 4 / 6 channels and a dense
32) is built by the JAX package; its initial weights are carried into
the port with ``params_from_numpy``, and both packages fit the same
numpy batches. The port's CPU route is the plain version of its CUDA
kernels, forward and backward.

- Against the JAX Pallas kernel route (``DL4J_TPU_PALLAS=1``, the
  kernels interpreted on the CPU), on synthetic MNIST: relu's gradient
  at z == 0 is 0.5 on both.
- Against the JAX XLA route, on data with no exact zeros, so no
  pre-activation is exactly 0 and the two relu gradients agree.

Tolerances: SGD at ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5), the
same sums in other orders. Adam divides each gradient by its own
magnitude, ``lr * m / (sqrt(v) + 1e-8)``: a weight whose gradient is at
the f32 noise floor in both packages (|g| ~ 1e-9, its sign set by the
summation order) moves by up to lr in opposite directions. So Adam
trajectories are held at atol = lr / 50 on the weights (2e-4 at lr
0.01) and rtol 1e-3 on the scores, and at most 1 % of any parameter's
entries may exceed kernel_tols.
"""

import warnings

import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.datasets import (
    MnistDataSetIterator as JMnistDataSetIterator,
)
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.ops import dispatch as jax_dispatch
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch.datasets import (
    DataSet,
    ListDataSetIterator,
    MnistDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import SubsamplingLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    restore_model,
    updater_state_from_numpy,
    write_model,
)
from deeplearning4j_tpu_torch.zoo import alexnet, lenet


def narrow_lenet(updater="ADAM", lr=0.01, l2=0.0):
    return (
        JNeuralNetConfiguration.Builder().seed(7).updater(updater)
        .learning_rate(lr).l2(l2)
        .list()
        .layer(JConv(n_out=4, kernel_size=(5, 5), activation="relu"))
        .layer(JPool(pooling_type="MAX"))
        .layer(JConv(n_out=6, kernel_size=(5, 5), activation="relu"))
        .layer(JPool(pooling_type="MAX"))
        .layer(JDense(n_out=32, activation="relu"))
        .layer(JOutput(n_out=10, loss="MCXENT"))
        .set_input_type(JInputType.convolutional_flat(28, 28, 1))
        .build()
    )


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _pair(jconf):
    """The JAX network and the port's twin on its initial weights."""
    jnet = JMultiLayerNetwork(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict()), device="cpu").init(
            params=params_from_numpy(_flat(jnet.params), "cpu"))
    return jnet, net


def _mnist_batches(n_batches, batch=16):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        it = MnistDataSetIterator(batch, num_examples=n_batches * batch,
                                  allow_synthetic=True)
    return list(it)


def _zero_free_batches(n_batches, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        x = (rng.rand(batch, 784) * 0.9 + 0.05).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)]
        out.append(DataSet(x, y))
    return out


def _fit_both(jnet, net, batches):
    """Step by step; returns the per-step scores of each package."""
    js, ps = [], []
    for ds in batches:
        jnet.fit(JDataSet(ds.features, ds.labels))
        js.append(float(jnet.score_value))
        net.fit(ds)
        ps.append(net.score_value)
    return np.array(js), np.array(ps)


def _check_params(net, jnet, adam, lr=0.01):
    rtol, atol = kernel_tols()
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        got = net.params[ln][pn].numpy()
        if not adam:
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                       err_msg=key)
            continue
        np.testing.assert_allclose(got, ref, rtol=0, atol=lr / 50,
                                   err_msg=key)
        off = np.abs(got - ref) > atol + rtol * np.abs(ref)
        assert off.mean() <= 0.01, (key, off.sum(), off.size)


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS", "1")
    jax_dispatch.reset_for_tests()
    yield
    monkeypatch.delenv("DL4J_TPU_PALLAS")
    jax_dispatch.reset_for_tests()


@pytest.mark.parametrize("updater", ["SGD", "ADAM"])
def test_fit_matches_jax_pallas_route_on_synthetic_mnist(pallas_route,
                                                         updater):
    lr = 0.1 if updater == "SGD" else 0.01
    jnet, net = _pair(narrow_lenet(updater, lr))
    js, ps = _fit_both(jnet, net, _mnist_batches(3))
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(ps, js, rtol=rtol if updater == "SGD"
                               else 1e-3, atol=atol)
    _check_params(net, jnet, adam=updater == "ADAM", lr=lr)
    assert net.iteration_count == jnet.iteration_count == 3


@pytest.mark.parametrize("updater", ["SGD", "ADAM"])
def test_fit_matches_jax_xla_route_on_zero_free_data(updater):
    lr = 0.1 if updater == "SGD" else 0.01
    jnet, net = _pair(narrow_lenet(updater, lr, l2=1e-3))
    js, ps = _fit_both(jnet, net, _zero_free_batches(4))
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(ps, js, rtol=rtol if updater == "SGD"
                               else 1e-3, atol=atol)
    _check_params(net, jnet, adam=updater == "ADAM", lr=lr)
    # the L2 penalty is in the score both ways
    ds = _zero_free_batches(1, seed=9)[0]
    np.testing.assert_allclose(
        net.score(ds), jnet.score(JDataSet(ds.features, ds.labels)),
        rtol=rtol, atol=atol)


def test_fit_over_an_iterator_and_epochs_matches_jax():
    jnet, net = _pair(narrow_lenet("NESTEROVS", 0.01))
    batches = _zero_free_batches(3, seed=3)
    jnet.fit([JDataSet(b.features, b.labels) for b in batches], epochs=2)
    net.fit(ListDataSetIterator(batches), epochs=2)
    assert net.iteration_count == jnet.iteration_count == 6
    assert net.epoch_count == jnet.epoch_count == 2
    _check_params(net, jnet, adam=False)


def test_fit_on_an_xy_pair_and_the_score_falls():
    _, net = _pair(narrow_lenet("ADAM", 0.01))
    ds = _mnist_batches(1, batch=64)[0]
    before = net.score(ds)
    net.fit(ds.features, ds.labels, epochs=15)
    assert net.iteration_count == 15
    assert net.score(ds) < 0.5 * before


def test_two_cpu_runs_are_bitwise_equal():
    jconf = narrow_lenet("ADAM", 0.01)
    runs = []
    for _ in range(2):
        _, net = _pair(jconf)
        net.fit(_mnist_batches(2))
        runs.append(net.params)
    for ln, lp in runs[0].items():
        for pn, t in lp.items():
            assert torch.equal(t, runs[1][ln][pn])


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resume_both_ways_with_updater_state(tmp_path, first):
    """Two Adam steps in one package, save (updaterState.npz included),
    two more in the other, held against two more in the first."""
    jconf = narrow_lenet("ADAM", 0.01)
    batches = _zero_free_batches(4, seed=5)
    jb = [JDataSet(b.features, b.labels) for b in batches]
    jnet, net = _pair(jconf)
    path = str(tmp_path / "ckpt.zip")
    if first == "jax":
        jnet.fit(jb[:2])
        jax_serializer.write_model(jnet, path)
        resumed = restore_model(path, device="cpu")
        assert resumed.iteration_count == 2
        resumed.fit(batches[2:])
        jnet.fit(jb[2:])
        _check_params(resumed, jnet, adam=True)
        return
    net.fit(batches[:2])
    write_model(net, path)
    jres = jax_serializer.restore_model(path)
    assert jres.iteration_count == 2
    jres.fit(jb[2:])
    net.fit(batches[2:])
    _check_params(net, jres, adam=True)


def test_updater_state_from_numpy_carries_jax_moments():
    jnet, net = _pair(narrow_lenet("ADAM", 0.01))
    jnet.fit(JDataSet(*(lambda b: (b.features, b.labels))(
        _zero_free_batches(1)[0])))
    flat = {f"{ln}/{pn}/{i}": np.asarray(a)
            for ln, lp in jnet.updater_state.items()
            for pn, tup in lp.items() for i, a in enumerate(tup)}
    state = updater_state_from_numpy(flat, net.updater_state)
    assert set(state) == set(net.updater_state)
    for key, arr in flat.items():
        ln, pn, i = key.rsplit("/", 2)
        np.testing.assert_array_equal(state[ln][pn][int(i)].numpy(), arr)
    assert state["1"] == {}  # the pooling layer holds no state


def test_synthetic_mnist_batches_are_bitwise_the_jax_iterators():
    kw = dict(num_examples=300, allow_synthetic=True, seed=11)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ours = MnistDataSetIterator(64, **kw)
        ref = JMnistDataSetIterator(64, **kw)
    assert ours.synthetic and ref.synthetic
    n = 0
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
        n += 1
    assert n == 5 and not ours.has_next()
    # and again after the reset that iterating performs
    np.testing.assert_array_equal(next(iter(ours)).features,
                                  next(iter(ref)).features)


def test_mnist_idx_files_are_read_like_the_jax_package(tmp_path):
    import gzip
    import struct

    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (7, 28, 28)).astype(np.uint8)
    labs = rng.randint(0, 10, 7).astype(np.uint8)
    with gzip.open(tmp_path / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 7, 28, 28) + imgs.tobytes())
    (tmp_path / "train-labels-idx1-ubyte").write_bytes(
        struct.pack(">II", 2049, 7) + labs.tobytes())
    ours = MnistDataSetIterator(4, data_dir=str(tmp_path), shuffle=False)
    ref = JMnistDataSetIterator(4, data_dir=str(tmp_path), shuffle=False)
    assert not ours.synthetic
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_missing_mnist_without_opt_in_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("DL4J_TPU_ALLOW_SYNTHETIC", raising=False)
    with pytest.raises(FileNotFoundError, match="allow_synthetic"):
        MnistDataSetIterator(8, data_dir=str(tmp_path))


def test_max_pool_gradient_goes_to_the_first_tied_maximum():
    """Windows with tied maxima (zeros after relu, and equal positive
    values): the gradient goes where the VJP of XLA's reduce_window max
    sends it."""
    import jax
    import jax.numpy as jnp

    x = np.zeros((1, 2, 4, 4), np.float32)
    x[0, 0, 0, :2] = 1.0          # two tied positive maxima in a row
    x[0, 0, 2:, 2:] = 3.0         # four tied maxima
    x[0, 1, 1, 1] = -1.0          # a window of zeros and a negative
    g = np.arange(1, 9, dtype=np.float32).reshape(1, 2, 2, 2)
    t = torch.from_numpy(x).requires_grad_(True)
    y, _ = SubsamplingLayer(pooling_type="MAX").apply({}, t, {}, train=True)
    y.backward(torch.from_numpy(g))

    def f(a):
        out, _ = JPool(pooling_type="MAX").apply({}, a, {}, train=True)
        return jnp.sum(out * jnp.asarray(g))

    ref = np.asarray(jax.grad(f)(jnp.asarray(x)))
    np.testing.assert_array_equal(t.grad.numpy(), ref)
    assert t.grad[0, 0, 0, 0] == 1.0 and t.grad[0, 0, 0, 1] == 0.0


def test_fit_refuses_what_it_does_not_carry():
    # AlexNet's dense layers train with dropout 0.5
    net = MultiLayerNetwork(alexnet(height=67, width=67, n_classes=10),
                            device="cpu")
    x = np.zeros((2, 3, 67, 67), np.float32)
    y = np.eye(10, dtype=np.float32)[[0, 1]]
    with pytest.raises(NotImplementedError, match="AlexNet-training"):
        net.fit(x, y)
    net = MultiLayerNetwork(lenet(dense_width=8), device="cpu").init()
    with pytest.raises(NotImplementedError, match="grad_accum"):
        net.fit(x, y, grad_accum=2)
    with pytest.raises(NotImplementedError, match="megastep"):
        net.fit(x, y, megastep=4)
    with pytest.raises(NotImplementedError, match="divergence guard"):
        net.set_divergence_guard(object())
    with pytest.raises(NotImplementedError, match="loss scaling"):
        net.set_transforms(loss_scale=True)
    tbptt = MultiLayerConfiguration.from_dict(
        dict(lenet(dense_width=8).to_dict(), backprop_type="TruncatedBPTT"))
    with pytest.raises(NotImplementedError, match="truncated BPTT"):
        MultiLayerNetwork(tbptt, device="cpu").fit(x, y)
    lbfgs = MultiLayerConfiguration.from_dict(
        dict(lenet(dense_width=8).to_dict(), optimization_algo="LBFGS"))
    with pytest.raises(NotImplementedError, match="LBFGS"):
        MultiLayerNetwork(lbfgs, device="cpu").fit(x, y)
    assert net.iteration_count == 0


def test_cpu_fit_launches_no_kernel_and_keeps_inference_tensors_out():
    _, net = _pair(narrow_lenet("ADAM", 0.01))
    ds = _mnist_batches(1)[0]
    net.output(ds.features)          # under inference_mode
    dispatch.reset_launch_counts()
    net.fit(ds)
    assert sum(dispatch.launch_counts().values()) == 0
    for lp in net.params.values():
        for t in lp.values():
            assert not t.is_inference() and not t.requires_grad
    net.fit(ds)                       # a second step trains on
    assert net.iteration_count == 2
