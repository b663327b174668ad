"""The engines' public methods in the port against the JAX package's, on
the CPU: ``params_flat`` / ``set_params_flat``, ``predict``,
``feed_forward_to_layer``, ``copy`` and ``summary`` on a small MLP, a
small conv net and two small graphs (VGG- and ResNet-shaped, with
BatchNormalization whose running statistics one JAX step moved); and
``ComputationGraph.output_padded`` against JAX's ``output_padded``, and
bitwise against the port's own unpadded ``output``.

Each JAX model is built from a seed, saved as a checkpoint zip and
restored into the port (``torch_serving_models.py``); inputs come from a
numpy seed. Tolerance: ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5);
``params_flat``, ``summary`` and the padded-vs-unpadded comparison are
exact.
"""

import numpy as np
import pytest
import torch

import torch_serving_models as M
from conftest import kernel_tols


def _np(out):
    out = out[0] if isinstance(out, list) else out
    return out.detach().cpu().numpy()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine_api")
    return {kind: M.pair(kind, d) for kind in M.KINDS}


@pytest.mark.parametrize("kind", M.KINDS)
def test_params_flat_is_jax_order_element_for_element(pairs, kind):
    jnet, _, net = pairs[kind]
    flat = net.params_flat()
    np.testing.assert_array_equal(flat, np.asarray(jnet.params_flat()))
    assert flat.size == net.num_params()


@pytest.mark.parametrize("kind", M.KINDS)
def test_set_params_flat_round_trips_and_matches_jax(pairs, kind, tmp_path):
    jnet, path, _ = pairs[kind]
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model

    net = restore_model(path, device="cpu")
    vec = np.asarray(jnet.params_flat()) * 0.5
    net.set_params_flat(vec)
    np.testing.assert_array_equal(net.params_flat(), vec)
    jcopy = jnet.copy()
    jcopy.set_params_flat(vec)
    x = M.rows(kind, 4, 1)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(_np(net.output(M.reshape_rows(x))),
                               M.jax_output(kind, jcopy, x),
                               rtol=rtol, atol=atol)
    with pytest.raises(ValueError, match="set_params_flat"):
        net.set_params_flat(vec[:-1])


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_predict_and_feed_forward_to_layer_match_jax(pairs, kind):
    jnet, _, net = pairs[kind]
    x = M.rows(kind, 6, 2)
    np.testing.assert_array_equal(net.predict(x), np.asarray(jnet.predict(x)))
    rtol, atol = kernel_tols()
    for idx in range(len(net.layer_names)):
        got = net.feed_forward_to_layer(idx, x)
        want = jnet.feed_forward_to_layer(idx, x)
        assert len(got) == len(want) == idx + 1
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", M.KINDS)
def test_copy_is_deep_and_answers_as_the_original(pairs, kind):
    jnet, _, net = pairs[kind]
    twin = net.copy()
    x = M.reshape_rows(M.rows(kind, 3, 3))
    np.testing.assert_array_equal(_np(twin.output(x)), _np(net.output(x)))
    assert type(twin) is type(net) and twin.device == net.device
    for ln, lp in net.params.items():
        for pn, t in lp.items():
            assert twin.params[ln][pn].data_ptr() != t.data_ptr()
    for ln, st in net.state.items():
        for k, t in st.items():
            assert torch.equal(twin.state[ln][k], t)
            assert twin.state[ln][k].data_ptr() != t.data_ptr()
    before = net.params_flat()
    twin.set_params_flat(before * 0.0)
    np.testing.assert_array_equal(net.params_flat(), before)
    np.testing.assert_array_equal(
        np.asarray(jnet.copy().params_flat()), before)


@pytest.mark.parametrize("kind", M.KINDS)
def test_summary_is_jax_summary(pairs, kind):
    jnet, _, net = pairs[kind]
    assert net.summary() == jnet.summary()
    assert f"Total params: {net.num_params()}" in net.summary()


@pytest.mark.parametrize("kind", ["vgg", "resnet"])
@pytest.mark.parametrize("n_valid,bucket", [(1, 1), (3, 4), (5, 8)])
def test_graph_output_padded_matches_jax_and_its_own_output(pairs, kind,
                                                            n_valid, bucket):
    jnet, _, net = pairs[kind]
    x = M.reshape_rows(M.rows(kind, n_valid, 4))
    pad = np.concatenate([x, np.zeros((bucket - n_valid,) + x.shape[1:],
                                      np.float32)])
    got = net.output_padded(pad, n_valid=n_valid)
    assert isinstance(got, list) and len(got) == 1
    got = _np(got)
    assert got.shape[0] == n_valid
    want = np.asarray(jnet.output_padded(pad, n_valid=n_valid)[0])
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # the same computation as output: bitwise the unpadded forward
    np.testing.assert_array_equal(got, _np(net.output(x)))
    # padding rows are inert: other padding, the same valid rows
    noisy = pad.copy()
    noisy[n_valid:] = 7.0
    np.testing.assert_array_equal(_np(net.output_padded(
        noisy, n_valid=n_valid)), got)


def test_graph_output_padded_refuses_bad_row_counts(pairs):
    _, _, net = pairs["vgg"]
    x = np.zeros((4, 3, 8, 8), np.float32)
    for bad in (0, 5):
        with pytest.raises(ValueError, match="n_valid"):
            net.output_padded(x, n_valid=bad)
    with pytest.raises(ValueError, match="features_mask"):
        net.output_padded(x, n_valid=2,
                          features_masks=[np.ones((3, 8), np.float32)])


def test_output_signatures_count_distinct_forward_shapes(pairs):
    from deeplearning4j_tpu_torch.serving.compile_cache import jit_cache_size

    _, path, _ = pairs["mlp"]
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model

    net = restore_model(path, device="cpu")
    assert jit_cache_size(net) == 0
    for n in (1, 2, 2, 4, 1):
        net.output_padded(M.rows("mlp", n, n), n_valid=n)
    assert jit_cache_size(net) == 3
    assert jit_cache_size(object()) is None
