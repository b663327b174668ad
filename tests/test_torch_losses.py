"""The port's loss registry (``deeplearning4j_tpu_torch.nn.losses``)
against the JAX package's, on the CPU: every registered loss, on 2-d
rows and on 3-d (RNN) input with and without a ``[batch, time]`` mask,
score and gradient with respect to the pre-activation. Tolerance: f32
math on both sides in other orders (rtol 1e-5, atol 1e-6; the gradient
rtol 1e-4, as MAPE divides by |labels| + 1e-8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import losses as jax_losses
from deeplearning4j_tpu_torch.nn import losses

# each loss with an output activation that suits its label domain
ACTIVATION = {
    "MSE": "identity", "SQUARED_LOSS": "tanh", "L2": "identity",
    "L1": "identity", "MEAN_ABSOLUTE_ERROR": "identity",
    "MEAN_ABSOLUTE_PERCENTAGE_ERROR": "identity",
    "MEAN_SQUARED_LOGARITHMIC_ERROR": "sigmoid", "XENT": "sigmoid",
    "MCXENT": "softmax", "NEGATIVELOGLIKELIHOOD": "softmax",
    "RECONSTRUCTION_CROSSENTROPY": "sigmoid", "KL_DIVERGENCE": "softmax",
    "COSINE_PROXIMITY": "identity", "HINGE": "identity",
    "SQUARED_HINGE": "identity", "POISSON": "softplus",
}
# the non-fused branches of the two fused losses
EXTRA = [("MCXENT", "sigmoid"), ("XENT", "hardsigmoid")]
CASES = sorted(ACTIVATION.items()) + EXTRA


def _data(loss, shape, seed):
    rng = np.random.RandomState(seed)
    preout = rng.randn(*shape).astype(np.float32)
    if loss in ("HINGE", "SQUARED_HINGE"):
        labels = np.sign(rng.randn(*shape)).astype(np.float32)
    elif loss in ("MCXENT", "NEGATIVELOGLIKELIHOOD", "KL_DIVERGENCE"):
        idx = rng.randint(0, shape[1], (shape[0],) + shape[2:])
        labels = np.moveaxis(np.eye(shape[1], dtype=np.float32)[idx], -1, 1)
    else:
        labels = rng.rand(*shape).astype(np.float32)
    return labels, preout


def _both(loss, act, labels, preout, mask, average):
    lt = torch.from_numpy(labels)
    pt = torch.from_numpy(preout).requires_grad_(True)
    mt = None if mask is None else torch.from_numpy(mask)
    s = losses.score(loss, lt, pt, act, mt, average)
    s.backward()

    def jf(p):
        return jax_losses.score(loss, jnp.asarray(labels), p, act,
                                None if mask is None else jnp.asarray(mask),
                                average)

    js, jg = jax.value_and_grad(jf)(jnp.asarray(preout))
    return (float(s.detach()), pt.grad.numpy()), (float(js), np.asarray(jg))


def _check(got, ref):
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-6)


def test_the_registry_has_the_same_16_names():
    assert losses.names() == jax_losses.names()
    assert len(losses.names()) == 16
    assert sorted(ACTIVATION) == losses.names()


@pytest.mark.parametrize("loss,act", CASES)
@pytest.mark.parametrize("average", [True, False])
def test_2d_loss_matches_jax(loss, act, average):
    labels, preout = _data(loss, (6, 5), 0)
    _check(*_both(loss, act, labels, preout, None, average))


@pytest.mark.parametrize("loss,act", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_3d_loss_matches_jax(loss, act, masked):
    labels, preout = _data(loss, (3, 4, 5), 1)
    mask = None
    if masked:
        mask = (np.random.RandomState(2).rand(3, 5) > 0.4).astype(np.float32)
    _check(*_both(loss, act, labels, preout, mask, True))


def test_2d_per_example_mask_and_per_row_scores():
    labels, preout = _data("MCXENT", (6, 5), 3)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    _check(*_both("MCXENT", "softmax", labels, preout, mask, True))
    rows = losses.per_row_scores("MCXENT", torch.from_numpy(labels),
                                 torch.from_numpy(preout), "softmax",
                                 torch.from_numpy(mask))
    ref = jax_losses.per_row_scores("MCXENT", jnp.asarray(labels),
                                    jnp.asarray(preout), "softmax",
                                    jnp.asarray(mask))
    np.testing.assert_allclose(rows.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert rows[1] == 0 and rows[4] == 0


def test_softmax_mcxent_is_stable_at_extreme_logits():
    labels = np.eye(3, dtype=np.float32)[[0, 2]]
    preout = np.array([[1e4, 0.0, -1e4], [-1e4, 0.0, 1e4]], np.float32)
    got, ref = _both("MCXENT", "softmax", labels, preout, None, True)
    assert np.isfinite(got[0]) and np.all(np.isfinite(got[1]))
    _check(got, ref)


def test_unknown_loss_and_rank_raise():
    t = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.score("NOPE", t, t, "identity")
    with pytest.raises(ValueError, match="2-d or 3-d"):
        losses.score("MSE", torch.zeros(3), torch.zeros(3), "identity")


def test_registered_custom_loss_is_used(monkeypatch):
    monkeypatch.setattr(losses, "_REGISTRY", dict(losses._REGISTRY))
    losses.register("my_abs_sum", lambda lab, pre, act: (pre - lab).abs()
                    .sum(-1))
    s = losses.score("MY_ABS_SUM", torch.zeros(2, 2), torch.ones(2, 2),
                     "identity")
    assert float(s) == 2.0


def test_output_layer_compute_score_matches_jax():
    from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer

    rng = np.random.RandomState(4)
    x = rng.randn(5, 7).astype(np.float32)
    params = {"W": (rng.randn(7, 3) * 0.5).astype(np.float32),
              "b": (rng.randn(3) * 0.1).astype(np.float32)}
    labels = np.eye(3, dtype=np.float32)[[0, 2, 1, 1, 0]]
    mask = np.array([1, 1, 0, 1, 1], np.float32)
    kw = dict(n_in=7, n_out=3, loss="MCXENT")
    got = OutputLayer(**kw).compute_score(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask))
    ref = JOutput(**kw).compute_score(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(labels), jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-6)
