"""The port's fused conv (``deeplearning4j_tpu_torch.ops.conv_block``)
against the JAX package's, on the CPU.

On a CPU tensor the port's ``conv_block`` runs its plain PyTorch
version; it is held against the JAX package's XLA reference
(``conv_block_reference``) and against the JAX Pallas kernel run
through the Pallas interpreter, on the same numpy inputs. Tolerance:
``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5) — both sides sum in f32,
in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.ops import conv_block as jax_conv_block
from deeplearning4j_tpu.ops import conv_block_reference as jax_conv_ref
from deeplearning4j_tpu_torch.ops import (
    SUPPORTED_EPILOGUES,
    conv_block,
    conv_block_reference,
    dispatch,
)

# (x shape, w shape, stride, padding)
GEOMETRIES = [
    ((2, 3, 9, 7), (5, 3, 3, 3), (1, 1), (0, 0)),
    ((2, 3, 9, 7), (5, 3, 3, 3), (1, 1), (1, 1)),
    ((2, 3, 9, 7), (5, 3, 3, 3), (2, 2), (1, 1)),
    ((2, 3, 9, 7), (5, 3, 3, 3), (2, 1), (2, 0)),   # asymmetric
    ((1, 4, 10, 8), (6, 4, 5, 2), (1, 3), (0, 1)),  # odd kernel and map
    ((2, 3, 35, 35), (8, 3, 11, 11), (4, 4), (2, 2)),  # AlexNet conv1-like
]


def _data(xs, ws, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*xs).astype(np.float32)
    w = (rng.randn(*ws) * 0.2).astype(np.float32)
    o = ws[0]
    bias = (rng.randn(o) * 0.1).astype(np.float32)
    scale = (rng.rand(o) + 0.5).astype(np.float32)
    shift = (rng.randn(o) * 0.1).astype(np.float32)
    return x, w, bias, scale, shift


def _port(arrays, **kw):
    out = conv_block(*(torch.from_numpy(a) for a in arrays), **kw)
    return out.numpy()


@pytest.mark.parametrize("xs,ws,stride,padding", GEOMETRIES)
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_conv_block_matches_jax_reference(xs, ws, stride, padding,
                                          activation):
    arrays = _data(xs, ws)
    got = _port(arrays, stride=stride, padding=padding,
                activation=activation)
    ref = jax_conv_ref(
        *(jnp.asarray(a) for a in arrays), stride=stride, padding=padding,
        activation=activation)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("xs,ws,stride,padding", [
    GEOMETRIES[1], GEOMETRIES[3], GEOMETRIES[5]])
@pytest.mark.parametrize("activation", ["relu", "leakyrelu"])
def test_conv_block_matches_jax_pallas_kernel(xs, ws, stride, padding,
                                              activation):
    """The JAX kernel itself, through the Pallas interpreter."""
    arrays = _data(xs, ws, seed=1)
    got = _port(arrays, stride=stride, padding=padding,
                activation=activation)
    ref = jax_conv_block(
        *(jnp.asarray(a) for a in arrays), stride=stride, padding=padding,
        activation=activation, interpret=True)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def test_conv_block_optional_terms_default_to_identity():
    x, w, _, _, _ = _data((2, 3, 9, 7), (5, 3, 3, 3))
    got = _port((x, w), padding=(1, 1), activation="tanh")
    ref = jax_conv_ref(jnp.asarray(x), jnp.asarray(w), padding=(1, 1),
                       activation="tanh")
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def test_conv_block_bf16_sums_in_f32():
    x, w, b, a, s = _data((2, 3, 9, 7), (5, 3, 3, 3))
    xb, wb = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, w))
    got = conv_block(xb, wb, torch.from_numpy(b), padding=(1, 1),
                     activation="relu")
    assert got.dtype == torch.bfloat16
    ref = jax_conv_ref(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b), padding=(1, 1), activation="relu")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2e-2, atol=1e-2)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    x, w, b, _, _ = _data((1, 2, 6, 6), (3, 2, 3, 3))
    dispatch.reset_launch_counts()
    tx, tw, tb = (torch.from_numpy(v) for v in (x, w, b))
    got = conv_block(tx, tw, tb, activation="relu")
    ref = conv_block_reference(tx, tw, tb, activation="relu")
    assert torch.equal(got, ref)
    assert dispatch.launch_counts()["conv_block"] == 0


def test_unknown_epilogue_raises():
    x, w, _, _, _ = _data((1, 2, 6, 6), (3, 2, 3, 3))
    with pytest.raises(ValueError, match="unsupported epilogue"):
        conv_block(torch.from_numpy(x), torch.from_numpy(w),
                   activation="softmax")


# --- the backward ------------------------------------------------------------


def _jax_grads(arrays, g, **kw):
    """Grads of sum(conv_block(...) * g) w.r.t. x, w, bias, bn_scale,
    bn_shift: the JAX Pallas kernels (forward, backward-data and
    backward-weights) through the Pallas interpreter."""
    import jax

    def f(*a):
        return jnp.sum(jax_conv_block(*a, interpret=True, **kw)
                       * jnp.asarray(g))

    return [np.asarray(v) for v in jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrays))]


def _port_grads(fn, arrays, g, **kw):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    fn(*ts, **kw).backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in ts]


def _upstream(arrays, stride, padding, ws, seed=2):
    xs = arrays[0].shape
    oh = (xs[2] + 2 * padding[0] - ws[2]) // stride[0] + 1
    ow = (xs[3] + 2 * padding[1] - ws[3]) // stride[1] + 1
    rng = np.random.RandomState(seed)
    return rng.randn(xs[0], ws[0], oh, ow).astype(np.float32)


@pytest.mark.parametrize("xs,ws,stride,padding", [
    GEOMETRIES[0], GEOMETRIES[2], GEOMETRIES[3]])
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_conv_block_grads_match_jax_pallas_kernels(xs, ws, stride, padding,
                                                   activation):
    """dx, dW, dbias, dscale and dshift against the JAX kernels'
    backward (stride 1 and 2, asymmetric padding, every epilogue,
    nonzero bias and BN terms); the port's CPU route is the plain
    version of the CUDA backward. kernel_tols: f32 sums in other
    orders."""
    arrays = _data(xs, ws, seed=3)
    g = _upstream(arrays, stride, padding, ws)
    kw = dict(stride=stride, padding=padding, activation=activation)
    got = _port_grads(conv_block, arrays, g, **kw)
    ref = _jax_grads(arrays, g, **kw)
    rtol, atol = kernel_tols()
    for name, a, b in zip(("x", "w", "bias", "bn_scale", "bn_shift"), got,
                          ref):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def test_relu_gradient_at_zero_is_one_half_as_on_the_kernel_route():
    """All-zero input windows and a zero bias give z == 0 exactly: the
    TPU kernel route (and so the port, on both of its routes) sends half
    the gradient through, where autograd through torch.relu sends
    none."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 0, 0] = 1.0
    w = np.ones((2, 1, 2, 2), np.float32)
    b = np.zeros(2, np.float32)
    g = np.ones((1, 2, 3, 3), np.float32)
    got = _port_grads(conv_block, (x, w, b), g, activation="relu")
    ref = _jax_grads((x, w, b, np.ones(2, np.float32),
                      np.zeros(2, np.float32)), g, activation="relu")
    # one window sees the 1 (z = 1), eight see only zeros (z = 0)
    np.testing.assert_allclose(got[2], [1.0 + 8 * 0.5] * 2)
    np.testing.assert_allclose(got[2], ref[2])
    np.testing.assert_allclose(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1])
    plain = _port_grads(conv_block_reference, (x, w, b), g,
                        activation="relu")
    for a, r in zip(plain, got):
        np.testing.assert_array_equal(a, r)


def test_input_without_grad_skips_dx_and_keeps_dw():
    x, w, b, _, _ = _data((2, 1, 12, 12), (4, 1, 5, 5), seed=4)
    tx = torch.from_numpy(x)
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    y = conv_block(tx, tw, tb, activation="relu")
    g = _upstream((x,), (1, 1), (0, 0), w.shape)
    y.backward(torch.from_numpy(g))
    assert tx.grad is None
    ref = _jax_grads((x, w, b, np.ones(4, np.float32),
                      np.zeros(4, np.float32)), g, activation="relu")
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(tw.grad.numpy(), ref[1], rtol=rtol, atol=atol)
    np.testing.assert_allclose(tb.grad.numpy(), ref[2], rtol=rtol, atol=atol)


@pytest.mark.parametrize("xs,ws,stride,padding", GEOMETRIES)
def test_backward_plain_versions_match_torch_grad(xs, ws, stride, padding):
    """The plain versions the CUDA backward kernels are held against on
    the card (col2im / im2col GEMMs) give torch.nn.grad's dx and dW."""
    from deeplearning4j_tpu_torch.ops import (
        conv_bwd_data,
        conv_bwd_w,
    )

    x, w, _, _, _ = _data(xs, ws, seed=5)
    dacc = torch.from_numpy(_upstream((x,), stride, padding, ws))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    dispatch.reset_launch_counts()
    dx = conv_bwd_data(dacc, tw, xs[2:], stride, padding)
    dw = conv_bwd_w(tx, dacc, ws, stride, padding)
    assert sum(dispatch.launch_counts().values()) == 0
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(
        dx.numpy(), torch.nn.grad.conv2d_input(
            xs, tw, dacc, stride=stride, padding=padding).numpy(),
        rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        dw.numpy(), torch.nn.grad.conv2d_weight(
            tx, ws, dacc, stride=stride, padding=padding).numpy(),
        rtol=rtol, atol=atol)
