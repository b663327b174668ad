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
