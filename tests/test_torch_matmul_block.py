"""The port's fused dense epilogue
(``deeplearning4j_tpu_torch.ops.matmul_block``) against the JAX
package's, on the CPU.

On a CPU tensor the port's ``matmul_block`` runs its plain PyTorch
version; it is held against the JAX XLA reference
(``matmul_block_reference``) on every shape, ragged m/n/k included, and
against the JAX Pallas kernel through the Pallas interpreter where the
JAX tiling takes the shape (the CUDA kernel itself masks ragged edges,
so it has no such gate). Tolerance: ``kernel_tols()``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.ops import matmul_block as jax_mm_block
from deeplearning4j_tpu.ops import matmul_block_ok as jax_mm_ok
from deeplearning4j_tpu.ops import matmul_block_reference as jax_mm_ref
from deeplearning4j_tpu_torch.ops import (
    SUPPORTED_EPILOGUES,
    dispatch,
    matmul_block,
    matmul_block_reference,
)

SHAPES = [
    (8, 16, 128),
    (32, 64, 256),
    (1, 7, 3),       # ragged everywhere
    (70, 33, 129),
    (5, 100, 65),
]


def _data(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    b = (rng.randn(n) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_matmul_block_matches_jax_reference(m, k, n, activation):
    x, w, b = _data(m, k, n)
    got = matmul_block(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), activation=activation)
    ref = jax_mm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     activation=activation)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("m,k,n", SHAPES[:2])
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_matmul_block_matches_jax_pallas_kernel(m, k, n, activation):
    assert jax_mm_ok(m, k, n)
    x, w, b = _data(m, k, n, seed=1)
    got = matmul_block(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), activation=activation)
    ref = jax_mm_block(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       activation=activation, interpret=True)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def test_matmul_block_without_bias_and_bf16():
    x, w, _ = _data(9, 24, 40)
    got = matmul_block(torch.from_numpy(x), torch.from_numpy(w),
                       activation="relu")
    ref = jax_mm_ref(jnp.asarray(x), jnp.asarray(w), activation="relu")
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)
    gb = matmul_block(torch.from_numpy(x).bfloat16(),
                      torch.from_numpy(w).bfloat16(), activation="tanh")
    assert gb.dtype == torch.bfloat16
    rb = jax_mm_ref(jnp.asarray(x, jnp.bfloat16),
                    jnp.asarray(w, jnp.bfloat16), activation="tanh")
    np.testing.assert_allclose(gb.float().numpy(),
                               np.asarray(rb, np.float32),
                               rtol=2e-2, atol=1e-2)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    x, w, b = (torch.from_numpy(a) for a in _data(4, 6, 5))
    dispatch.reset_launch_counts()
    assert torch.equal(matmul_block(x, w, b, activation="leakyrelu"),
                       matmul_block_reference(x, w, b,
                                              activation="leakyrelu"))
    assert dispatch.launch_counts()["matmul_block"] == 0


def test_unknown_epilogue_raises():
    x, w, b = (torch.from_numpy(a) for a in _data(4, 6, 5))
    with pytest.raises(ValueError, match="unsupported epilogue"):
        matmul_block(x, w, b, activation="softmax")


@pytest.mark.parametrize("m,k,n", SHAPES[:2])
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_matmul_block_grads_match_jax(m, k, n, activation):
    """dx, dW and db against the JAX Pallas route (its backward is
    jax.vjp of the XLA reference math), relu's z == 0 tie included:
    some rows of x are zero and the bias is zero on half the columns."""
    import jax

    x, w, b = _data(m, k, n, seed=2)
    x[::3] = 0.0
    b[: n // 2] = 0.0
    g = np.random.RandomState(3).randn(m, n).astype(np.float32)

    def f(*a):
        return jnp.sum(jax_mm_block(*a, activation=activation,
                                    interpret=True) * jnp.asarray(g))

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, w, b)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    matmul_block(*ts, activation=activation).backward(torch.from_numpy(g))
    rtol, atol = kernel_tols()
    for name, t, r in zip(("x", "w", "b"), ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol, err_msg=name)


def test_matmul_block_relu_tie_takes_half_the_gradient():
    x = torch.zeros(2, 3, requires_grad=True)
    w = torch.ones(3, 4, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    matmul_block(x, w, b, activation="relu").sum().backward()
    np.testing.assert_array_equal(b.grad.numpy(), np.full(4, 1.0))
    np.testing.assert_array_equal(x.grad.numpy(), np.full((2, 3), 2.0))


# (path, m, k, n, route): the dense kernel's products on the main paths.
# The transformer LM (d 768, batch 16 x t 512 = 8192 rows; t 16384 in
# the long-context output) takes the wide 128 x 192 route; LeNet-5's
# dense layers (800 -> 500 -> 10) at serving buckets 1 / 32 and the
# training batch 256, AlexNet's (9216 -> 4096 -> 4096 -> 1000) at batch
# 64 and KV-cache sampling (one byte, or the 256-byte prompt, a call)
# keep the 64 x 64 tiled route and its split-K plan.
ROUTE_CASES = [
    ("transformer.input", 8192, 256, 768, "wide"),
    ("transformer.ffn2", 8192, 3072, 768, "wide"),
    ("transformer-long.ffn2", 16384, 3072, 768, "wide"),
    ("lenet.dense1@1", 1, 800, 500, "tiled"),
    ("lenet.dense1@32", 32, 800, 500, "tiled"),
    ("lenet.dense1@256", 256, 800, 500, "tiled"),
    ("lenet.output@256", 256, 500, 10, "tiled"),
    ("alexnet.dense1", 64, 9216, 4096, "tiled"),
    ("alexnet.dense2", 64, 4096, 4096, "tiled"),
    ("alexnet.output", 64, 4096, 1000, "tiled"),
    ("sample.ffn2@byte", 1, 3072, 768, "tiled"),
    ("sample.ffn2@prompt", 256, 3072, 768, "tiled"),
]


@pytest.mark.parametrize("path,m,k,n,route", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_matmul_route_pins_the_main_paths(path, m, k, n, route):
    from deeplearning4j_tpu_torch.ops.matmul_block import matmul_route

    assert matmul_route(m, n) == route


def test_matmul_route_turns_wide_at_one_wave_of_tiles():
    from deeplearning4j_tpu_torch.ops.matmul_block import (
        WIDE_MIN_TILES,
        WIDE_TILE,
        matmul_route,
    )

    assert WIDE_MIN_TILES == 132  # the H100's SMs
    rows, cols = WIDE_TILE
    assert (rows, cols) == (128, 192)
    # 11 x 12 = 132 tiles of 128 x 192: one wave; one row less is short
    assert matmul_route(11 * rows, 12 * cols) == "wide"
    assert matmul_route(10 * rows, 12 * cols) == "tiled"
    # a ragged edge counts as a tile
    assert matmul_route(10 * rows + 1, 12 * cols) == "wide"
