"""The port's attention ops (``deeplearning4j_tpu_torch.ops.flash_attention``,
``parallel.sequence``) and the dense kernel's residual variant against
the JAX package's, on the CPU.

On a CPU tensor the port's wrappers run their plain PyTorch versions:
``flash_attention`` the blockwise online softmax, held here against the
JAX Pallas kernels run in interpret mode (both schedules: the streamed
one by lowering ``_RESIDENT_TD_LIMIT`` in both modules, as
``tests/test_pallas_ops.py`` does); ``mha`` under a key mask the
materialized reference; the gradients (the reference recompute, and the
blockwise backward above ``_BWD_MATERIALIZE_T_LIMIT``) against
``jax.vjp``. The same numpy inputs, made from a seed, go to both. Forward
tolerance: ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5); gradients sum
up to t products more in another order: rtol 1e-3, atol 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.ops import matmul_block as jax_mm_block
from deeplearning4j_tpu.ops import mha as jax_mha
from deeplearning4j_tpu.ops import tiling as jax_tiling
from deeplearning4j_tpu.parallel.sequence import attention as jax_attention
from deeplearning4j_tpu_torch.ops import (
    _build,
    dispatch,
    flash_attention,
    flash_attention_reference,
    matmul_block,
    matmul_block_reference,
    mha,
)
from deeplearning4j_tpu_torch.parallel.sequence import attention

# the modules (the packages export functions of the same names)
jfa = importlib.import_module("deeplearning4j_tpu.ops.flash_attention")
fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

G_RTOL, G_ATOL = 1e-3, 1e-5


def _qkv(b, h, t, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))


def _close(got, ref, rtol=None, atol=None):
    krtol, katol = kernel_tols()
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref),
                               rtol=krtol if rtol is None else rtol,
                               atol=katol if atol is None else atol)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("t", [16, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax_kernel(t, causal):
    q, k, v = _qkv(2, 3, t, 16)
    dispatch.reset_launch_counts()
    got = flash_attention(*_t(q, k, v), causal=causal)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, interpret=True)
    _close(got, ref)
    _close(got, jax_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal))
    assert sum(dispatch.launch_counts().values()) == 0  # the plain version


@pytest.mark.parametrize("causal", [False, True])
def test_streamed_schedule_matches_jax(causal, monkeypatch):
    monkeypatch.setattr(jfa, "_RESIDENT_TD_LIMIT", 63)
    monkeypatch.setattr(fa, "_RESIDENT_TD_LIMIT", 63)
    q, k, v = _qkv(2, 2, 128, 16, seed=4)
    got = flash_attention(*_t(q, k, v), causal=causal)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, block_q=32, block_k=32,
                              interpret=True)
    _close(got, ref)


def test_schedules_round_q_as_the_tpu_kernels_do():
    """bf16: the resident schedule rounds q * scale to bf16, the
    streamed one scales in f32; for f32 the two are the same function."""
    q, k, v = _qkv(1, 2, 32, 12, seed=5)
    qt, kt, vt = _t(q, k, v)
    res = flash_attention_reference(qt, kt, vt, True, streamed=False)
    st = flash_attention_reference(qt, kt, vt, True, streamed=True)
    assert torch.equal(res, st)
    qb, kb, vb = qt.bfloat16(), kt.bfloat16(), vt.bfloat16()
    scale = 1.0 / 12 ** 0.5
    assert torch.equal(fa._scaled_q(qb, streamed=False),
                       (qb * torch.tensor(scale, dtype=torch.bfloat16))
                       .float())
    assert torch.equal(fa._scaled_q(qb, streamed=True), qb.float() * scale)
    for streamed in (False, True):
        got = flash_attention_reference(qb, kb, vb, True, streamed=streamed)
        assert got.dtype == torch.bfloat16
        ref = jax_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref),
                                   rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("t", [16, 24, 5])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_with_a_key_mask_matches_jax(t, causal):
    q, k, v = _qkv(3, 2, t, 8, seed=1)
    mask = np.ones((3, t), np.float32)
    mask[0, t // 2:] = 0.0
    mask[2, 1:] = 0.0
    got = mha(*_t(q, k, v), causal=causal, mask=torch.from_numpy(mask))
    ref = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, mask=jnp.asarray(mask))
    _close(got, ref)
    # and without one (t 24 and 5 fail attention_seq_ok: the reference)
    _close(mha(*_t(q, k, v), causal=causal),
           jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal))


def test_tiling_helpers_match_jax():
    for t in (1, 5, 8, 16, 100, 128, 256, 384, 1000, 4096):
        assert fa.attention_seq_ok(t) == jax_tiling.attention_seq_ok(t)
        assert fa.pick_attention_blocks(t) == jax_tiling.pick_attention_blocks(t)
        for cap in (1, 32, 512):
            assert (fa.pow2_divisor_leq(t, cap)
                    == jax_tiling.pow2_divisor_leq(t, cap))


def _jax_grads(q, k, v, g, causal):
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(g))


def _port_grads(q, k, v, g, causal):
    leaves = [a.requires_grad_(True) for a in _t(q.copy(), k.copy(),
                                                 v.copy())]
    out = flash_attention(*leaves, causal=causal)
    return torch.autograd.grad(out, leaves, torch.from_numpy(g))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_match_jax_vjp(causal):
    q, k, v = _qkv(2, 2, 32, 8, seed=2)
    g = np.random.RandomState(3).randn(*q.shape).astype(np.float32)
    for got, ref in zip(_port_grads(q, k, v, g, causal),
                        _jax_grads(q, k, v, g, causal)):
        _close(got, ref, G_RTOL, G_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_backward_matches_jax(causal):
    q, k, v = _qkv(1, 2, 128, 16, seed=6)
    g = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    out = np.array(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal))
    got = fa._blockwise_attention_bwd(*_t(q, k, v, out, g), causal,
                                      block_k=32)
    ref = jfa._blockwise_attention_bwd(
        *(jnp.asarray(a) for a in (q, k, v, out, g)), causal, block_k=32)
    for a, r in zip(got, ref):
        _close(a, r, G_RTOL, G_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_function_takes_the_blockwise_branch_above_the_limit(causal,
                                                             monkeypatch):
    monkeypatch.setattr(fa, "_BWD_MATERIALIZE_T_LIMIT", 63)
    calls = []
    real = fa._blockwise_attention_bwd

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(fa, "_blockwise_attention_bwd", spy)
    q, k, v = _qkv(1, 2, 64, 8, seed=8)
    g = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    got = _port_grads(q, k, v, g, causal)
    assert calls == [torch.Size([1, 2, 64, 8])]
    for a, r in zip(got, _jax_grads(q, k, v, g, causal)):
        _close(a, r, G_RTOL, G_ATOL)


def test_reference_attention_matches_jax():
    q, k, v = _qkv(2, 2, 10, 4, seed=10)
    mask = np.ones((2, 10), np.float32)
    mask[1, 6:] = 0.0
    for causal in (False, True):
        for m in (None, mask):
            got = attention(*_t(q, k, v), causal=causal,
                            mask=None if m is None else torch.from_numpy(m))
            ref = jax_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                mask=None if m is None else jnp.asarray(m))
            _close(got, ref)


def _mm_data(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, n) / np.sqrt(k)).astype(np.float32),
            (rng.randn(n) * 0.1).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


@pytest.mark.parametrize("activation", ["identity", "relu", "tanh"])
def test_residual_matmul_matches_jax_kernel(activation):
    x, w, b, r = _mm_data(32, 64, 128)
    dispatch.reset_launch_counts()
    got = matmul_block(*_t(x, w, b, r), activation=activation)
    ref = jax_mm_block(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       jnp.asarray(r), activation=activation, interpret=True)
    _close(got, ref)
    _close(matmul_block_reference(*_t(x, w, b, r), activation=activation),
           ref)
    assert sum(dispatch.launch_counts().values()) == 0


@pytest.mark.parametrize("activation", ["identity", "tanh"])
def test_residual_matmul_gradients_match_jax(activation):
    x, w, b, r = _mm_data(16, 32, 128, seed=1)
    g = np.random.RandomState(2).randn(16, 128).astype(np.float32)
    leaves = [a.requires_grad_(True) for a in _t(x, w, b, r)]
    out = matmul_block(*leaves, activation=activation)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda *a: jax_mm_block(*a, activation=activation,
                                             interpret=True),
                     *(jnp.asarray(a) for a in (x, w, b, r)))
    for a, ref in zip(got, vjp(jnp.asarray(g))):
        _close(a, ref, G_RTOL, G_ATOL)


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    def refuse():
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    q, k, v = _t(*_qkv(1, 2, 16, 8))
    x, w, b, r = _t(*_mm_data(4, 8, 16))
    flash_attention(q, k, v, causal=True)
    mha(q, k, v, causal=True)
    matmul_block(x, w, b, r)
    leaves = [a.requires_grad_(True) for a in (q, k, v)]
    flash_attention(*leaves, causal=True).sum().backward()


@pytest.mark.parametrize("d,element_size,plan", [
    (32, 4, (32, 128, 2, 90_112)),
    (64, 4, (64, 128, 1, 104_448)),
    (128, 4, (128, 256, 1, 169_984)),
    (100, 4, (128, 256, 1, 169_984)),
    (32, 2, (32, 128, 2, 73_728)),
    (64, 2, (64, 128, 2, 106_496)),
    (128, 2, (128, 256, 2, 172_032)),
])
def test_flash_smem_plan_pins_the_head_dims(d, element_size, plan):
    """The kernel's tile at each padded head dimension: q and p in f32
    (128 rows of dp + 4 and of 68), K and V tiles of 64 rows of dp
    elements + 16 bytes; two stages where two 128-thread blocks (d <= 64)
    or one 256-thread block (d 128) still fit an SM's 233,472 bytes,
    and never above the 232,448 a block has."""
    got = fa.flash_smem_plan(d, element_size)
    assert tuple(got) == plan
    assert got.smem_bytes <= fa.FLASH_SMEM_BYTES
    if got.threads == 128:
        assert 2 * (got.smem_bytes + 1024) <= 233_472
    dp = got.padded_d
    two = (4 * 128 * (dp + 4) + 4 * 128 * 68
           + 4 * 64 * (dp * element_size + 16))
    budget = 232_448 if got.threads == 256 else 233_472 // 2 - 1024
    assert (two <= budget) == (got.stages == 2)


def test_flash_smem_plan_refuses_head_dims_the_kernel_does_not_take():
    for d in (0, 129):
        with pytest.raises(ValueError, match="head dimension"):
            fa.flash_smem_plan(d)
