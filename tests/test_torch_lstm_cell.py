"""The port's LSTM ops (``deeplearning4j_tpu_torch/ops/lstm_cell.py``)
against the JAX package's, on the CPU.

The port's CPU route is the plain version of each CUDA kernel; the JAX
Pallas kernels run interpreted, as the JAX package's own tests run them
(``interpret=pallas_interpret()``). The same numpy inputs go to both.
Tolerances: ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5), the same
arithmetic with sums in other orders, on O(1) values; gradients through
up to 5 steps likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols, pallas_interpret
from deeplearning4j_tpu.ops import lstm_cell as jax_lstm_cell
from deeplearning4j_tpu.ops import lstm_cell_diff as jax_lstm_cell_diff
from deeplearning4j_tpu.ops.lstm_cell import (
    _lstm_sequence_bwd_call,
    _lstm_sequence_fwd_call,
    _reference_cell,
)
from deeplearning4j_tpu.ops.lstm_cell import lstm_sequence as jax_sequence
from deeplearning4j_tpu_torch.ops import (
    dispatch,
    lstm_cell,
    lstm_cell_diff,
    lstm_cell_reference,
    lstm_seq_bwd,
    lstm_seq_fwd,
    lstm_sequence,
)


def _close(got, ref, err_msg=""):
    rtol, atol = kernel_tols()
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _cell_data(b=4, n=12, seed=2, peephole=False):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, 4 * n), rng.randn(b, n), rng.randn(b, n),
            rng.randn(n, 4 * n) * 0.1]
    if peephole:
        arrs += [rng.randn(n) * 0.1 for _ in range(3)]
    return [a.astype(np.float32) for a in arrs]


def _seq_data(T=5, b=4, n=16, seed=0):
    rng = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        rng.randn(T, b, 4 * n) * 0.3, rng.randn(b, n) * 0.1,
        rng.randn(b, n) * 0.1, rng.randn(n, 4 * n) * 0.2)]


def _peeps(arrs, wrap):
    return tuple(wrap(a) for a in arrs[4:]) if len(arrs) > 4 else None


@pytest.mark.parametrize("peephole", [False, True])
def test_cell_matches_jax_kernel_and_reference(peephole):
    arrs = _cell_data(peephole=peephole)
    th = [torch.from_numpy(a) for a in arrs]
    jx = [jnp.asarray(a) for a in arrs]
    dispatch.reset_launch_counts()
    h, c = lstm_cell(*th[:4], _peeps(th, lambda t: t))
    assert sum(dispatch.launch_counts().values()) == 0  # the plain route
    h_k, c_k = jax_lstm_cell(*jx[:4], _peeps(jx, lambda t: t),
                             interpret=pallas_interpret())
    h_r, c_r = _reference_cell(*jx[:4], _peeps(jx, lambda t: t))
    for got, ref in ((h, h_k), (c, c_k), (h, h_r), (c, c_r)):
        _close(got, ref)
    h2, c2 = lstm_cell_reference(*th[:4], _peeps(th, lambda t: t))
    assert torch.equal(h, h2) and torch.equal(c, c2)


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("save_cseq", [True, False])
def test_sequence_forward_matches_jax_kernel(T, save_cseq):
    arrs = _seq_data(T=T)
    got = lstm_seq_fwd(*(torch.from_numpy(a) for a in arrs),
                       save_cseq=save_cseq)
    ref = _lstm_sequence_fwd_call(*(jnp.asarray(a) for a in arrs),
                                  pallas_interpret(), save_cseq=save_cseq)
    assert (got[1] is None) == (not save_cseq)
    for name, a, r in zip(("hseq", "cseq", "hT", "cT"), got, ref):
        if r is None:
            continue
        _close(a, r, name)


@pytest.mark.parametrize("T", [1, 5])
def test_sequence_backward_matches_jax_kernel(T):
    rng = np.random.RandomState(3)
    xproj, h0, c0, rw = _seq_data(T=T, seed=1)
    b, n = h0.shape
    hseq, cseq, _, _ = (np.asarray(a) for a in _lstm_sequence_fwd_call(
        jnp.asarray(xproj), jnp.asarray(h0), jnp.asarray(c0),
        jnp.asarray(rw), pallas_interpret()))
    hprev = np.concatenate([h0[None], hseq[:-1]])
    cprev = np.concatenate([c0[None], cseq[:-1]])
    dhseq = rng.randn(T, b, n).astype(np.float32)
    dhT, dcT = (rng.randn(b, n).astype(np.float32) for _ in range(2))
    args = (xproj, hprev, cprev, cseq, rw, dhseq, dhT, dcT)
    got = lstm_seq_bwd(*(torch.from_numpy(np.array(a)) for a in args))
    ref = _lstm_sequence_bwd_call(*(jnp.asarray(a) for a in args),
                                  pallas_interpret())
    for name, a, r in zip(("dgates", "dh0", "dc0"), got, ref):
        _close(a, r, name)


@pytest.mark.parametrize("T", [1, 5])
def test_sequence_gradients_match_jax_vjp(T):
    arrs = _seq_data(T=T, seed=4)
    b, n = arrs[1].shape
    rng = np.random.RandomState(5)
    cot = [rng.randn(T, b, n).astype(np.float32),
           rng.randn(b, n).astype(np.float32),
           rng.randn(b, n).astype(np.float32)]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    dispatch.reset_launch_counts()
    outs = lstm_sequence(*leaves)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cot])
    assert sum(dispatch.launch_counts().values()) == 0
    interp = pallas_interpret()
    _, vjp = jax.vjp(lambda *a: jax_sequence(*a, interp),
                     *(jnp.asarray(a) for a in arrs))
    ref = vjp(tuple(jnp.asarray(c) for c in cot))
    for name, leaf, r in zip(("dxproj", "dh0", "dc0", "drw"), leaves, ref):
        _close(leaf.grad, r, name)
    # without a gradient: the c_seq-free forward, the same values
    with torch.no_grad():
        plain = lstm_sequence(*(torch.from_numpy(a) for a in arrs))
    for a, r in zip(plain, outs):
        assert torch.equal(a, r.detach())


@pytest.mark.parametrize("peephole", [False, True])
def test_cell_diff_gradients_match_jax_vjp(peephole):
    arrs = _cell_data(b=3, n=8, seed=6, peephole=peephole)
    rng = np.random.RandomState(7)
    cot = [rng.randn(3, 8).astype(np.float32) for _ in range(2)]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    h, c = lstm_cell_diff(*leaves[:4], _peeps(leaves, lambda t: t))
    torch.autograd.backward((h, c), [torch.from_numpy(g) for g in cot])
    jx = [jnp.asarray(a) for a in arrs]
    _, vjp = jax.vjp(lambda *a: jax_lstm_cell_diff(
        *a[:4], tuple(a[4:]) if peephole else None), *jx)
    ref = vjp(tuple(jnp.asarray(g) for g in cot))
    names = ("dxproj", "dh", "dc", "drw", "dpI", "dpF", "dpO")
    for name, leaf, r in zip(names, leaves, ref):
        _close(leaf.grad, r, name)


def test_plain_versions_take_half_precision():
    arrs = _seq_data(T=3, b=2, n=8, seed=8)
    f32 = [torch.from_numpy(a) for a in arrs]
    bf = [t.bfloat16() for t in f32]
    got = lstm_seq_fwd(*bf)
    ref = lstm_seq_fwd(*(t.float() for t in bf))
    assert got[0].dtype == torch.bfloat16
    for a, r in zip(got, ref):
        torch.testing.assert_close(a.float(), r, rtol=2e-2, atol=2e-2)
    h, c = lstm_cell(bf[0][0], *bf[1:])
    assert h.dtype == c.dtype == torch.bfloat16


def test_sequence_shapes_are_checked():
    xproj, h0, c0, rw = (torch.from_numpy(a) for a in _seq_data(T=2))
    with pytest.raises(ValueError, match="4n"):
        lstm_sequence(xproj[:, :, :-1], h0, c0, rw)


# --- the sequence kernels' route rule (ops/lstm_cell.py lstm_seq_route) --
#
# Decided from the shape alone, so it is pinned here on the CPU: the
# char-RNN's chunk (T 50, b 32, n 200) and its T 1 sampling launch take
# the cluster route; bench.py's saturated shape (T 128, b 256, n 1024)
# and n 8500 keep the cooperative grid.

ROUTE_CASES = [
    ("charrnn.chunk", 50, 32, 200, "cluster"),
    ("charrnn.sample", 1, 1, 200, "cluster"),
    ("charrnn.output", 200, 4, 200, "cluster"),
    ("saturated", 128, 256, 1024, "grid"),
    ("wide", 2, 3, 8500, "grid"),
]


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("path,T,b,n,route", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_lstm_seq_route_pins_the_main_paths(path, T, b, n, route, bwd):
    from deeplearning4j_tpu_torch.ops.lstm_cell import lstm_seq_route

    assert lstm_seq_route(T, b, n, bwd).route == route


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 16, 17, 32, 33, 64, 65, 128,
                               129, 256, 300])
def test_lstm_cluster_plans_fit_and_cover_b(b, bwd):
    from deeplearning4j_tpu_torch.ops.lstm_cell import (
        LSTM_CLUSTER_SLOTS,
        MAX_SMEM_BYTES,
        lstm_cluster_smem_bytes,
        lstm_seq_route,
    )

    for n in (1, 8, 13, 17, 40, 200, 201, 255, 256):
        r = lstm_seq_route(50, b, n, bwd)
        assert r.route == "cluster", n
        assert r.smem_bytes == lstm_cluster_smem_bytes(n, r.cluster, r.rows,
                                                       bwd)
        assert r.smem_bytes <= MAX_SMEM_BYTES
        # the clusters cover b, none of them empty
        assert (r.clusters - 1) * r.rows < b <= r.clusters * r.rows
        # the fewest rows a cluster that keep one wave of clusters
        assert r.clusters <= LSTM_CLUSTER_SLOTS or r.rows == 8
        assert r.rows == 1 or -(-b // (r.rows // 2)) > LSTM_CLUSTER_SLOTS
        # rows x units owner threads in a block of 256
        u = -(-n // r.cluster)
        assert r.rows * u <= 256
        # every block owns a unit, at the units a block of 8 would have
        assert (r.cluster - 1) * u < n and u == -(-n // 8)


@pytest.mark.parametrize("n,blocks", [(1, 1), (8, 8), (9, 5), (13, 7),
                                      (17, 6), (33, 7), (41, 7), (49, 7),
                                      (200, 8), (201, 8), (256, 8)])
def test_lstm_cluster_blocks_leave_no_block_empty(n, blocks):
    from deeplearning4j_tpu_torch.ops.lstm_cell import (
        lstm_cluster_blocks,
        lstm_seq_route,
    )

    assert lstm_cluster_blocks(n) == blocks
    for bwd in (False, True):
        assert lstm_seq_route(50, 32, n, bwd).cluster == blocks


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("b", [1, 32, 256])
def test_lstm_seq_route_turns_grid_past_its_limit(b, bwd):
    from deeplearning4j_tpu_torch.ops.lstm_cell import (
        LSTM_CLUSTER,
        LSTM_CLUSTER_MAX_UNITS,
        lstm_seq_route,
    )

    limit = LSTM_CLUSTER * LSTM_CLUSTER_MAX_UNITS  # 256
    assert lstm_seq_route(1, b, limit, bwd).route == "cluster"
    assert lstm_seq_route(1, b, limit + 1, bwd).route == "grid"
    assert lstm_seq_route(1, b, limit + 1, bwd).smem_bytes == 0


# The cell's routes (lstm_cell_route), decided from the shape alone: the
# char-RNN's step (b 32, n 200) and its sampling launch (b 1) take the
# latency route, 100 blocks of 2 units; bench.py's saturated shape (b
# 256, n 1024) and n 8500 keep the slice route. The shapes are those of
# the card tests' LSTM_CELL_CASES.
CELL_CASES = [(32, 200), (256, 1024), (5, 13), (33, 17), (70, 9), (1, 200),
              (300, 40), (3, 8500)]


@pytest.mark.parametrize("b,n", CELL_CASES)
def test_lstm_cell_route_covers_every_unit_and_row(b, n):
    from deeplearning4j_tpu_torch.ops.lstm_cell import (
        CELL_MAX_SPLITS,
        CELL_MAX_THREADS,
        CELL_SMEM_BYTES,
        lstm_cell_route,
        lstm_cell_smem_bytes,
    )

    r = lstm_cell_route(b, n)
    if (b, n) in ((256, 1024), (3, 8500)):
        assert r.route == "slice" and r.smem_bytes == 0
        assert lstm_cell_smem_bytes(n, min(b, 32), 2) > CELL_SMEM_BYTES
        return
    assert r.route == "latency"
    # the grid covers every unit and row, and no block is empty
    assert (r.unit_blocks - 1) * r.units < n <= r.unit_blocks * r.units
    assert (r.row_blocks - 1) * r.rows < b <= r.row_blocks * r.rows
    # a (row, unit)'s depth lanes: a power of two within one warp, the
    # most that fit the block
    assert r.splits & (r.splits - 1) == 0 and r.splits <= CELL_MAX_SPLITS
    assert r.rows * r.units * r.splits <= CELL_MAX_THREADS
    assert (r.splits == CELL_MAX_SPLITS
            or r.rows * r.units * r.splits * 2 > CELL_MAX_THREADS)
    assert r.threads == CELL_MAX_THREADS
    # h rows at a 16-byte stride, then the block's 4 x units RW columns
    assert r.smem_bytes == 4 * (r.rows * (-(-n // 4) * 4) + n * r.units * 4)
    assert r.smem_bytes == lstm_cell_smem_bytes(n, r.rows, r.units)
    assert r.smem_bytes <= CELL_SMEM_BYTES


def test_lstm_cell_route_spreads_the_char_rnn_step():
    from deeplearning4j_tpu_torch.ops.lstm_cell import lstm_cell_route

    step = lstm_cell_route(32, 200)
    assert (step.route, step.unit_blocks * step.row_blocks, step.threads,
            step.splits) == ("latency", 100, 256, 4)
    sample = lstm_cell_route(1, 200)
    assert (sample.route, sample.unit_blocks, sample.threads,
            sample.splits) == ("latency", 100, 256, 32)
