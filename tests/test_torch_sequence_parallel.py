"""The port's ring attention (``parallel/sequence.py``) and the
attention layers' ring path on the CPU, against the JAX package's ring
over a ``seq`` mesh of 4 of conftest's virtual devices.

One gloo world of four port ranks (``tests/torch_world.py``) runs every
case of this module on the same numpy inputs: JAX
``tests/test_sequence_parallel.py``'s cases at ``seq`` 4 (causal and
not, a key mask, the gradients of ``sum(out ** 2)`` through the ring,
a longer sequence) and JAX ``tests/test_transformer.py``'s
``TransformerBlock`` over the sharded sequence, forward and the
gradients of its weights. A bad mesh raises on both sides.

Tolerance: ``kernel_tols()`` (JAX's own ring tests hold rtol 2e-4 /
atol 2e-5; its 8-way case 3e-4 / 3e-5, which the longer case here keeps).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import kernel_tols
from deeplearning4j_tpu.nn.layers import TransformerBlock as JBlock
from deeplearning4j_tpu.parallel import attention as jattention
from deeplearning4j_tpu.parallel import build_seq_mesh as jbuild_seq_mesh
from deeplearning4j_tpu.parallel import ring_attention as jring_attention
from deeplearning4j_tpu.parallel import (
    ring_self_attention_sharded as jring_sharded,
)
from deeplearning4j_tpu.parallel.sequence import _shard_map
from deeplearning4j_tpu_torch.parallel.sequence import build_seq_mesh
from torch_world import RankWorld, save_arrays

SEQ = 4

_SCRIPT = r"""
from deeplearning4j_tpu_torch.nn.layers import TransformerBlock
from deeplearning4j_tpu_torch.parallel.sequence import (
    build_seq_mesh, ring_attention, ring_self_attention_sharded)
import torch.distributed as dist

mesh = build_seq_mesh(data=1, seq=WORLD)
d = {k: torch.from_numpy(v) for k, v in np.load(spec["data"]).items()}
for causal in (False, True):
    OUT[f"plain{int(causal)}"] = ring_self_attention_sharded(
        mesh, d["q"], d["k"], d["v"], causal=causal).numpy()
OUT["masked"] = ring_self_attention_sharded(
    mesh, d["q"], d["k"], d["v"], causal=False, mask=d["mask"]).numpy()
OUT["long"] = ring_self_attention_sharded(
    mesh, d["lq"], d["lk"], d["lv"], causal=True).numpy()
# the gradients through the ring: each rank's shard, its loss its rows'
tl = d["gq"].shape[2] // WORLD
mine = [d[k][:, :, RANK * tl:(RANK + 1) * tl].clone().requires_grad_()
        for k in ("gq", "gk", "gv")]
out = ring_attention(*mine, axis_name="seq", axis_size=WORLD, causal=True)
(out ** 2).sum().backward()
for name, t in zip("qkv", mine):
    OUT["grad_" + name] = t.grad.numpy()
# the transformer block on this rank's time shard, forward and backward
blk = TransformerBlock(n_in=8, n_out=8, n_heads=2, causal=True,
                       seq_axis="seq", seq_axis_size=WORLD)
params = {k[2:]: torch.from_numpy(v).requires_grad_()
          for k, v in np.load(spec["block"]).items()}
tl = d["bx"].shape[2] // WORLD
y, _ = blk.apply(params, d["bx"][:, :, RANK * tl:(RANK + 1) * tl], {})
OUT["block"] = y.detach().numpy()
(y ** 2).sum().backward()
for k, p in params.items():
    g = p.grad.clone()
    dist.all_reduce(g)  # the weights are replicated over the seq ranks
    OUT["bgrad_" + k] = g.numpy()
save()
shutdown_distributed()
"""


def _qkv(b=2, h=2, t=16, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def seq_world(tmp_path_factory):
    run = tmp_path_factory.mktemp("seq")
    q, k, v = _qkv()
    lq, lk, lv = _qkv(b=1, h=4, t=64, d=16, seed=9)
    gq, gk, gv = _qkv(b=1, h=1, t=8, d=4, seed=3)
    mask = (np.arange(16)[None, :] < np.array([[11], [16]])).astype(
        np.float32)
    bx = np.random.RandomState(1).randn(2, 8, 4 * SEQ).astype(np.float32)
    blk = JBlock(n_in=8, n_out=8, n_heads=2, causal=True)
    bparams = blk.init_params(jax.random.PRNGKey(0))
    data = dict(q=q, k=k, v=v, lq=lq, lk=lk, lv=lv, gq=gq, gk=gk, gv=gv,
                mask=mask, bx=bx)
    world = RankWorld.start(run, SEQ, _SCRIPT, dict(
        data=save_arrays(run / "data.npz", data),
        block=save_arrays(run / "block.npz", {
            "p:" + n: np.asarray(a) for n, a in bparams.items()})))
    try:
        want = _jax_side(data, blk, bparams)
        results = world.wait()
    finally:
        world.kill()
    return results, want


def _jax_side(d, blk, bparams):
    """The JAX ring on a seq mesh of 4, and the unsharded references."""
    from jax.sharding import PartitionSpec as P

    mesh = jbuild_seq_mesh(data=1, seq=SEQ, devices=jax.devices()[:SEQ])
    j = {k: jnp.asarray(v) for k, v in d.items()}
    want = {}
    for causal in (False, True):
        want[f"plain{int(causal)}"] = np.asarray(jring_sharded(
            mesh, j["q"], j["k"], j["v"], causal=causal))
        want[f"ref{int(causal)}"] = np.asarray(jattention(
            j["q"], j["k"], j["v"], causal=causal))
    want["masked"] = np.asarray(jring_sharded(
        mesh, j["q"], j["k"], j["v"], causal=False, mask=j["mask"]))
    want["long"] = np.asarray(jring_sharded(
        mesh, j["lq"], j["lk"], j["lv"], causal=True))
    spec = P(None, None, "seq", None)
    ring = _shard_map()(
        partial(jring_attention, axis_name="seq", axis_size=SEQ,
                causal=True),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_rep=False)
    grads = jax.grad(lambda a, b, c: jnp.sum(ring(a, b, c) ** 2),
                     argnums=(0, 1, 2))(j["gq"], j["gk"], j["gv"])
    for name, g in zip("qkv", grads):
        want["grad_" + name] = np.asarray(g)
    out, _ = blk.apply(bparams, j["bx"], {})
    want["block"] = np.asarray(out)
    bgrads = jax.grad(lambda p: jnp.sum(blk.apply(p, j["bx"], {})[0] ** 2))(
        bparams)
    want.update({"bgrad_" + n: np.asarray(g) for n, g in bgrads.items()})
    return want


def _gathered(results, key, axis=2):
    return np.concatenate([r[key] for r in results], axis=axis)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring_and_single_device(seq_world, causal):
    rtol, atol = kernel_tols()
    results, want = seq_world
    for res in results:  # every rank gathers the whole sequence
        np.testing.assert_allclose(res[f"plain{int(causal)}"],
                                   want[f"plain{int(causal)}"], rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(res[f"plain{int(causal)}"],
                                   want[f"ref{int(causal)}"], rtol=rtol,
                                   atol=atol)


def test_ring_with_key_mask(seq_world):
    rtol, atol = kernel_tols()
    results, want = seq_world
    np.testing.assert_allclose(results[0]["masked"], want["masked"],
                               rtol=rtol, atol=atol)


def test_ring_longer_sequence(seq_world):
    results, want = seq_world
    np.testing.assert_allclose(results[3]["long"], want["long"], rtol=3e-4,
                               atol=3e-5)


def test_ring_gradients_match(seq_world):
    """The reverse hops carry each shard's K/V gradient home."""
    rtol, atol = kernel_tols()
    results, want = seq_world
    for name in "qkv":
        np.testing.assert_allclose(_gathered(results, "grad_" + name),
                                   want["grad_" + name], rtol=rtol,
                                   atol=atol, err_msg=name)


def test_transformer_block_over_the_seq_axis(seq_world):
    """JAX ``test_transformer_ring_attention_long_context``: the block on
    the sharded sequence equals the unsharded block, forward and the
    gradients of its weights."""
    results, want = seq_world
    np.testing.assert_allclose(_gathered(results, "block"), want["block"],
                               rtol=2e-4, atol=2e-5)
    rtol, atol = kernel_tols()
    for k in [k for k in want if k.startswith("bgrad_")]:
        np.testing.assert_allclose(results[0][k], want[k], rtol=rtol,
                                   atol=atol, err_msg=k)


def test_bad_mesh_shape_raises():
    with pytest.raises(ValueError):
        jbuild_seq_mesh(data=3, seq=3)  # 9 > 8 devices
    with pytest.raises(ValueError, match="devices"):
        build_seq_mesh(data=3, seq=3, devices=8)
