"""The port's GPipe schedule (``parallel/pipeline.py``) on the CPU,
against the JAX package's GPipe over a ``pipe`` mesh of conftest's
virtual devices and the serial composition of the stages (JAX
``tests/test_pipeline.py``'s cases).

One gloo world of four port ranks (``tests/torch_world.py``) runs every
case: the forward at stages x microbatches (2, 4) and (4, 4) (the ranks
past a two-stage pipeline join only its group's forming), the
per-stage gradients of a loss on the output, two SGD steps against
JAX's ``train_step``, sixty steps that must lower the loss, and the
microbatch divisibility error. Tolerances: JAX's own (forward rtol
1e-5 / atol 1e-6, gradients 1e-4 / 1e-6); the SGD steps
``kernel_tols()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import kernel_tols
from deeplearning4j_tpu.parallel.pipeline import GPipe as JGPipe
from deeplearning4j_tpu.parallel.pipeline import (
    build_pipe_mesh as jbuild_pipe_mesh,
)
from deeplearning4j_tpu_torch.parallel.pipeline import build_pipe_mesh
from torch_world import RankWorld, save_arrays

D = 8
WORLD = 4

_SCRIPT = r"""
from deeplearning4j_tpu_torch.parallel.pipeline import GPipe, build_pipe_mesh

d = dict(np.load(spec["data"]))


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def mse(out, y):
    return torch.mean((out - y) ** 2)


for n_stages, n_micro in ((2, 4), (4, 4)):
    mesh = build_pipe_mesh(n_stages)
    if mesh.stage is None:
        continue
    pipe = GPipe(mesh, stage_fn, n_micro=n_micro)
    params = pipe.shard_params({"w": d[f"w{n_stages}"],
                                "b": d[f"b{n_stages}"]})
    OUT[f"fwd{n_stages}"] = pipe.apply(params, d["x"]).numpy()
    if n_stages == 2:
        try:
            GPipe(mesh, stage_fn, n_micro=3).apply(params, d["x"])
        except ValueError as e:
            OUT["divisible"] = np.asarray(str(e))
        continue
    # the gradients of a loss on the output: each rank its own stage's
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    mse(pipe.apply(p, d["x"]), torch.from_numpy(d["y"])).backward()
    OUT["gw"], OUT["gb"] = p["w"].grad.numpy(), p["b"].grad.numpy()
    q = params
    losses = []
    for i in range(60):
        q, loss = pipe.train_step(q, d["tx"], d["ty"], mse, lr=0.2)
        losses.append(float(loss))
        if i == 1:
            OUT["sgd_w"], OUT["sgd_b"] = q["w"].numpy(), q["b"].numpy()
    OUT["losses"] = np.asarray(losses)
save()
shutdown_distributed()
"""


def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _make_params(rng, n_stages):
    return {
        "w": rng.randn(n_stages, D, D).astype(np.float32) * 0.3,
        "b": rng.randn(n_stages, D).astype(np.float32) * 0.1,
    }


def _serial(params, x):
    for i in range(params["w"].shape[0]):
        x = _stage_fn({"w": params["w"][i], "b": params["b"][i]}, x)
    return x


def _mse(out, y):
    return jnp.mean((out - y) ** 2)


@pytest.fixture(scope="module")
def pipe_world(tmp_path_factory):
    run = tmp_path_factory.mktemp("pipe")
    rng = np.random.RandomState(0)
    p2, p4 = _make_params(rng, 2), _make_params(rng, 4)
    x = rng.randn(8, D).astype(np.float32)
    y = rng.randn(8, D).astype(np.float32)
    tx = rng.randn(16, D).astype(np.float32)
    ty = np.tanh(tx @ rng.randn(D, D).astype(np.float32) * 0.5)
    data = dict(w2=p2["w"], b2=p2["b"], w4=p4["w"], b4=p4["b"], x=x, y=y,
                tx=tx, ty=ty)
    world = RankWorld.start(run, WORLD, _SCRIPT, dict(
        data=save_arrays(run / "data.npz", data)))
    try:
        want = {}
        for n_stages, p in ((2, p2), (4, p4)):
            mesh = jbuild_pipe_mesh(n_stages)
            pipe = JGPipe(mesh, _stage_fn, n_micro=4)
            want[f"fwd{n_stages}"] = np.asarray(
                pipe.apply(pipe.shard_params(p), x))
            want[f"serial{n_stages}"] = np.asarray(
                _serial(p, jnp.asarray(x)))
        mesh = jbuild_pipe_mesh(4)
        pipe = JGPipe(mesh, _stage_fn, n_micro=4)
        apply = pipe._build_apply()
        grads = jax.grad(lambda q: _mse(apply(q, jnp.asarray(x)),
                                        jnp.asarray(y)))(
            pipe.shard_params(p4))
        want["gw"], want["gb"] = np.asarray(grads["w"]), np.asarray(
            grads["b"])
        q = pipe.shard_params(p4)
        for _ in range(2):
            q, _ = pipe.train_step(q, tx, ty, _mse, lr=0.2)
        want["sgd_w"], want["sgd_b"] = np.asarray(q["w"]), np.asarray(q["b"])
        results = world.wait()
    finally:
        world.kill()
    return results, want


@pytest.mark.parametrize("n_stages", [2, 4])
def test_gpipe_forward_matches_jax_and_serial(pipe_world, n_stages):
    results, want = pipe_world
    for res in results[:n_stages]:  # every stage gets the output
        np.testing.assert_allclose(res[f"fwd{n_stages}"],
                                   want[f"fwd{n_stages}"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res[f"fwd{n_stages}"],
                                   want[f"serial{n_stages}"], rtol=1e-5,
                                   atol=1e-6)


def test_gpipe_gradients_match(pipe_world):
    """Each rank's gradient is its stage's of the JAX pipeline's."""
    results, want = pipe_world
    for i, res in enumerate(results):
        np.testing.assert_allclose(res["gw"], want["gw"][i], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(res["gb"], want["gb"][i], rtol=1e-4,
                                   atol=1e-6)


def test_gpipe_train_step_matches_jax_and_reduces_loss(pipe_world):
    rtol, atol = kernel_tols()
    results, want = pipe_world
    for i, res in enumerate(results):
        np.testing.assert_allclose(res["sgd_w"], want["sgd_w"][i],
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(res["sgd_b"], want["sgd_b"][i],
                                   rtol=rtol, atol=atol)
        np.testing.assert_array_equal(res["losses"], results[0]["losses"])
    losses = results[0]["losses"]
    assert losses[-1] < losses[0] * 0.6


def test_gpipe_validates_batch_divisibility(pipe_world):
    results, _ = pipe_world
    assert "not divisible by n_micro=3" in str(results[0]["divisible"])


def test_build_pipe_mesh_requires_devices():
    with pytest.raises(ValueError, match="devices"):
        jbuild_pipe_mesh(99)
    with pytest.raises(ValueError, match="devices"):
        build_pipe_mesh(99)
