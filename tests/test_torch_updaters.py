"""The port's updaters (``deeplearning4j_tpu_torch.nn.updaters``)
against the JAX package's, on the CPU: every update rule over several
steps, every gradient normalization, every learning-rate policy, the
bias learning rate and the network-wide ``MultiLayerUpdaterDef``, on the
same numpy gradients. Tolerance: f32 elementwise math in both, rtol
1e-5 and atol 5e-6: Adam's bias correction ``1 - 0.999**t`` cancels, so
one ulp of difference between the two libraries' f32 ``pow`` is 2e-5
of the step at t = 3, about 1e-6 at lr 0.05, over five steps. The
schedules are host floats and match exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import updaters as jax_upd
from deeplearning4j_tpu_torch.nn import updaters

RULES = ["SGD", "NONE", "NESTEROVS", "ADAGRAD", "RMSPROP", "ADAM",
         "ADADELTA"]
NORMS = ["None", "RenormalizeL2PerLayer", "RenormalizeL2PerParamType",
         "ClipElementWiseAbsoluteValue", "ClipL2PerLayer",
         "ClipL2PerParamType"]


def _grads(step, shape=(4, 3)):
    rng = np.random.RandomState(100 + step)
    return {"W": (rng.randn(*shape) * 0.7).astype(np.float32),
            "b": (rng.randn(shape[1]) * 0.7).astype(np.float32)}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=5e-6)


def _run_both(settings, steps, lr_of=lambda i: 0.05):
    """Five (say) steps of one layer through both packages'
    MultiLayerUpdaterDef; returns the final params and state of each."""
    rng = np.random.RandomState(0)
    p0 = {"W": rng.randn(4, 3).astype(np.float32),
          "b": rng.randn(3).astype(np.float32)}
    jdef = jax_upd.MultiLayerUpdaterDef(
        {"0": jax_upd.UpdaterSettings(**dataclasses.asdict(settings))})
    tdef = updaters.MultiLayerUpdaterDef({"0": settings})
    jp = {"0": {k: jnp.asarray(v) for k, v in p0.items()}}
    tp = {"0": {k: torch.from_numpy(v.copy()) for k, v in p0.items()}}
    js, ts = jdef.init(jp), tdef.init(tp)
    for i in range(steps):
        g = _grads(i)
        lr = lr_of(i)
        jp, js = jdef.update({"0": {k: jnp.asarray(v) for k, v in g.items()}},
                             js, jp, {"0": jnp.asarray(lr, jnp.float32)},
                             jnp.asarray(i + 1, jnp.float32))
        tp, ts = tdef.update({"0": {k: torch.from_numpy(v)
                                    for k, v in g.items()}},
                             ts, tp, {"0": lr}, i + 1)
    return (jp, js), (tp, ts)


def _compare(jax_out, port_out):
    (jp, js), (tp, ts) = jax_out, port_out
    for k in ("W", "b"):
        _close(tp["0"][k].numpy(), jp["0"][k])
        assert len(ts["0"][k]) == len(js["0"][k])
        for a, b in zip(ts["0"][k], js["0"][k]):
            _close(a.numpy(), b)


@pytest.mark.parametrize("rule", RULES)
def test_update_rule_matches_jax_over_steps(rule):
    s = updaters.UpdaterSettings(updater=rule, learning_rate=0.05,
                                 momentum=0.8, rho=0.9, rms_decay=0.9,
                                 epsilon=1e-6)
    _compare(*_run_both(s, 5))


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("rule", ["SGD", "ADAM"])
def test_gradient_normalization_matches_jax(norm, rule):
    s = updaters.UpdaterSettings(updater=rule, learning_rate=0.05,
                                 gradient_normalization=norm,
                                 gradient_normalization_threshold=0.5)
    _compare(*_run_both(s, 3))


def test_bias_learning_rate_scales_only_the_bias():
    s = updaters.UpdaterSettings(updater="NESTEROVS", learning_rate=0.05,
                                 bias_learning_rate=0.5)
    jax_out, port_out = _run_both(s, 3)
    _compare(jax_out, port_out)
    plain = _run_both(dataclasses.replace(s, bias_learning_rate=None), 3)[1]
    assert torch.equal(port_out[0]["0"]["W"], plain[0]["0"]["W"])
    assert not torch.equal(port_out[0]["0"]["b"], plain[0]["0"]["b"])


POLICIES = [
    dict(lr_policy="None"),
    dict(lr_policy="Score"),
    dict(lr_policy="Exponential", lr_policy_decay_rate=0.9),
    dict(lr_policy="Inverse", lr_policy_decay_rate=0.1, lr_policy_power=0.75),
    dict(lr_policy="Poly", lr_policy_power=2.0, max_num_iterations=7),
    dict(lr_policy="Sigmoid", lr_policy_decay_rate=0.5, lr_policy_steps=3),
    dict(lr_policy="Step", lr_policy_decay_rate=0.5, lr_policy_steps=2),
    dict(lr_policy="TorchStep", lr_policy_decay_rate=0.5, lr_policy_steps=6),
    dict(lr_policy="Schedule", lr_schedule={"0": 0.3, "2": 0.2, 5: 0.01}),
]


@pytest.mark.parametrize("policy", POLICIES,
                         ids=[p["lr_policy"] for p in POLICIES])
def test_lr_policy_matches_jax(policy):
    s = updaters.UpdaterSettings(learning_rate=0.1, **policy)
    js = jax_upd.UpdaterSettings(learning_rate=0.1, **policy)
    got = [updaters.scheduled_lr(s, i) for i in range(10)]
    assert got == [jax_upd.scheduled_lr(js, i) for i in range(10)]
    # and through the network-wide schedule into the update
    tdef = updaters.MultiLayerUpdaterDef({"a": s, "b": s})
    assert tdef.scheduled_lrs(4) == {"a": got[4], "b": got[4]}


def test_scheduled_lrs_drive_the_trajectory():
    s = updaters.UpdaterSettings(updater="ADAM", learning_rate=0.1,
                                 lr_policy="Exponential",
                                 lr_policy_decay_rate=0.7)
    _compare(*_run_both(s, 4, lr_of=lambda i: updaters.scheduled_lr(s, i)))


def test_unknown_rule_policy_and_normalization_raise():
    p = torch.zeros(2)
    with pytest.raises(ValueError, match="Unknown updater"):
        updaters.init_param_state(updaters.UpdaterSettings(updater="X"), p)
    with pytest.raises(ValueError, match="Unknown LR policy"):
        updaters.scheduled_lr(updaters.UpdaterSettings(lr_policy="X"), 1)
    with pytest.raises(ValueError, match="Unknown gradient normalization"):
        updaters.normalize_layer_grads(
            updaters.UpdaterSettings(gradient_normalization="X"), {"W": p})


def test_update_keeps_inputs_and_dtypes():
    s = updaters.UpdaterSettings(updater="ADAM", learning_rate=0.1)
    tdef = updaters.MultiLayerUpdaterDef({"0": s, "1": s})
    params = {"0": {"W": torch.ones(3, dtype=torch.float64)}, "1": {}}
    state = tdef.init(params)
    assert state["1"] == {}
    g = {"0": {"W": torch.full((3,), 0.5, dtype=torch.float64)}, "1": {}}
    new_p, new_s = tdef.update(g, state, params, {"0": 0.1, "1": 0.1}, 1)
    assert torch.equal(params["0"]["W"], torch.ones(3, dtype=torch.float64))
    assert torch.equal(state["0"]["W"][0], torch.zeros(3, dtype=torch.float64))
    assert new_p["0"]["W"].dtype == torch.float64
    assert new_s["0"]["W"][1].dtype == torch.float64
    np.testing.assert_allclose(new_p["0"]["W"].numpy(), 0.9)
