"""The divergence guard and the statistical guard in the port against
the JAX package (``resilience/guard.py``), on the CPU.

- ``stat_guard_update`` on one sequence of scores and gradient norms
  (warm-up, clean steps, a spike, a z-score trip, a non-finite step):
  the same trip decisions and EWMA state as JAX's, to f32 rounding.
- A guarded ``fit`` on both engines: a NaN-poisoned minibatch and a
  statistically anomalous one leave the parameters, the updater state
  and the layer state (BatchNormalization's running statistics)
  bitwise unchanged, in both packages; the guard's counts and skipped
  iterations are JAX's, and training goes on.
- The host policy: ``max_consecutive`` bad steps raise; ``rollback``
  raises at construction, naming ``resilience/checkpoint.py`` (not
  ported), and never runs as ``skip``.
- The manifest doc of the guard's state round-trips bitwise.
- ``DistributedTrainer`` on 2 gloo ranks with f16 loss scaling and the
  guard (with its statistical half) against the JAX package's trainer on
  ``build_mesh(data=2)``: scores, loss-scale states and guard decisions.

Tolerances: scores and weights of the clean steps at ``kernel_tols()``
(f32: rtol 2e-4, atol 2e-5; f16 compute: rtol 2e-3, atol 1e-3), the
EWMA state at rtol 1e-5 (f32 sums of scores that differ in their last
bits), the decisions and loss-scale states exactly.
"""

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.datasets.api import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.parallel import DistributedTrainer as JTrainer
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu.resilience import guard as jguard
from deeplearning4j_tpu.zoo import lenet as jlenet
from deeplearning4j_tpu.zoo import resnet50 as jresnet50
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.exceptions import DL4JFaultException
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience import guard
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 180
EWMA_RTOL = 1e-5
SG = dict(alpha=0.2, z_threshold=4.0, spike_factor=5.0, warmup=3)


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _sg_np(state):
    return {k: np.asarray(state[k].numpy() if torch.is_tensor(state[k])
                          else state[k]) for k in guard.STAT_STATE_KEYS}


def _assert_sg_close(port_state, jax_state):
    got, want = _sg_np(port_state), _sg_np(jax_state)
    for k in guard.STAT_STATE_KEYS:
        assert got[k].dtype == want[k].dtype, k
        if k in ("count", "trips_loss", "trips_gnorm"):
            assert int(got[k]) == int(want[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=EWMA_RTOL,
                                       atol=0, err_msg=k)


def test_stat_guard_update_matches_jax_on_one_sequence():
    cfg = guard.StatGuardConfig(**SG)
    jcfg = jguard.StatGuardConfig(**SG)
    # warm-up, clean steps, a loss spike, a grad-norm z trip, a NaN
    seq = [(2.3, 1.0), (2.2, 1.1), (2.1, 0.9), (2.05, 1.0), (2.0, 1.05),
           (30.0, 1.0), (1.95, 0.98), (1.9, 9.0), (float("nan"), 1.0),
           (1.85, 1.02), (1.8, 1.0)]
    st, jst = guard.stat_guard_state(), jguard.stat_guard_state()
    oks = []
    for loss, gn in seq:
        finite = math.isfinite(loss) and math.isfinite(gn)
        ok, st = guard.stat_guard_update(
            st, cfg, torch.tensor(loss), torch.tensor(gn),
            torch.tensor(finite))
        jok, jst = jguard.stat_guard_update(
            jst, jcfg, jnp.float32(loss), jnp.float32(gn),
            jnp.asarray(finite))
        assert bool(ok) == bool(jok), (loss, gn)
        oks.append(bool(ok))
        _assert_sg_close(st, jst)
    assert oks == [True] * 5 + [False, True, False, True, True, True]
    assert int(st["trips_loss"]) == 1 and int(st["trips_gnorm"]) == 1
    assert int(st["count"]) == 8  # the trips and the NaN are not folded


def test_guard_state_doc_round_trips_bitwise():
    cfg = guard.StatGuardConfig(**SG)
    st = guard.stat_guard_state()
    for loss, gn in ((2.3, 1.0), (2.25, 1.1), (2.2, 1.3)):
        _, st = guard.stat_guard_update(st, cfg, torch.tensor(loss),
                                        torch.tensor(gn), torch.tensor(True))
    doc = guard.stat_guard_state_doc(st)
    assert json.loads(json.dumps(doc)) == doc
    back = guard.stat_guard_state_from_doc(doc)
    for k in guard.STAT_STATE_KEYS:
        assert back[k].dtype == st[k].dtype and torch.equal(back[k], st[k])
    # the JAX package reads the same doc to the same f32 bits
    jback = jguard.stat_guard_state_from_doc(doc)
    for k in guard.STAT_STATE_KEYS:
        np.testing.assert_array_equal(np.asarray(jback[k]), back[k].numpy())

    class Model:
        pass

    m = Model()
    m.divergence_guard = guard.DivergenceGuard("skip", stats=cfg)
    m.divergence_guard.skipped_batches = [3, 7]
    m.divergence_guard.skipped_steps = 2
    m._stat_guard_state = st
    doc = guard.guard_state_doc(m)
    m2 = Model()
    m2.divergence_guard = guard.DivergenceGuard("skip", stats=cfg)
    m2.device = torch.device("cpu")
    guard.apply_guard_state_doc(m2, doc)
    assert m2.divergence_guard.skipped_batches == [3, 7]
    assert m2.divergence_guard.skipped_steps == 2
    assert all(torch.equal(m2._stat_guard_state[k], st[k])
               for k in guard.STAT_STATE_KEYS)


def test_guard_policy_limits():
    with pytest.raises(NotImplementedError, match="resilience/checkpoint"):
        guard.DivergenceGuard("rollback")
    with pytest.raises(NotImplementedError, match="resilience/checkpoint"):
        guard.DivergenceGuard("skip", checkpoint_manager=object())
    with pytest.raises(ValueError, match="policy"):
        guard.DivergenceGuard("retry")
    with pytest.raises(ValueError, match="stats"):
        guard.DivergenceGuard(stats=1)
    g = guard.DivergenceGuard(max_consecutive=2)

    class Model:
        iteration_count = 5

    g.bad_step(Model())
    g.bad_step(Model())
    with pytest.raises(DL4JFaultException, match="consecutive"):
        g.bad_step(Model())
    assert g.skipped_batches == [4, 4, 4]


# -- guarded fit on both engines ---------------------------------------------


def _snapshot(model):
    """Host copies of every parameter, updater moment and layer state
    leaf of either package's model."""
    def leaves(tree):
        out = {}
        for ln, lp in tree.items():
            for k, v in lp.items():
                for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
                    out[f"{ln}/{k}/{i}"] = np.array(
                        t.detach().numpy() if torch.is_tensor(t) else t)
        return out
    return (leaves(model.params), leaves(model.updater_state),
            leaves({ln: st for ln, st in model.state.items() if st}))


def _assert_unchanged(before, after, tag):
    for b, a in zip(before, after):
        assert b.keys() == a.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{tag} {k}")


def _lenet_pair():
    jnet = JMultiLayerNetwork(jlenet(dense_width=16,
                                     updater="NESTEROVS")).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jnet.conf.to_dict()), device="cpu").init(
            params=params_from_numpy(_flat(jnet.params), "cpu"))
    return jnet, net


def _graph_pair():
    kw = dict(height=8, width=8, channels=1, n_classes=3, cifar_stem=True,
              depths=(1, 1), base_width=4, learning_rate=0.01)
    jg = JGraph(jresnet50(**kw)).init()
    g = ComputationGraph(ComputationGraphConfiguration.from_dict(
        jg.conf.to_dict()), device="cpu").init(
            params=params_from_numpy(_flat(jg.params), "cpu"))
    return jg, g


def _batches(engine, n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if engine == "multilayer":
            x = (rng.rand(16, 784) * 0.9 + 0.05).astype(np.float32)
            y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 16)]
        else:
            x = (rng.rand(8, 1, 8, 8) * 0.9 + 0.05).astype(np.float32)
            y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)]
        out.append((x, y))
    return out


@pytest.mark.parametrize("engine", ["multilayer", "graph"])
def test_guarded_fit_skips_bad_steps_bitwise_as_jax(engine):
    """Clean steps, then a NaN-poisoned minibatch, more clean steps, a
    statistically anomalous one (its one-hot labels scaled by 50: a loss
    spike) and a final clean step, under ``DivergenceGuard(
    "skip")`` with a ``StatGuardConfig``: both bad steps leave every
    tree bitwise unchanged in both packages, the decisions and counts
    are JAX's, and the clean steps agree."""
    jmodel, model = _lenet_pair() if engine == "multilayer" else \
        _graph_pair()
    cfg = dict(SG, warmup=4)
    model.set_divergence_guard(guard.DivergenceGuard(
        "skip", stats=guard.StatGuardConfig(**cfg)))
    jmodel.set_divergence_guard(jguard.DivergenceGuard(
        "skip", stats=jguard.StatGuardConfig(**cfg)))
    data = _batches(engine, 9, seed=1)
    bad = {5: "nan", 7: "spike"}
    rtol, atol = kernel_tols()
    for i, (x, y) in enumerate(data):
        if bad.get(i) == "nan":
            x = x.copy()
            x[0, ...] = np.nan
        elif bad.get(i) == "spike":
            y = y * 50.0  # a mislabelled batch: a 50x loss spike
        before, jbefore = _snapshot(model), _snapshot(jmodel)
        if engine == "multilayer":
            model.fit(DataSet(x, y))
            jmodel.fit(JDataSet(x, y))
        else:
            model.fit(MultiDataSet([x], [y]))
            jmodel.fit(JMultiDataSet(features=[x], labels=[y]))
        if i in bad:
            _assert_unchanged(before, _snapshot(model), f"port step {i}")
            _assert_unchanged(jbefore, _snapshot(jmodel), f"jax step {i}")
        else:
            np.testing.assert_allclose(model.score_value,
                                       float(jmodel.score_value), rtol=rtol,
                                       atol=atol)
    g, jg = model.divergence_guard, jmodel.divergence_guard
    assert g.skipped_batches == jg.skipped_batches == [5, 7]
    assert g.skipped_steps == jg.skipped_steps == 2
    assert g.consecutive_bad == jg.consecutive_bad == 0
    _assert_sg_close(model._stat_guard_state, jmodel._stat_guard_state)
    assert g.metrics["guard_spike_trips_total"] == {
        "loss": int(jmodel._stat_guard_state["trips_loss"]),
        "gradnorm": int(jmodel._stat_guard_state["trips_gnorm"])}
    assert model.iteration_count == jmodel.iteration_count == len(data)
    for key, ref in _flat(jmodel.params).items():
        ln, pn = key.rsplit("/", 1)
        np.testing.assert_allclose(model.params[ln][pn].numpy(), ref,
                                   rtol=rtol, atol=atol, err_msg=key)


def test_guard_without_stats_threads_no_ewma_state():
    _, net = _lenet_pair()
    net.set_divergence_guard(guard.DivergenceGuard("skip"))
    (x, y), = _batches("multilayer", 1)
    net.fit(DataSet(x, y))
    assert net._stat_guard_state is None
    x = x.copy()
    x[:] = np.inf
    before = _snapshot(net)
    net.fit(DataSet(x, y))
    _assert_unchanged(before, _snapshot(net), "inf step")
    assert net.divergence_guard.skipped_batches == [1]
    net.set_divergence_guard(None)
    assert net._step is None


# -- DistributedTrainer on 2 gloo ranks ---------------------------------------

_CHILD = r"""
import json, sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    DistributedTrainer, build_mesh, init_distributed, shutdown_distributed)
from deeplearning4j_tpu_torch.resilience.guard import (
    DivergenceGuard, StatGuardConfig)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy, params_to_numpy)

spec = json.loads(sys.argv[1])
init_distributed("file://" + spec["rdv"], spec["world"], spec["rank"],
                 device="cpu", timeout_s=120)
model = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
    json.loads(open(spec["conf"]).read())), device="cpu")
model.init(params=params_from_numpy(dict(np.load(spec["init"])), "cpu"))
model.set_transforms(loss_scale=spec["loss_scale"])
g = DivergenceGuard("skip", stats=StatGuardConfig(**spec["sg"]))
tr = DistributedTrainer(model, mesh=build_mesh(data=spec["world"]),
                        divergence_guard=g, zero=spec["zero"])
data = np.load(spec["data"])
out = {"scores": [], "ls": []}
for i in range(spec["steps"]):
    s = tr.fit_minibatch(DataSet(data[f"x{i}"], data[f"y{i}"]))
    out["scores"].append(float(s))
    st = model._loss_scale_state
    out["ls"].append(None if st is None else [
        float(st["scale"]), int(st["good_steps"]), int(st["overflows"])])
out["skipped"] = g.skipped_batches
out["sg"] = {k: float(v) for k, v in model._stat_guard_state.items()}
np.savez(spec["out"], **{"p:" + k: v for k, v in
                         params_to_numpy(model.params).items()})
json.dump(out, open(spec["out"] + ".json", "w"))
shutdown_distributed()
"""


def _half_mlp(compute):
    b = (JNeuralNetConfiguration.Builder().seed(5).updater("ADAM")
         .learning_rate(0.01).data_type("float32")
         .compute_data_type(compute).list())
    b.layer(JDense(n_in=8, n_out=16, activation="tanh"))
    b.layer(JOutput(n_in=16, n_out=3))
    return b.build()


def _run_ranks(tmp_path, world, conf, init, data, spec):
    np.savez(tmp_path / "init.npz", **init)
    np.savez(tmp_path / "data.npz", **data)
    (tmp_path / "conf.json").write_text(json.dumps(conf.to_dict()))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        s = dict(spec, rank=r, world=world, rdv=str(tmp_path / "rdv"),
                 conf=str(tmp_path / "conf.json"),
                 init=str(tmp_path / "init.npz"),
                 data=str(tmp_path / "data.npz"),
                 out=str(tmp_path / f"out{r}.npz"))
        logs.append(tmp_path / f"err{r}.txt")
        with open(logs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, json.dumps(s)],
                cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL,
                stderr=err))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail("ranks hung:\n" + "\n".join(
            log.read_text()[-2000:] for log in logs))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    return [(json.loads(Path(str(tmp_path / f"out{r}.npz") + ".json")
                        .read_text()),
             dict(np.load(tmp_path / f"out{r}.npz"))) for r in range(world)]


@pytest.mark.parametrize("compute,zero", [("float16", False),
                                          ("float16", True),
                                          ("bfloat16", False)])
def test_trainer_two_ranks_loss_scale_and_guard_match_jax(tmp_path, compute,
                                                          zero):
    """f16 compute with loss scaling (an initial scale that overflows
    at first) and the guard with its statistical half, on 2 gloo ranks,
    replicated and ZeRO-1, and bf16 compute (where the scale stays off):
    the finite probe runs after the all-reduce, so both ranks take the
    same branch; a NaN batch is skipped. Scores, loss-scale states,
    skipped steps and weights against the JAX trainer on
    build_mesh(data=2), at f16's tolerance (rtol 2e-3, atol 1e-3) or
    bf16's (rtol 2e-2, atol 8e-3)."""
    conf = _half_mlp(compute)
    rtol, atol = (2e-3, 1e-3) if compute == "float16" else (2e-2, 8e-3)
    jnet = JMultiLayerNetwork(conf).init()
    init = _flat(jnet.params)
    rng = np.random.RandomState(3)
    steps = 8
    data = {}
    for i in range(steps):
        x = rng.randn(8, 8).astype(np.float32)
        if i == 4:
            x[1, 2] = np.nan
        data[f"x{i}"] = x
        data[f"y{i}"] = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)]
    sg = dict(SG, warmup=2)
    start = 2.0 ** 24  # overflows the f16 gradients at first
    res = _run_ranks(tmp_path, 2, MultiLayerConfiguration.from_dict(
        conf.to_dict()), init, data, dict(
            steps=steps, loss_scale=start, sg=sg, zero=zero))
    (out0, p0), (out1, p1) = res
    assert out0 == out1  # every rank took the same branches
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k])
    jnet.set_transforms(loss_scale=start)
    jg = jguard.DivergenceGuard("skip", stats=jguard.StatGuardConfig(**sg))
    mesh = jbuild_mesh(data=2, model=1, devices=jax.devices()[:2])
    jtr = JTrainer(jnet, mesh=mesh, divergence_guard=jg, zero=zero)
    jscores, jls = [], []
    for i in range(steps):
        jscores.append(float(jtr.fit_minibatch(JDataSet(data[f"x{i}"],
                                                        data[f"y{i}"]))))
        st = jnet._loss_scale_state
        jls.append(None if st is None else [
            float(st["scale"]), int(st["good_steps"]), int(st["overflows"])])
    assert out0["ls"] == jls
    if compute == "float16":
        assert jls[0][2] == 1  # the first step overflowed
    else:
        assert jls == [None] * steps  # bf16: no loss scaling
    assert out0["skipped"] == jg.skipped_batches
    assert 4 in jg.skipped_batches
    overflowed = [compute == "float16" and jls[i][2] != (
        jls[i - 1][2] if i else 0) for i in range(steps)]
    ok = [i for i in range(steps)
          if i not in jg.skipped_batches and not overflowed[i]]
    np.testing.assert_allclose(np.asarray(out0["scores"])[ok],
                               np.asarray(jscores)[ok], rtol=rtol, atol=atol)
    for key, ref in _flat(jnet.params).items():
        np.testing.assert_allclose(p0["p:" + key], ref, rtol=rtol,
                                   atol=atol, err_msg=key)
