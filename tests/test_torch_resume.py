"""Resume in the port (``resilience/checkpoint.py`` ``restore_into``,
``MultiLayerNetwork.resume`` / ``fit(resume_from=)``,
``ComputationGraph.resume``, ``DistributedTrainer.resume``) and the
divergence guard's rollback policy, on the CPU.

- Kill and resume: k steps, a checkpoint, a fresh model resumes and
  trains the rest; bitwise the uninterrupted run, on both engines
  (the graph engine with BatchNormalization's running statistics) and
  on the trainer through the prefetching pipeline mid-epoch. A resumed
  model continues the per-step keys, the learning-rate schedule and
  Adam's ``t`` from the iteration count, so nothing may differ.
- ``fit(resume_from=)``; a configuration mismatch is refused.
- A JAX checkpoint at step k resumed in the port continues JAX's
  uninterrupted trajectory: the same math in another framework, so
  ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5).
- The rollback guard: the JAX package's and the port's rollback runs
  from the same weights restore the same step and agree at
  ``kernel_tols()``; within the port the restore is bitwise the
  checkpointed trees.
"""

import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.resilience.checkpoint import (
    CheckpointManager as JManager,
)
from deeplearning4j_tpu.resilience.guard import (
    DivergenceGuard as JGuard,
)
from deeplearning4j_tpu_torch.datasets import (
    DataSet,
    ListDataSetIterator,
    PrefetchIterator,
)
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization,
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import DistributedTrainer
from deeplearning4j_tpu_torch.resilience import (
    CheckpointListener,
    CheckpointManager,
    DivergenceGuard,
    restore_into,
)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    params_to_numpy,
    write_model,
)


@pytest.fixture
def rng():
    return np.random.RandomState(12345)


def mlp_conf(seed=7, lr=0.05):
    return (NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
            .updater("ADAM").list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .build())


def graph_conf():
    return (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .updater("NESTEROVS").graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_in=4, n_out=8,
                                       activation="identity"), "in")
            .add_layer("bn", BatchNormalization(activation="relu"), "d")
            .add_layer("out", OutputLayer(n_in=8, n_out=3), "bn")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4)).build())


def batches(rng, n_batches=8, batch=8):
    return [DataSet(rng.randn(batch, 4).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)])
            for _ in range(n_batches)]


def poisoned(ds):
    x = ds.features.copy()
    x[0, 0] = np.nan
    return DataSet(x, ds.labels)


def assert_bitwise(a, b):
    assert a.iteration_count == b.iteration_count
    for tree in ("params", "state"):
        for ln, lp in getattr(a, tree).items():
            for k, t in lp.items():
                assert torch.equal(t, getattr(b, tree)[ln][k]), (tree, ln, k)
    for ln, lp in a.updater_state.items():
        for pn, tup in lp.items():
            for u, v in zip(tup, b.updater_state[ln][pn]):
                assert torch.equal(u, v), ("updater", ln, pn)


# -- kill and resume, bitwise -----------------------------------------------


def test_kill_resume_is_the_uninterrupted_run_multilayer(rng, tmp_path):
    data = batches(rng)
    full = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    for ds in data:
        full.fit_minibatch(ds)
    mgr = CheckpointManager(tmp_path, device="cpu")
    victim = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    for ds in data[:3]:
        victim.fit_minibatch(ds)
    mgr.save(victim)
    del victim
    survivor = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    assert survivor.resume(mgr) == 3
    for ds in data[3:]:
        survivor.fit_minibatch(ds)
    assert_bitwise(full, survivor)


def test_kill_resume_graph_engine_through_restore_into(rng, tmp_path):
    """The graph engine with BatchNormalization: the running statistics
    ride the checkpoint (``layerState``), and ``restore_into`` from a
    zip path resumes bitwise; a ``(manager, info)`` pair too."""
    data = batches(rng)
    full = ComputationGraph(graph_conf(), device="cpu").init()
    for ds in data:
        full.fit_minibatch(ds)
    victim = ComputationGraph(graph_conf(), device="cpu").init()
    for ds in data[:5]:
        victim.fit_minibatch(ds)
    write_model(victim, tmp_path / "g.zip")
    mgr = CheckpointManager(tmp_path / "m", device="cpu")
    info = mgr.save(victim)
    for source in (tmp_path / "g.zip", (mgr, info)):
        survivor = ComputationGraph(graph_conf(), device="cpu").init()
        _, step = restore_into(survivor, source)
        assert step == 5 and survivor.resume(source) == 5
        survivor.fit(data[5:])
        assert_bitwise(full, survivor)


def test_kill_resume_trainer_mid_epoch_with_prefetch(rng, tmp_path):
    """The victim trains through a prefetching iterator with the
    trainer's placement on the worker, dies mid-epoch with batches in
    the queue, and the pipelined survivor replays the trajectory
    bitwise: runahead never advances training state."""
    data = batches(rng, n_batches=8, batch=16)
    full = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    DistributedTrainer(full).fit(ListDataSetIterator(data), prefetch=2)
    mgr = CheckpointManager(tmp_path, device="cpu")
    victim = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    tr_victim = DistributedTrainer(victim)
    pf = PrefetchIterator(ListDataSetIterator(data), queue_depth=4,
                          placement=tr_victim.place_minibatch)
    for consumed, ds in enumerate(pf, start=1):
        tr_victim.fit_minibatch(ds)
        if consumed == 3:
            break
    mgr.save(victim)
    pf.shutdown()
    del victim, tr_victim
    survivor = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    tr = DistributedTrainer(survivor)
    step = tr.resume(mgr)
    assert step == 3
    tr.fit(ListDataSetIterator(data[step:]), prefetch=2)
    assert_bitwise(full, survivor)


def test_fit_resume_from_and_config_mismatch(rng, tmp_path):
    data = batches(rng, n_batches=4)
    mgr = CheckpointManager(tmp_path, device="cpu")
    net = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    net.set_listeners(CheckpointListener(mgr, frequency=2))
    net.fit(data[:3])
    assert mgr.list_steps() == [2]
    fresh = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    fresh.fit(ListDataSetIterator(data[2:]), resume_from=mgr)
    assert fresh.iteration_count == 4
    other = MultiLayerNetwork(mlp_conf(seed=8), device="cpu").init()
    with pytest.raises(ValueError, match="does not match"):
        other.resume(mgr)


# -- against the JAX package ----------------------------------------------------


def jax_twin(conf):
    jnet = JNet(JConf.from_dict(conf.to_dict())).init()
    flat = {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in jnet.params.items() for pn, a in lp.items()}
    return jnet, flat


def assert_close_to_jax(net, jnet):
    rtol, atol = kernel_tols()
    got = params_to_numpy(net.params)
    for ln, lp in jnet.params.items():
        for pn, a in lp.items():
            np.testing.assert_allclose(got[f"{ln}/{pn}"], np.asarray(a),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{ln}/{pn}")


def test_jax_checkpoint_resumed_in_the_port_continues_jax(rng, tmp_path):
    """JAX trains 3 steps and checkpoints through its manager; the port
    resumes that directory and trains the remaining 5; JAX's own
    uninterrupted 8 steps match at ``kernel_tols()``."""
    data = batches(rng)
    jdata = [JDataSet(d.features, d.labels) for d in data]
    jfull, _ = jax_twin(mlp_conf())
    for ds in jdata:
        jfull.fit_minibatch(ds)
    jvictim, _ = jax_twin(mlp_conf())
    for ds in jdata[:3]:
        jvictim.fit_minibatch(ds)
    JManager(tmp_path).save(jvictim)
    survivor = MultiLayerNetwork(mlp_conf(), device="cpu").init()
    assert survivor.resume(CheckpointManager(tmp_path)) == 3
    for ds in data[3:]:
        survivor.fit_minibatch(ds)
    assert survivor.iteration_count == jfull.iteration_count == 8
    assert_close_to_jax(survivor, jfull)


def test_rollback_guard_against_the_jax_rollback_run(rng, tmp_path):
    """Both packages: a checkpoint at step 2 (every 2 steps), a NaN
    minibatch 4 rolls back to it, training goes on over the rest. The
    same steps restored, the same counts and skipped ledger; weights at
    ``kernel_tols()``; the port's restore bitwise its checkpoint."""
    data = batches(rng, n_batches=6)
    data[3] = poisoned(data[3])
    jnet, flat = jax_twin(mlp_conf())
    net = MultiLayerNetwork(mlp_conf(), device="cpu").init(
        params=params_from_numpy(flat, "cpu"))
    jmgr = JManager(tmp_path / "jax")
    mgr = CheckpointManager(tmp_path / "port", device="cpu")
    jguard = JGuard(policy="rollback", checkpoint_manager=jmgr)
    guard = DivergenceGuard("rollback", checkpoint_manager=mgr)
    jnet.set_divergence_guard(jguard)
    net.set_divergence_guard(guard)
    seen = {}
    for i, (jds, ds) in enumerate(zip(
            [JDataSet(d.features, d.labels) for d in data], data)):
        jnet.fit_minibatch(jds)
        net.fit_minibatch(ds)
        if i == 1:
            jmgr.save(jnet)
            mgr.save(net)
            seen["saved"] = params_to_numpy(net.params)
        if i == 3:
            assert net.iteration_count == jnet.iteration_count == 2
            for k, v in seen["saved"].items():
                np.testing.assert_array_equal(
                    params_to_numpy(net.params)[k], v)
    assert guard.rollbacks == jguard.rollbacks == 1
    assert net.iteration_count == jnet.iteration_count == 4
    assert guard.skipped_batches == jguard.skipped_batches
    assert_close_to_jax(net, jnet)
