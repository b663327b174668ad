"""Early stopping in the port (``deeplearning4j_tpu_torch.earlystopping``)
against the JAX package, on the CPU.

Every termination condition gives JAX's decisions on the same score
sequences. The trainers run on models built by the JAX package and
carried across (``params_from_numpy``, or the checkpoint zip for the
graph): ``EarlyStoppingTrainer``, ``EarlyStoppingGraphTrainer`` and
``EarlyStoppingParallelTrainer`` match JAX in the epochs run, the best
epoch, the termination reason and details, with every holdout score
within ``kernel_tols`` (rtol 2e-4, atol 2e-5). The networks train with
SGD / Nesterov momentum: Adam divides each gradient by its own
magnitude, which amplifies f32 summation-order noise past those
tolerances (``tests/test_torch_training.py`` says how far).
``ScoreImprovementEpochTerminationCondition``'s ``min_improvement`` is
set where no epoch's improvement lies within the tolerance of it, so
the decision cannot flip between the packages. A preemption notice
mid-epoch writes the emergency checkpoint and raises, and a fresh
network resumes from it bitwise.
"""

import math
import os

import numpy as np
import pytest

import torch_serving_models as M
from conftest import kernel_tols
from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.api import (
    ListDataSetIterator as JListDataSetIterator,
)
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu_torch import earlystopping as es
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.api import ChunkedDataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.resilience.preemption import (
    PreemptedException,
    PreemptionHandler,
    active_handler,
)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    params_to_numpy,
)


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _pair(updater="SGD", lr=0.1, seed=7):
    """A JAX MLP (4 -> 8 tanh -> 3 softmax) and the port's twin on its
    initial weights."""
    conf = (JNeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
            .updater(updater).list()
            .layer(JDense(n_in=4, n_out=8, activation="tanh"))
            .layer(JOutput(n_out=3))
            .build())
    jnet = JMultiLayerNetwork(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        conf.to_dict()), device="cpu").init(
            params=params_from_numpy(_flat(jnet.params), "cpu"))
    return jnet, net


def _blobs(seed=12345, n=60):
    rng = np.random.RandomState(seed)
    centers = rng.randn(3, 4) * 3
    x = np.stack([centers[i % 3] + 0.3 * rng.randn(4) for i in range(n)])
    y = np.eye(3)[np.arange(n) % 3]
    return x.astype(np.float32), y.astype(np.float32)


def _batches(x, y, size):
    return [(x[i:i + size], y[i:i + size]) for i in range(0, len(x), size)]


def _run(pkg, net, train, holdout, epoch_terms, iteration_terms=(),
         saver=None, trainer="EarlyStoppingTrainer", **trainer_kw):
    """One early-stopping fit in ``pkg`` (the JAX or the port module)
    over (features, labels) pairs."""
    if pkg is jes:
        ds, it = JDataSet, JListDataSetIterator
    else:
        ds, it = DataSet, ListDataSetIterator
    cfg = pkg.EarlyStoppingConfiguration(
        score_calculator=pkg.DataSetLossCalculator(
            it([ds(a, b) for a, b in holdout])),
        epoch_terminations=list(epoch_terms),
        iteration_terminations=list(iteration_terms),
        model_saver=saver)
    tr = getattr(pkg, trainer)(cfg, net, it([ds(a, b) for a, b in train]),
                               **trainer_kw)
    return tr.fit()


def _same_result(mine, ref):
    rtol, atol = kernel_tols()
    assert mine.termination_reason == ref.termination_reason
    assert mine.termination_details == ref.termination_details
    assert mine.total_epochs == ref.total_epochs
    assert mine.best_model_epoch == ref.best_model_epoch
    assert sorted(mine.score_vs_epoch) == sorted(ref.score_vs_epoch)
    for e, s in ref.score_vs_epoch.items():
        np.testing.assert_allclose(mine.score_vs_epoch[e], s, rtol=rtol,
                                   atol=atol, err_msg=f"epoch {e}")
    np.testing.assert_allclose(mine.best_model_score, ref.best_model_score,
                               rtol=rtol, atol=atol)


def _close_params(net, jnet):
    rtol, atol = kernel_tols()
    mine = params_to_numpy(net.params)
    for k, v in _flat(jnet.params).items():
        np.testing.assert_allclose(mine[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


# -- termination conditions against JAX's ---------------------------------

SCORES = [2.0, 1.5, 1.4995, 1.2, 1.3, 1.25, 1.21, float("nan"), 0.9,
          float("inf")]


@pytest.mark.parametrize("make", [
    lambda m: m.MaxEpochsTerminationCondition(4),
    lambda m: m.ScoreImprovementEpochTerminationCondition(2),
    lambda m: m.ScoreImprovementEpochTerminationCondition(
        1, min_improvement=0.01),
    lambda m: m.BestScoreEpochTerminationCondition(1.2),
], ids=["max_epochs", "improvement", "improvement_min", "best_score"])
def test_epoch_conditions_decide_as_jax(make):
    mine, ref = make(es), make(jes)
    for c in (mine, ref):
        c.initialize()
    got = [mine.terminate(e, s) for e, s in enumerate(SCORES)]
    want = [ref.terminate(e, s) for e, s in enumerate(SCORES)]
    assert got == want and any(got)
    mine.initialize()  # re-arming forgets the run
    assert mine.terminate(0, SCORES[0]) == (type(mine).__name__
                                            == "MaxEpochsTerminationCondition"
                                            and mine.max_epochs == 1)


@pytest.mark.parametrize("make", [
    lambda m: m.MaxScoreIterationTerminationCondition(1.45),
    lambda m: m.InvalidScoreIterationTerminationCondition(),
], ids=["max_score", "invalid_score"])
def test_iteration_conditions_decide_as_jax(make):
    mine, ref = make(es), make(jes)
    got = [mine.terminate(s) for s in SCORES]
    assert got == [ref.terminate(s) for s in SCORES] and any(got)


def test_max_time_condition(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(es.core.time, "time", lambda: now[0])
    c = es.MaxTimeIterationTerminationCondition(5.0)
    c.initialize()
    now[0] = 104.9
    assert not c.terminate(1.0)
    now[0] = 105.1
    assert c.terminate(1.0)


# -- the score calculator ---------------------------------------------------


def test_loss_calculator_weights_batches_by_examples_as_jax():
    jnet, net = _pair()
    x, y = _blobs(n=50)
    parts = _batches(x, y, 16)  # 16, 16, 16, 2: unequal weights
    ref = jes.DataSetLossCalculator(JListDataSetIterator(
        [JDataSet(a, b) for a, b in parts])).calculate_score(jnet)
    it = ListDataSetIterator([DataSet(a, b) for a, b in parts])
    got = es.DataSetLossCalculator(it).calculate_score(net)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    # the weighted mean is the whole set's mean loss, not the mean of
    # the four batch means
    np.testing.assert_allclose(got, net.score(x=x, labels=y), rtol=rtol,
                               atol=atol)
    assert it.has_next()  # reset after the pass
    total = es.DataSetLossCalculator(it, average=False).calculate_score(net)
    np.testing.assert_allclose(total, got * 50, rtol=rtol)
    # a chunk of stacked minibatches scores as its minibatches
    chunk = ChunkedDataSet(np.stack([a for a, _ in parts[:3]]),
                           np.stack([b for _, b in parts[:3]]))
    np.testing.assert_allclose(
        es.DataSetLossCalculator([chunk]).calculate_score(net),
        net.score(x=x[:48], labels=y[:48]), rtol=rtol, atol=atol)
    assert math.isnan(es.DataSetLossCalculator([]).calculate_score(net))


# -- the trainers against JAX's ---------------------------------------------


@pytest.mark.parametrize("saver", ["memory", "file"])
def test_trainer_max_epochs_matches_jax(saver, tmp_path):
    jnet, net = _pair()
    x, y = _blobs()
    savers = {"memory": (jes.InMemoryModelSaver(), es.InMemoryModelSaver()),
              "file": (jes.LocalFileModelSaver(str(tmp_path / "jax")),
                       es.LocalFileModelSaver(str(tmp_path / "port")))}
    jsaver, psaver = savers[saver]
    train = _batches(x, y, 20)
    ref = _run(jes, jnet, train, [(x, y)],
               [jes.MaxEpochsTerminationCondition(4)],
               [jes.InvalidScoreIterationTerminationCondition()], jsaver)
    mine = _run(es, net, train, [(x, y)],
                [es.MaxEpochsTerminationCondition(4)],
                [es.InvalidScoreIterationTerminationCondition()], psaver)
    _same_result(mine, ref)
    assert mine.termination_details == "MaxEpochsTerminationCondition"
    assert mine.total_epochs == 4 and net.iteration_count == 12
    _close_params(net, jnet)
    _close_params(mine.best_model, ref.best_model)
    assert mine.best_model.device == net.device
    np.testing.assert_allclose(mine.best_model.score(x=x, labels=y),
                               mine.best_model_score, rtol=1e-6)
    if saver == "file":
        assert os.path.exists(tmp_path / "port" / "bestModel.zip")


def test_trainer_score_improvement_matches_jax():
    """Nesterov momentum at lr 0.02: the holdout score falls 0.434,
    0.144, 0.057, 0.028, 0.015, 0.0085, 0.0053, 0.0036, 0.0025 in the
    first epochs, so each comparison against ``min_improvement`` 0.011
    (a single epoch's fall, or two epochs' since the best) misses it by
    more than 0.002, a hundred times the score tolerance: both packages
    stop after the same epoch (the tenth)."""
    jnet, net = _pair("NESTEROVS", lr=0.02, seed=3)
    x, y = _blobs(seed=4)
    train = _batches(x, y, 10)
    args = [(x, y)]
    ref = _run(jes, jnet, train, args, [
        jes.ScoreImprovementEpochTerminationCondition(
            2, min_improvement=0.011),
        jes.MaxEpochsTerminationCondition(40)], saver=jes.InMemoryModelSaver())
    mine = _run(es, net, train, args, [
        es.ScoreImprovementEpochTerminationCondition(
            2, min_improvement=0.011),
        es.MaxEpochsTerminationCondition(40)], saver=es.InMemoryModelSaver())
    _same_result(mine, ref)
    assert mine.termination_details == \
        "ScoreImprovementEpochTerminationCondition"
    assert mine.total_epochs == 10
    _close_params(net, jnet)


def test_trainer_iteration_termination_matches_jax():
    jnet, net = _pair(lr=0.1)
    x, y = _blobs()
    train = _batches(x, y, 20)
    ref = _run(jes, jnet, train, [(x, y)],
               [jes.MaxEpochsTerminationCondition(10)],
               [jes.MaxScoreIterationTerminationCondition(0.6)],
               jes.InMemoryModelSaver())
    mine = _run(es, net, train, [(x, y)],
                [es.MaxEpochsTerminationCondition(10)],
                [es.MaxScoreIterationTerminationCondition(0.6)],
                es.InMemoryModelSaver())
    _same_result(mine, ref)
    assert mine.termination_reason == "IterationTerminationCondition"
    assert net.iteration_count == jnet.iteration_count


def test_graph_trainer_matches_jax(tmp_path):
    """A VGG-shaped graph (conv, BN, pools, dense; Nesterov momentum)
    carried across through the checkpoint zip, its moments included."""
    jnet, _, net = M.pair("vgg", tmp_path)
    rng = np.random.RandomState(8)
    x = (rng.rand(24, 3, 8, 8) * 0.9 + 0.05).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 24)]
    train = _batches(x, y, 8)
    ref = _run(jes, jnet, train, [(x, y)],
               [jes.MaxEpochsTerminationCondition(3)],
               saver=jes.InMemoryModelSaver(),
               trainer="EarlyStoppingGraphTrainer")
    mine = _run(es, net, train, [(x, y)],
                [es.MaxEpochsTerminationCondition(3)],
                saver=es.InMemoryModelSaver(),
                trainer="EarlyStoppingGraphTrainer")
    _same_result(mine, ref)
    assert mine.total_epochs == 3 and net.iteration_count == 10
    _close_params(net, jnet)


def test_parallel_trainer_matches_jax():
    """Two replicas averaged every round (``ParallelWrapper``)."""
    jnet, net = _pair(lr=0.3, seed=3)
    x, y = _blobs(n=64)
    train = _batches(x, y, 16)
    s0 = net.score(x=x, labels=y)
    ref = _run(jes, jnet, train, [(x, y)],
               [jes.MaxEpochsTerminationCondition(3)],
               saver=jes.InMemoryModelSaver(),
               trainer="EarlyStoppingParallelTrainer", workers=2,
               averaging_frequency=1)
    mine = _run(es, net, train, [(x, y)],
                [es.MaxEpochsTerminationCondition(3)],
                saver=es.InMemoryModelSaver(),
                trainer="EarlyStoppingParallelTrainer", workers=2,
                averaging_frequency=1)
    _same_result(mine, ref)
    assert mine.total_epochs == 3 and mine.best_model_score < s0
    _close_params(net, jnet)


def test_no_best_model_when_the_first_step_is_invalid():
    _, net = _pair()
    x, y = _blobs()
    bad = x.copy()
    bad[0, 0] = np.nan
    result = _run(es, net, [(bad, y)], [(x, y)],
                  [es.MaxEpochsTerminationCondition(3)],
                  [es.InvalidScoreIterationTerminationCondition()],
                  es.InMemoryModelSaver())
    assert result.best_model_epoch == -1 and result.best_model is net
    assert result.termination_details == \
        "InvalidScoreIterationTerminationCondition"


def test_cluster_trainer_raises_naming_the_missing_module():
    """``parallel/cluster.py`` is ported, so the cluster trainer no longer
    raises: each epoch runs through a ``ParameterAveragingTrainingMaster``
    (two workers, averaging every round) and matches JAX's."""
    from deeplearning4j_tpu.parallel import (
        ParameterAveragingTrainingMaster as JMaster,
    )
    from deeplearning4j_tpu_torch.parallel import (
        ParameterAveragingTrainingMaster,
    )

    jnet, net = _pair(lr=0.3, seed=3)
    x, y = _blobs(n=64)
    train = _batches(x, y, 16)
    results = []
    for pkg, model, master, ds, it in (
            (jes, jnet, JMaster, JDataSet, JListDataSetIterator),
            (es, net, ParameterAveragingTrainingMaster, DataSet,
             ListDataSetIterator)):
        cfg = pkg.EarlyStoppingConfiguration(
            score_calculator=pkg.DataSetLossCalculator(it([ds(x, y)])),
            epoch_terminations=[pkg.MaxEpochsTerminationCondition(3)],
            model_saver=pkg.InMemoryModelSaver())
        tm = master(workers=2, batch_size_per_worker=16,
                    averaging_frequency=1, prefetch_num_batches=0)
        results.append(pkg.ClusterEarlyStoppingTrainer(
            cfg, model, tm, it([ds(a, b) for a, b in train])).fit())
    _same_result(results[1], results[0])
    assert results[1].total_epochs == 3
    _close_params(net, jnet)


# -- preemption -------------------------------------------------------------


class NotifyAt:
    """Fires the simulated preemption notice once, at step ``at``."""

    def __init__(self, at):
        self.at = at
        self.fired = False

    def iteration_done(self, model, it):
        if it == self.at and not self.fired:
            self.fired = True
            active_handler().notify("chaos")


def test_preemption_checkpoints_raises_and_resumes_bitwise(tmp_path):
    """The notice mid second epoch: the emergency checkpoint lands at
    step 6 on top of the per-epoch step 4 and the fit raises; a fresh
    network resumes from it bitwise and finishes the run."""
    x, y = _blobs()
    data = _batches(x, y, 15)  # 4 steps an epoch
    _, net = _pair()
    init = params_to_numpy(net.params)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    cfg = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(
            ListDataSetIterator([DataSet(x, y)])),
        epoch_terminations=[es.MaxEpochsTerminationCondition(5)],
        checkpoint_manager=mgr)
    net.listeners.append(NotifyAt(6))
    with PreemptionHandler():
        with pytest.raises(PreemptedException) as exc:
            es.EarlyStoppingTrainer(cfg, net, ListDataSetIterator(
                [DataSet(a, b) for a, b in data])).fit()
    assert exc.value.checkpoint.step == 6
    assert mgr.list_steps() == [4, 6]
    fresh = MultiLayerNetwork(net.conf, device="cpu").init(
        params=params_from_numpy(init, "cpu"))
    assert fresh.resume(mgr) == 6
    for k, v in params_to_numpy(net.params).items():
        np.testing.assert_array_equal(params_to_numpy(fresh.params)[k], v)
    # the uninterrupted run, and the resumed one over the batches left
    full = MultiLayerNetwork(net.conf, device="cpu").init(
        params=params_from_numpy(init, "cpu"))
    for a, b in data + data:
        full.fit_minibatch(DataSet(a, b))
    for a, b in data[2:]:
        fresh.fit_minibatch(DataSet(a, b))
    assert fresh.iteration_count == full.iteration_count == 8
    for k, v in params_to_numpy(full.params).items():
        np.testing.assert_array_equal(params_to_numpy(fresh.params)[k], v)
