"""The port's cluster training SPI (``parallel/cluster.py``) on the CPU,
against the JAX package's (``tests/test_cluster.py``'s cases).

Every model is built by the JAX package and carried across on its
initial weights (``params_from_numpy``). The parameter-averaging
master with averaging every step under SGD equals one machine on the
concatenated batch (the reference's
``TestCompareParameterAveragingSparkVsSingleMachine``), in both
packages; the port's trained weights equal JAX's. The exported ``.npz``
minibatch files are read across the packages both ways. Tolerances:
``kernel_tols()``, as the JAX cluster tests' own 2e-4 / 1e-6.
"""

import numpy as np
import pytest

from conftest import kernel_tols
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.api import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import GravesLSTM as JLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import (
    ClusterComputationGraph as JClusterGraph,
)
from deeplearning4j_tpu.parallel import ClusterDl4jMultiLayer as JCluster
from deeplearning4j_tpu.parallel import (
    ParameterAveragingTrainingMaster as JMaster,
)
from deeplearning4j_tpu.parallel import PathDataSetIterator as JPaths
from deeplearning4j_tpu.parallel import (
    batch_and_export_datasets as jexport,
)
from deeplearning4j_tpu.parallel.cluster import _ListIterator as _JList
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    ClusterComputationGraph,
    ClusterDl4jMultiLayer,
    ParameterAveragingTrainingMaster,
    PathDataSetIterator,
    batch_and_export_datasets,
)
from deeplearning4j_tpu_torch.parallel.cluster import _ListIterator
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    params_to_numpy,
)


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _carry(jmodel):
    """The port's twin of a JAX model, on its initial weights."""
    if hasattr(jmodel.conf, "vertices"):
        model = ComputationGraph(ComputationGraphConfiguration.from_dict(
            jmodel.conf.to_dict()), device="cpu")
    else:
        model = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
            jmodel.conf.to_dict()), device="cpu")
    return model.init(params=params_from_numpy(_flat(jmodel.params), "cpu"))


def _mlp(seed=12345, lr=0.1, updater="SGD"):
    conf = (JBuilder.Builder().seed(seed).learning_rate(lr).updater(updater)
            .list()
            .layer(JDense(n_out=10, activation="tanh"))
            .layer(JOutput(n_out=3, loss="MCXENT"))
            .set_input_type(JInputType.feed_forward(4))
            .build())
    jnet = JNet(conf).init()
    return jnet, _carry(jnet)


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


def _close(model, jmodel, what="cluster"):
    rtol, atol = kernel_tols()
    mine = params_to_numpy(model.params)
    for k, v in _flat(jmodel.params).items():
        np.testing.assert_allclose(mine[k], v, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def test_split_sizing():
    for master in (ParameterAveragingTrainingMaster, JMaster):
        tm = (master.Builder(4).batch_size_per_worker(8)
              .averaging_frequency(3).build())
        assert tm.num_examples_per_split() == 96


def test_matches_single_machine_avg_freq_1():
    """Two workers x 16, averaging every step, under SGD == one step on
    the concatenated 32 (and the JAX master's weights)."""
    x, y = _data(32)
    jnet, net = _mlp()
    _, single = _mlp()
    tm = (ParameterAveragingTrainingMaster.Builder(2)
          .batch_size_per_worker(16).averaging_frequency(1).build())
    ClusterDl4jMultiLayer(net, tm).fit(DataSet(x, y))
    single.fit(DataSet(x, y))
    rtol, atol = kernel_tols()
    got = params_to_numpy(net.params)
    for k, v in params_to_numpy(single.params).items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-5,
                                   err_msg=k)
    jtm = (JMaster.Builder(2).batch_size_per_worker(16)
           .averaging_frequency(1).build())
    JCluster(jnet, jtm).fit(JDataSet(features=x, labels=y))
    _close(net, jnet)


def test_multiple_splits_reduce_score_as_jax():
    x, y = _data(128, seed=3)
    jnet, net = _mlp(lr=0.5)
    for master, cluster, model, ds in (
            (ParameterAveragingTrainingMaster, ClusterDl4jMultiLayer, net,
             DataSet(x, y)),
            (JMaster, JCluster, jnet, JDataSet(features=x, labels=y))):
        tm = (master.Builder(2).batch_size_per_worker(8)
              .averaging_frequency(2).build())
        trainer = cluster(model, tm)
        s0 = float(model.score(ds))
        for _ in range(8):
            trainer.fit(ds)
        assert float(model.score(ds)) < s0
    _close(net, jnet)


def test_stats_collection():
    x, y = _data(64)
    _, net = _mlp()
    tm = (ParameterAveragingTrainingMaster.Builder(2)
          .batch_size_per_worker(16).collect_training_stats(True).build())
    ClusterDl4jMultiLayer(net, tm).fit(DataSet(x, y))
    stats = tm.get_training_stats().as_dict()
    assert stats["fit"]["count"] == 1
    assert stats["fit"]["total_ms"] > 0
    assert stats["split"]["count"] == 1


def test_export_and_fit_paths_across_packages(tmp_path):
    """The port reads the JAX package's exported files and the JAX
    package the port's; ``fit_paths`` trains as JAX's does."""
    x, y = _data(64, seed=5)
    jpaths = jexport(_JList([JDataSet(features=x[i:i + 16],
                                      labels=y[i:i + 16])
                             for i in range(0, 64, 16)]),
                     str(tmp_path / "jax"))
    paths = batch_and_export_datasets(
        _ListIterator([DataSet(x[i:i + 16], y[i:i + 16])
                       for i in range(0, 64, 16)]), str(tmp_path / "port"))
    assert len(paths) == 4
    for mine, theirs in ((PathDataSetIterator(jpaths), None),
                         (PathDataSetIterator(str(tmp_path / "jax")), None),
                         (None, JPaths(paths))):
        loaded = list(iter(mine if mine is not None else theirs))
        assert len(loaded) == 4
        np.testing.assert_array_equal(loaded[0].features, x[:16])
        np.testing.assert_array_equal(loaded[3].labels, y[48:])
    jnet, net = _mlp()
    ClusterDl4jMultiLayer(net, ParameterAveragingTrainingMaster.Builder(2)
                          .batch_size_per_worker(16).build()).fit_paths(
                              jpaths)
    JCluster(jnet, JMaster.Builder(2).batch_size_per_worker(16)
             .build()).fit_paths(paths)
    _close(net, jnet)


def test_masks_roundtrip(tmp_path):
    ds = DataSet(np.zeros((4, 3, 5), np.float32),
                 np.zeros((4, 2, 5), np.float32),
                 features_mask=np.ones((4, 5), np.float32),
                 labels_mask=np.ones((4, 5), np.float32))
    paths = batch_and_export_datasets(_ListIterator([ds]), str(tmp_path))
    back = next(iter(PathDataSetIterator(paths)))
    assert back.features_mask is not None
    assert back.labels_mask.shape == (4, 5)
    jback = next(iter(JPaths(paths)))
    assert jback.labels_mask.shape == (4, 5)


def test_sharded_eval_matches_plain():
    x, y = _data(60, seed=7)
    _, net = _mlp()
    batches = [DataSet(x[i:i + 10], y[i:i + 10]) for i in range(0, 60, 10)]
    trainer = ClusterDl4jMultiLayer(
        net, ParameterAveragingTrainingMaster.Builder(3).build())
    merged = trainer.evaluate(batches)
    plain = Evaluation()
    plain.eval(y, net.output(x).numpy())
    assert merged.accuracy() == pytest.approx(plain.accuracy())
    assert merged.f1() == pytest.approx(plain.f1())


def _graph(seed=3, lr=0.3):
    conf = (JBuilder.Builder().seed(seed).learning_rate(lr).updater("SGD")
            .graph_builder()
            .add_inputs("in")
            .add_layer("d", JDense(n_in=4, n_out=8, activation="tanh"), "in")
            .add_layer("out", JOutput(n_in=8, n_out=3), "d")
            .set_outputs("out")
            .build())
    jg = JGraph(conf).init()
    return jg, _carry(jg)


def _graph_data(n=64):
    r = np.random.RandomState(0)
    centers = r.randn(3, 4) * 2
    li = r.randint(0, 3, n)
    x = (centers[li] + r.randn(n, 4) * 0.3).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[li]
    return x, y


def test_graph_matches_single_machine_avg_freq_1():
    """Four workers, averaging every step, SGD == one machine on the
    concatenated batch, for the graph engine; and JAX's master."""
    x, y = _graph_data()
    jg, g = _graph()
    _, single = _graph()
    batches = [MultiDataSet([x[i:i + 16]], [y[i:i + 16]])
               for i in range(0, 64, 16)]
    cg = ClusterComputationGraph(g, ParameterAveragingTrainingMaster(
        workers=4, batch_size_per_worker=16, averaging_frequency=1))
    jcg = JClusterGraph(jg, JMaster(workers=4, batch_size_per_worker=16,
                                    averaging_frequency=1))
    jbatches = [JMultiDataSet(features=[x[i:i + 16]], labels=[y[i:i + 16]])
                for i in range(0, 64, 16)]
    for _ in range(6):
        single.fit_minibatch(MultiDataSet([x], [y]))
        cg.fit(batches)
        jcg.fit(jbatches)
    rtol, atol = kernel_tols()
    got = params_to_numpy(g.params)
    for k, v in params_to_numpy(single.params).items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-6,
                                   err_msg=k)
    _close(g, jg, "graph")


def test_graph_sharded_eval_and_score():
    x, y = _graph_data()
    _, g = _graph()
    batches = [MultiDataSet([x[i:i + 16]], [y[i:i + 16]])
               for i in range(0, 64, 16)]
    cg = ClusterComputationGraph(g, ParameterAveragingTrainingMaster(
        workers=4, batch_size_per_worker=16, averaging_frequency=1))
    cg.fit(batches)
    ev = cg.evaluate(batches)
    plain = g.evaluate(iter(batches))
    assert abs(ev.accuracy() - plain.accuracy()) < 1e-9
    assert np.isfinite(cg.get_score(batches[0]))


def test_masked_rnn_matches_single_machine():
    """The replica steps thread the labels and features masks."""
    conf = (JBuilder.Builder().seed(2).learning_rate(0.2).updater("SGD")
            .list()
            .layer(JLSTM(n_in=3, n_out=5, activation="tanh"))
            .layer(JRnnOutput(n_out=2))
            .set_input_type(JInputType.recurrent(3))
            .build())
    jnet = JNet(conf).init()
    r = np.random.RandomState(4)
    x = r.randn(8, 3, 6).astype(np.float32)
    y = np.zeros((8, 2, 6), np.float32)
    y[:, 0, :] = 1.0
    mask = np.ones((8, 6), np.float32)
    mask[:, 4:] = 0.0
    single, clustered = _carry(jnet), _carry(jnet)
    big = DataSet(x, y, features_mask=mask, labels_mask=mask)
    cl = ClusterDl4jMultiLayer(clustered, ParameterAveragingTrainingMaster(
        workers=2, batch_size_per_worker=4, averaging_frequency=1))
    jcl = JCluster(jnet, JMaster(workers=2, batch_size_per_worker=4,
                                 averaging_frequency=1))
    for _ in range(4):
        single.fit_minibatch(big)
        cl.fit(big)
        jcl.fit(JDataSet(features=x, labels=y, features_mask=mask,
                         labels_mask=mask))
    rtol, atol = kernel_tols()
    got = params_to_numpy(clustered.params)
    for k, v in params_to_numpy(single.params).items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-6,
                                   err_msg=k)
    _close(clustered, jnet, "masked rnn")
