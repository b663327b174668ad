"""Evaluation in the port (``deeplearning4j_tpu_torch.eval`` and both
engines' ``evaluate``) against the JAX package, on the CPU.

The classes are host-side numpy bookkeeping, so on the same seeded
arrays they must give JAX's answers exactly: the confusion matrix, every
metric and the ``stats()`` strings, with record metadata, masks, 3-D
labels and ``merge``. Tensors are accepted wherever arrays are. The
engines' ``evaluate`` runs on models built by the JAX package and
carried across through the checkpoint zip: a dense/conv
``MultiLayerNetwork``, a small ``ComputationGraph`` and an RNN with 3-D
labels and masks; each gives JAX's confusion matrix on the same
minibatches (their outputs agree within ``kernel_tols``, and the rows
are seeded away from argmax ties).
"""

import numpy as np
import pytest
import torch

import torch_serving_models as M
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.api import (
    ListDataSetIterator as JListDataSetIterator,
)
from deeplearning4j_tpu.eval import Evaluation as JEvaluation
from deeplearning4j_tpu.eval import Prediction as JPrediction
from deeplearning4j_tpu.eval import RegressionEvaluation as JRegression
from deeplearning4j_tpu.eval.roc import ROC as JROC
from deeplearning4j_tpu.eval.roc import ROCMultiClass as JROCMultiClass
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.layers import GravesLSTM as JGravesLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutput
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.api import ChunkedDataSet
from deeplearning4j_tpu_torch.eval import (
    ROC,
    ConfusionMatrix,
    Evaluation,
    Prediction,
    RegressionEvaluation,
    ROCMultiClass,
)
from deeplearning4j_tpu_torch.eval.evaluation import host_array
from deeplearning4j_tpu_torch.util.model_serializer import restore_model


def _onehot(ids, n):
    return np.eye(n, dtype=np.float32)[ids]


def _probs(rng, n, c):
    p = rng.rand(n, c).astype(np.float32)
    return p / p.sum(axis=1, keepdims=True)


def _same_eval(mine, ref):
    np.testing.assert_array_equal(mine.confusion.matrix,
                                  ref.confusion.matrix)
    assert mine.stats() == ref.stats()
    assert mine.stats(print_confusion=False) == ref.stats(
        print_confusion=False)
    for c in range(ref.n_classes):
        assert mine.precision(c) == ref.precision(c)
        assert mine.recall(c) == ref.recall(c)
        assert mine.f1(c) == ref.f1(c)
        assert mine.false_positive_rate(c) == ref.false_positive_rate(c)
    assert mine.accuracy() == ref.accuracy()


def _same_meta(mine, ref):
    def key(preds):
        return [(p.actual_class, p.predicted_class, p.record_meta_data)
                for p in preds]

    assert key(mine.get_prediction_errors()) == key(
        ref.get_prediction_errors())
    for c in range(ref.n_classes):
        assert key(mine.get_predictions_by_actual_class(c)) == key(
            ref.get_predictions_by_actual_class(c))
        assert key(mine.get_predictions_by_predicted_class(c)) == key(
            ref.get_predictions_by_predicted_class(c))


# -- Evaluation against JAX's on seeded arrays ----------------------------


def _case(name, rng):
    """(labels, predictions, mask, metadata) of one seeded case."""
    if name == "2d":
        return (_onehot(rng.randint(0, 4, 40), 4), _probs(rng, 40, 4),
                None, None)
    if name == "2d_masked_meta":
        return (_onehot(rng.randint(0, 3, 24), 3), _probs(rng, 24, 3),
                (rng.rand(24) > 0.3).astype(np.float32),
                [f"rec{i}" for i in range(24)])
    if name == "binary_column":
        return ((rng.rand(30, 1) > 0.5).astype(np.float32),
                rng.rand(30, 1).astype(np.float32), None, None)
    if name == "3d_masked_meta":
        lab = _onehot(rng.randint(0, 3, 5 * 6), 3).reshape(5, 6, 3)
        pred = _probs(rng, 30, 3).reshape(5, 6, 3)
        mask = (rng.rand(5, 6) > 0.25).astype(np.float32)
        return (lab.transpose(0, 2, 1), pred.transpose(0, 2, 1), mask,
                [f"seq{i}" for i in range(5)])
    raise KeyError(name)


@pytest.mark.parametrize("name", ["2d", "2d_masked_meta", "binary_column",
                                  "3d_masked_meta"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_evaluation_matches_jax_exactly(name, as_tensor):
    rng = np.random.RandomState(sum(map(ord, name)))
    labels, preds, mask, meta = _case(name, rng)
    ref = JEvaluation()
    mine = Evaluation()
    for _ in range(2):  # two eval calls accumulate
        ref.eval(labels, preds, mask=mask, record_meta_data=meta)
        if as_tensor:
            mine.eval(torch.from_numpy(labels), torch.from_numpy(preds),
                      mask=None if mask is None else torch.from_numpy(mask),
                      record_meta_data=meta)
        else:
            mine.eval(labels, preds, mask=mask, record_meta_data=meta)
    _same_eval(mine, ref)
    _same_meta(mine, ref)


def test_evaluation_with_class_labels_and_merge_matches_jax():
    rng = np.random.RandomState(7)
    names = ["cat", "dog", "eel"]
    parts = [(_onehot(rng.randint(0, 3, 16), 3), _probs(rng, 16, 3),
              [f"r{k}-{i}" for i in range(16)]) for k in range(3)]
    ref, mine = JEvaluation(labels=names), Evaluation(labels=names)
    for lab, pred, meta in parts:
        r, m = JEvaluation(labels=names), Evaluation(labels=names)
        r.eval(lab, pred, record_meta_data=meta)
        m.eval(lab, pred, record_meta_data=meta)
        ref.merge(r)
        mine.merge(m)
    assert mine.merge(Evaluation()) is mine  # an empty part is a no-op
    _same_eval(mine, ref)
    _same_meta(mine, ref)
    assert "cat" in mine.stats()


def test_confusion_matrix_counts():
    cm = ConfusionMatrix(3)
    cm.add(0, 1)
    cm.add(0, 1, count=2)
    cm.add(2, 2)
    assert cm.get_count(0, 1) == 3 and cm.total() == 4
    assert cm.actual_total(0) == 3 and cm.predicted_total(1) == 3


# -- record metadata (counterparts of tests/test_eval_meta.py) ------------


def test_prediction_attribution_basic():
    e = Evaluation()
    labels = _onehot([0, 1, 2, 1], 3)
    preds = _onehot([0, 2, 2, 1], 3)  # example 1 is wrong (1 -> 2)
    e.eval(labels, preds, record_meta_data=["rec0", "rec1", "rec2", "rec3"])
    errors = e.get_prediction_errors()
    assert errors == [Prediction(1, 2, "rec1")]
    assert sorted(p.record_meta_data
                  for p in e.get_predictions_by_actual_class(1)) == [
        "rec1", "rec3"]
    assert sorted(p.record_meta_data
                  for p in e.get_predictions_by_predicted_class(2)) == [
        "rec1", "rec2"]
    assert e.get_predictions(0, 0) == [Prediction(0, 0, "rec0")]
    assert e.get_predictions(2, 0) == []
    assert repr(errors[0]) == repr(JPrediction(1, 2, "rec1"))


def test_without_metadata_no_predictions_tracked():
    e = Evaluation()
    e.eval(_onehot([0, 1], 2), _onehot([1, 1], 2))
    assert e.get_prediction_errors() == []
    assert e.accuracy() == 0.5


def test_metadata_respects_mask():
    e = Evaluation()
    e.eval(_onehot([0, 1, 0], 2), _onehot([1, 1, 0], 2),
           mask=np.array([0.0, 1.0, 1.0]), record_meta_data=["a", "b", "c"])
    assert e.get_prediction_errors() == []
    assert e.get_predictions(1, 1) == [Prediction(1, 1, "b")]
    assert e.get_predictions(0, 0) == [Prediction(0, 0, "c")]


def test_metadata_time_series_expansion():
    e = Evaluation()
    labels = np.zeros((2, 2, 2), np.float32)
    preds = np.zeros((2, 2, 2), np.float32)
    labels[:, 0, :] = 1.0
    preds[0, 0, :] = 1.0
    preds[1, 1, :] = 1.0
    e.eval(labels, preds, mask=np.array([[1.0, 1.0], [1.0, 0.0]]),
           record_meta_data=["e0", "e1"])
    assert e.get_prediction_errors() == [Prediction(0, 1, "e1")]
    assert len(e.get_predictions(0, 0)) == 2


def test_merge_carries_metadata():
    a, b = Evaluation(), Evaluation()
    a.eval(_onehot([0], 2), _onehot([1], 2), record_meta_data=["x"])
    b.eval(_onehot([1], 2), _onehot([1], 2), record_meta_data=["y"])
    a.merge(b)
    assert a.get_prediction_errors() == [Prediction(0, 1, "x")]
    assert a.get_predictions(1, 1) == [Prediction(1, 1, "y")]
    assert a.accuracy() == 0.5


# -- RegressionEvaluation and ROC against JAX's ----------------------------


@pytest.mark.parametrize("shape", ["2d", "3d_masked"])
def test_regression_evaluation_matches_jax_exactly(shape):
    rng = np.random.RandomState(11)
    mask = None
    if shape == "2d":
        labels = rng.randn(50, 3).astype(np.float32)
        preds = (labels + 0.3 * rng.randn(50, 3)).astype(np.float32)
    else:
        labels = rng.randn(4, 3, 7).astype(np.float32)
        preds = (labels + 0.3 * rng.randn(4, 3, 7)).astype(np.float32)
        mask = (rng.rand(4, 7) > 0.3).astype(np.float32)
    ref, mine = JRegression(), RegressionEvaluation()
    for _ in range(2):
        ref.eval(labels, preds, mask=mask)
        mine.eval(torch.from_numpy(labels), preds, mask=mask)
    assert mine.stats() == ref.stats()
    for c in range(3):
        for fn in ("mean_squared_error", "mean_absolute_error",
                   "root_mean_squared_error", "correlation_r2",
                   "r_squared"):
            assert getattr(mine, fn)(c) == getattr(ref, fn)(c), fn
    assert mine.average_mean_squared_error() == \
        ref.average_mean_squared_error()


@pytest.mark.parametrize("form", ["vector", "one_hot", "masked"])
def test_roc_matches_jax_exactly(form):
    rng = np.random.RandomState(5)
    pos = rng.randint(0, 2, 300)
    prob = np.clip(pos * 0.35 + 0.3 + 0.25 * rng.randn(300), 0, 1)
    mask = None
    if form == "vector":
        labels, preds = pos, prob
    else:
        labels = np.eye(2, dtype=np.float32)[pos]
        preds = np.stack([1 - prob, prob], axis=1).astype(np.float32)
        if form == "masked":
            mask = (rng.rand(300) > 0.2).astype(np.float32)
    ref, mine = JROC(threshold_steps=40), ROC(threshold_steps=40)
    ref.eval(labels, preds, mask=mask)
    mine.eval(torch.as_tensor(labels), torch.as_tensor(preds), mask=mask)
    assert mine.get_roc_curve() == ref.get_roc_curve()
    assert mine.calculate_auc() == ref.calculate_auc()


def test_roc_multiclass_matches_jax_exactly():
    rng = np.random.RandomState(6)
    labels = _onehot(rng.randint(0, 4, 120), 4)
    preds = _probs(rng, 120, 4) * 0.5 + labels * 0.5
    ref, mine = JROCMultiClass(threshold_steps=25), ROCMultiClass(
        threshold_steps=25)
    for half in (slice(0, 60), slice(60, 120)):
        ref.eval(labels[half], preds[half])
        mine.eval(labels[half], torch.from_numpy(preds[half]))
    for c in range(4):
        assert mine.calculate_auc(c) == ref.calculate_auc(c)
    assert mine.calculate_average_auc() == ref.calculate_average_auc()


def test_roc_perfect_and_random_classifiers():
    roc = ROC(threshold_steps=50)
    roc.eval(np.array([0, 0, 0, 1, 1, 1]),
             np.array([0.1, 0.2, 0.15, 0.9, 0.85, 0.95]))
    assert roc.calculate_auc() > 0.99
    rng = np.random.RandomState(12345)
    roc = ROC(threshold_steps=100)
    roc.eval(rng.randint(0, 2, 2000), rng.rand(2000))
    assert 0.45 < roc.calculate_auc() < 0.55


def test_host_array_takes_tensors_and_widens_half_precision():
    t = torch.tensor([[0.25, 0.75]], dtype=torch.bfloat16)
    a = host_array(t)
    assert a.dtype == np.float32 and a.tolist() == [[0.25, 0.75]]
    assert host_array(None) is None
    assert host_array([1, 2], np.float64).dtype == np.float64


# -- the engines' evaluate on models carried across from JAX ---------------


def _separated_rows(kind, jnet, n, seed):
    """Rows of ``kind``'s width whose JAX top-2 margin is wide enough
    that the port's argmax (within kernel_tols) cannot flip."""
    x = M.rows(kind, 4 * n, seed)
    out = np.sort(M.jax_output(kind, jnet, x), axis=1)
    keep = (out[:, -1] - out[:, -2]) > 1e-3
    assert keep.sum() >= n
    return x[keep][:n]


@pytest.mark.parametrize("kind", ["mlp", "conv", "vgg"])
def test_engine_evaluate_matches_jax(kind, tmp_path):
    jnet, _, net = M.pair(kind, tmp_path)
    n_out = M.jax_output(kind, jnet, M.rows(kind, 1, 0)).shape[1]
    rng = np.random.RandomState(3)
    parts = []
    for i in range(3):
        x = _separated_rows(kind, jnet, 8, seed=20 + i)
        if kind in M.IMAGE:
            x = x.reshape((-1,) + M.IMAGE[kind])
        parts.append((x, _onehot(rng.randint(0, n_out, 8), n_out)))
    ref = jnet.evaluate(JListDataSetIterator(
        [JDataSet(x, y) for x, y in parts]))
    it = ListDataSetIterator([DataSet(x, y) for x, y in parts])
    mine = net.evaluate(it)
    _same_eval(mine, ref)
    assert it.has_next()  # reset after the pass
    # a chunk of stacked minibatches evaluates as its minibatches
    chunk = ChunkedDataSet(np.stack([x for x, _ in parts]),
                           np.stack([y for _, y in parts]))
    _same_eval(net.evaluate([chunk]), ref)


def _jax_rnn(seed=3):
    conf = (JNeuralNetConfiguration.Builder().seed(seed).learning_rate(0.1)
            .updater("RMSPROP").list()
            .layer(JGravesLSTM(n_out=6))
            .layer(JRnnOutput(n_out=3, loss="MCXENT"))
            .set_input_type(JInputType.recurrent(4)).build())
    return JMultiLayerNetwork(conf).init()


@pytest.mark.parametrize("masks", ["labels_mask", "features_mask_only",
                                   "none"])
def test_rnn_evaluate_with_3d_labels_and_masks_matches_jax(masks, tmp_path):
    jnet = _jax_rnn()
    path = str(tmp_path / "rnn.zip")
    jax_serializer.write_model(jnet, path)
    net = restore_model(path, device="cpu")
    rng = np.random.RandomState(9)
    jparts, parts = [], []
    for _ in range(2):
        x = rng.randn(5, 4, 7).astype(np.float32)
        y = _onehot(rng.randint(0, 3, 35), 3).reshape(5, 7, 3).transpose(
            0, 2, 1)
        fm = (rng.rand(5, 7) > 0.3).astype(np.float32)
        fm[:, 0] = 1.0
        lm = (rng.rand(5, 7) > 0.2).astype(np.float32)
        kw = {"labels_mask": dict(features_mask=fm, labels_mask=lm),
              "features_mask_only": dict(features_mask=fm),
              "none": {}}[masks]
        jparts.append(JDataSet(x, y, **kw))
        parts.append(DataSet(x, y, **kw))
    ref = jnet.evaluate(JListDataSetIterator(jparts))
    mine = net.evaluate(ListDataSetIterator(parts))
    _same_eval(mine, ref)
    counted = {"labels_mask": lambda p: p.labels_mask.sum(),
               "features_mask_only": lambda p: p.features_mask.sum(),
               "none": lambda p: p.labels.shape[0] * p.labels.shape[2]}
    assert mine.confusion.total() == int(sum(map(counted[masks], parts)))
