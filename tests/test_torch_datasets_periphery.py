"""The port's dataset readers, model guesser and FLOP accounting against
the JAX package's, on the CPU: the record readers (CSV and collection,
flat and sequence, the MultiDataSet builder), Iris (seeded and from
``DL4J_TPU_IRIS_FILE``), curves, scikit-learn's digits written as IDX
files, and an LFW tree of PIL images give the same arrays for the same
seed; ``load_model_guess`` on a checkpoint zip, a Keras HDF5 file and a
configuration JSON; ``util/flops`` on the profiler's count."""

import json
import os

import h5py
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import curves as j_curves
from deeplearning4j_tpu.datasets import iris as j_iris
from deeplearning4j_tpu.datasets import lfw as j_lfw
from deeplearning4j_tpu.datasets import realdata as j_realdata
from deeplearning4j_tpu.datasets import record_reader as j_rr
from deeplearning4j_tpu_torch.datasets import curves as t_curves
from deeplearning4j_tpu_torch.datasets import iris as t_iris
from deeplearning4j_tpu_torch.datasets import lfw as t_lfw
from deeplearning4j_tpu_torch.datasets import realdata as t_realdata
from deeplearning4j_tpu_torch.datasets import record_reader as t_rr


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_datasets(js, ts):
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        for attr in ("features", "labels", "features_mask", "labels_mask"):
            _same(getattr(j, attr, None), getattr(t, attr, None))


def _drain(it):
    out = []
    while it.has_next():
        out.append(it.next())
    return out


def _csv(tmp_path, rng, name="data.csv", rows=23, skip=1):
    path = tmp_path / name
    lines = ["a,b,c,label"] if skip else []
    for _ in range(rows):
        vals = rng.randn(3)
        lines.append(",".join(f"{v:.6f}" for v in vals)
                     + f",{rng.randint(3)}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("regression", [False, True])
def test_csv_reader_iterator_is_the_jax_ones(tmp_path, regression):
    path = _csv(tmp_path, np.random.RandomState(0))
    kw = dict(label_index=3, num_possible_labels=3, regression=regression)
    js = _drain(j_rr.RecordReaderDataSetIterator(
        j_rr.CSVRecordReader(path, skip_lines=1), 5, **kw))
    ts = _drain(t_rr.RecordReaderDataSetIterator(
        t_rr.CSVRecordReader(path, skip_lines=1), 5, **kw))
    _same_datasets(js, ts)
    assert [len(d.features) for d in ts] == [5, 5, 5, 5, 3]


def test_collection_reader_and_the_bad_label():
    rows = [[0.1, 0.2, 1], [0.3, 0.4, 0], [0.5, 0.6, 2]]
    _same_datasets(
        _drain(j_rr.RecordReaderDataSetIterator(
            j_rr.CollectionRecordReader(rows), 2, 2, 3)),
        _drain(t_rr.RecordReaderDataSetIterator(
            t_rr.CollectionRecordReader(rows), 2, 2, 3)))
    it = t_rr.RecordReaderDataSetIterator(
        t_rr.CollectionRecordReader([[0.1, 5]]), 2, 1, 3)
    with pytest.raises(ValueError, match="outside"):
        it.next()


def test_sequence_readers_pad_and_mask_as_jax(tmp_path):
    rng = np.random.RandomState(1)
    seq_dir = tmp_path / "seqs"
    seq_dir.mkdir()
    for i, t in enumerate((4, 6, 3, 6, 5)):
        _csv(seq_dir, rng, name=f"s{i}.csv", rows=t, skip=0)
    kw = dict(label_index=3, num_possible_labels=3)
    js = _drain(j_rr.SequenceRecordReaderDataSetIterator(
        j_rr.CSVSequenceRecordReader(str(seq_dir)), 2, **kw))
    ts = _drain(t_rr.SequenceRecordReaderDataSetIterator(
        t_rr.CSVSequenceRecordReader(str(seq_dir)), 2, **kw))
    _same_datasets(js, ts)
    assert ts[0].features.shape == (2, 3, 6)
    seqs = [[[0.1, 0.2], [0.3, 0.4]], [[0.5, 0.6], [0.7, 0.8]]]
    _same_datasets(
        _drain(j_rr.SequenceRecordReaderDataSetIterator(
            j_rr.CollectionSequenceRecordReader(seqs), 4)),
        _drain(t_rr.SequenceRecordReaderDataSetIterator(
            t_rr.CollectionSequenceRecordReader(seqs), 4)))


def test_multi_dataset_builder_is_the_jax_one(tmp_path):
    path = _csv(tmp_path, np.random.RandomState(2), rows=7, skip=0)

    def build(rr):
        return (rr.RecordReaderMultiDataSetIterator(3)
                .add_reader("csv", rr.CSVRecordReader(path))
                .add_input("csv", 0, 1).add_input("csv", 2, 2)
                .add_output_one_hot("csv", 3, 3))
    js, ts = _drain(build(j_rr)), _drain(build(t_rr))
    assert len(js) == len(ts) == 3
    for j, t in zip(js, ts):
        for a, b in zip(j.features + j.labels, t.features + t.labels):
            _same(a, b)


@pytest.mark.parametrize("seed,batch,shuffle", [(6, 150, True),
                                                (11, 32, False)])
def test_iris_generator_is_the_jax_one(monkeypatch, seed, batch, shuffle):
    monkeypatch.delenv("DL4J_TPU_IRIS_FILE", raising=False)
    for a, b in zip(j_iris.load_iris(seed), t_iris.load_iris(seed)):
        _same(a, b)
    _same_datasets(
        _drain(j_iris.IrisDataSetIterator(batch, 120, seed, shuffle)),
        _drain(t_iris.IrisDataSetIterator(batch, 120, seed, shuffle)))


def test_iris_file_is_read_as_jax_reads_it(monkeypatch, tmp_path):
    rng = np.random.RandomState(3)
    names = ("Iris-setosa", "Iris-versicolor", "Iris-virginica")
    path = tmp_path / "iris.data"
    path.write_text("".join(
        ",".join(f"{v:.1f}" for v in rng.rand(4) * 7) + f",{names[i % 3]}\n"
        for i in range(30)) + "\n")
    monkeypatch.setenv("DL4J_TPU_IRIS_FILE", str(path))
    x, y = t_iris.load_iris()
    for a, b in zip(j_iris.load_iris(), (x, y)):
        _same(a, b)
    assert x.shape == (30, 4) and y.sum() == 30


def test_curves_are_the_jax_ones(tmp_path):
    kw = dict(num_examples=40, data_dir=str(tmp_path), seed=5,
              allow_synthetic=True)
    _same_datasets(_drain(j_curves.CurvesDataSetIterator(16, **kw)),
                   _drain(t_curves.CurvesDataSetIterator(16, **kw)))
    feats = np.random.RandomState(0).rand(10, 784).astype(np.float32)
    np.savez(tmp_path / "curves.npz", features=feats)
    it = t_curves.CurvesDataSetIterator(4, data_dir=str(tmp_path))
    assert not it.synthetic and it.total_examples() == 10
    _same(it.next().features, feats[:4])
    with pytest.raises(Exception):
        t_curves.CurvesDataSetIterator(4, data_dir=str(tmp_path / "none"),
                                       allow_synthetic=False)


def test_digits_idx_files_are_the_jax_ones_and_read_as_mnist(tmp_path):
    jd = j_realdata.ensure_digits_idx(str(tmp_path / "jax"))
    td = t_realdata.ensure_digits_idx(str(tmp_path / "torch"))
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td)) and len(names) == 5
    for name in names:
        with open(os.path.join(jd, name), "rb") as a, \
                open(os.path.join(td, name), "rb") as b:
            assert a.read() == b.read(), name
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator

    ds = MnistDataSetIterator(100, train=True, data_dir=td).next()
    assert ds.features.shape == (100, 784) and ds.labels.shape == (100, 10)
    assert t_realdata.ensure_digits_idx(td) == td  # written once


def _lfw_tree(root):
    from PIL import Image

    rng = np.random.RandomState(4)
    for p, person in enumerate(("Ada_Lovelace", "Alan_Turing",
                                "Grace_Hopper")):
        d = root / person
        d.mkdir(parents=True)
        for i in range(3 + p):
            arr = rng.randint(0, 256, (20, 16, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{person}_{i + 1:04d}.png")
    (root / "README.txt").write_text("not a person")


@pytest.mark.parametrize("kw", [
    dict(img_dim=(12, 10, 3)),
    dict(img_dim=(8, 8, 1), num_labels=2, flat=True),
    dict(img_dim=(12, 10, 3), split_train_test=0.5, train=False, seed=7),
])
def test_lfw_tree_gives_the_jax_arrays(tmp_path, kw):
    _lfw_tree(tmp_path / "lfw" / "lfw")
    root = str(tmp_path / "lfw")
    j = j_lfw.LFWDataSetIterator(4, data_dir=root, **kw)
    t = t_lfw.LFWDataSetIterator(4, data_dir=root, **kw)
    assert t.labels == j.labels
    _same_datasets(_drain(j), _drain(t))
    with pytest.raises(FileNotFoundError):
        t_lfw.LFWDataSetIterator(4, data_dir=str(tmp_path / "none"))


# --- the model guesser ----------------------------------------------------------


def test_guess_a_checkpoint_zip(tmp_path):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.model_guesser import load_model_guess
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    from deeplearning4j_tpu_torch.zoo import lenet

    net = MultiLayerNetwork(lenet(), device="cpu").init()
    path = str(tmp_path / "lenet.zip")
    write_model(net, path)
    got = load_model_guess(path, device="cpu")
    assert type(got) is MultiLayerNetwork
    x = np.random.RandomState(0).rand(2, 784).astype(np.float32)
    torch.testing.assert_close(got.output(x), net.output(x))


def test_guess_a_keras_h5_file(tmp_path):
    from deeplearning4j_tpu_torch.util.model_guesser import load_model_guess

    rng = np.random.RandomState(1)
    cfg = json.dumps({"class_name": "Sequential", "config": [
        {"class_name": "Dense", "config": {
            "name": "d1", "output_dim": 3, "activation": "softmax",
            "batch_input_shape": [None, 4]}}]})
    w, b = rng.randn(4, 3).astype(np.float32), np.zeros(3, np.float32)
    path = str(tmp_path / "m.h5")
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = np.bytes_(cfg)
        g = f.create_group("model_weights").create_group("d1")
        g.create_dataset("d1_W", data=w)
        g.create_dataset("d1_b", data=b)
    net = load_model_guess(path, device="cpu")
    np.testing.assert_array_equal(net.params["d1"]["W"].numpy(), w)


def test_guess_a_configuration_json_and_refuse_the_rest(tmp_path):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.model_guesser import (
        ModelGuessingException,
        config_guess,
        load_model_guess,
    )
    from deeplearning4j_tpu_torch.zoo import lenet, vgg16

    path = tmp_path / "conf.json"
    path.write_text(lenet().to_json())
    net = load_model_guess(str(path), device="cpu")
    assert type(net) is MultiLayerNetwork and net.params is None
    graph = config_guess(vgg16().to_json(), device="cpu")
    assert type(graph) is ComputationGraph
    with pytest.raises(ModelGuessingException, match="format"):
        config_guess({"format": "nope"})
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\xff\xfe\x00garbage")
    with pytest.raises(ModelGuessingException):
        load_model_guess(str(bad))
    with pytest.raises(FileNotFoundError):
        load_model_guess(str(tmp_path / "missing"))


# --- FLOPs ----------------------------------------------------------------------


def test_flops_reads_the_profilers_peak_and_count():
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.observability import profiler
    from deeplearning4j_tpu_torch.util import flops
    from deeplearning4j_tpu_torch.zoo import lenet

    if not torch.cuda.is_available():
        assert flops.device_peak_flops() == (None, "cpu")
    assert flops.device_peak_flops.__module__.endswith("util.flops")
    net = MultiLayerNetwork(lenet(), device="cpu").init()
    rng = np.random.RandomState(0)
    ds = DataSet(rng.rand(8, 784).astype(np.float32),
                 np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)])
    got = flops.train_step_cost(net, ds)
    assert got == profiler.train_step_cost(net, ds)
    assert got["batch"] == 8 and got["flops"] > 0
    assert got["flops_per_example"] == got["flops"] / 8


def test_flops_of_an_arbitrary_callable():
    from deeplearning4j_tpu_torch.ops import matmul_block
    from deeplearning4j_tpu_torch.util import flops

    x, w = torch.randn(16, 32), torch.randn(32, 8)
    got = flops.jit_cost(lambda a, b: torch.relu(a @ b), x, w)
    assert got["flops"] == 2 * 16 * 32 * 8
    assert got["bytes_accessed"] == 4 * (16 * 32 + 32 * 8 + 16 * 8)
    # a kernel wrapper takes its plain version on meta tensors
    got = flops.jit_cost(lambda a, b: matmul_block(a, b, activation="relu"),
                         x, w)
    assert got["flops"] == 2 * 16 * 32 * 8
