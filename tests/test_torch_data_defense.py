"""The data-plane defense in the port (``datasets/validate.py``) on the
CPU, against the JAX package.

- ``BatchSchema.from_model`` equals JAX's on the same configurations.
- The same reason codes for the same poisoned batches (shape, dtype,
  mask, NaN / Inf, label range, ``max_abs``), from host arrays and from
  tensors alike.
- ``QuarantineStore`` directories written by either package are read by
  the other's (``replay``: the same batches, CRC-verified), and the
  bounded eviction keeps the ledger line.
- ``ValidatingIterator``: rejects quarantined with their stream offsets,
  a poisoned tail ends the stream, ``fast_forward``, the
  ``max_quarantined`` abort.
- The defended trajectory: ``fit`` with a validator over a stream with
  poisoned batches is bitwise the clean run over the surviving batches,
  on both engines and on the trainer with its validation on the
  prefetch worker (``torch.equal``: the same steps on the same values).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.validate import BatchSchema as JSchema
from deeplearning4j_tpu.datasets.validate import (
    BatchValidator as JValidator,
)
from deeplearning4j_tpu.datasets.validate import (
    QuarantineStore as JQuarantine,
)
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.datasets import (
    BatchSchema,
    BatchValidator,
    DataSet,
    ListDataSetIterator,
    QuarantineStore,
    ValidatingIterator,
)
from deeplearning4j_tpu_torch.exceptions import DL4JFaultException
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import DistributedTrainer
from deeplearning4j_tpu_torch.zoo import lenet

SCHEMA = dict(feature_dim=4, label_dim=3, label_range=(0.0, 1.0),
              max_abs=1e3)


def mlp_conf(act="softmax"):
    return (NeuralNetConfiguration.Builder().seed(7).learning_rate(0.05)
            .updater("ADAM").list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation=act))
            .build())


def graph_net():
    conf = (NeuralNetConfiguration.Builder().seed(2).learning_rate(0.1)
            .graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_in=4, n_out=8, activation="tanh"),
                       "in")
            .add_layer("out", OutputLayer(n_in=8, n_out=3), "d")
            .set_outputs("out").build())
    return ComputationGraph(conf, device="cpu").init()


def clean(seed=0, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 4).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)])


def poisoned_cases():
    """(name, features, labels, features mask or None) of each kind of
    poison, and a clean batch."""
    x, y = clean()
    nan, inf, huge = x.copy(), x.copy(), x.copy()
    nan[1, 2] = np.nan
    inf[0, 0] = np.inf
    huge[3, 1] = 5e4
    both = huge.copy()
    both[2, 2] = 1e5
    return [
        ("clean", x, y, None),
        ("wide", np.zeros((8, 5), np.float32), y, None),
        ("rows", x, y[:7], None),
        ("vector", x[:, 0], y, None),
        ("strings", np.array([["a"] * 4] * 8), y, None),
        ("nan", nan, y, None),
        ("inf", inf, y, None),
        ("labels", x, y * 2.0, None),
        ("huge", huge, y, None),
        ("huge_and_labels", both, y * -1.0, None),
        ("nan_labels", x, np.full_like(y, np.nan), None),
        ("mask_rows", x, y, np.ones((7,), np.float32)),
        ("mask_dtype", x, y, np.array(["x"] * 8)),
    ]


@pytest.mark.parametrize("name,x,y,fmask", poisoned_cases(),
                         ids=[c[0] for c in poisoned_cases()])
def test_reason_codes_are_jax(name, x, y, fmask):
    """The same violated reason codes, in the same order, as JAX's
    validator on the same batch, for host arrays; and for tensors where
    the batch has a numeric dtype."""
    want = JValidator(JSchema(**SCHEMA)).validate(
        JDataSet(x, y, features_mask=fmask))
    got = BatchValidator(BatchSchema(**SCHEMA)).validate(
        DataSet(x, y, features_mask=fmask))
    assert got == want
    if name == "clean":
        assert got == []
    if x.dtype.kind == "f" and (fmask is None or fmask.dtype.kind == "f"):
        t = BatchValidator(BatchSchema(**SCHEMA)).validate(DataSet(
            torch.from_numpy(x), torch.from_numpy(y),
            features_mask=None if fmask is None else torch.from_numpy(
                fmask)))
        assert t == want


@pytest.mark.parametrize("which", ["softmax_mlp", "identity_mlp", "lenet"])
def test_schema_from_model_is_jax(which):
    conf = {"softmax_mlp": mlp_conf, "identity_mlp":
            lambda: mlp_conf("identity"), "lenet": lenet}[which]()
    jnet = JNet(JConf.from_dict(conf.to_dict()))
    net = MultiLayerNetwork(conf, device="cpu")
    got, want = BatchSchema.from_model(net), JSchema.from_model(jnet)
    assert got == BatchSchema(**vars(want))
    assert BatchSchema.from_model(graph_net()) == BatchSchema(max_abs=1e6)


def test_quarantine_stores_are_read_by_both_packages(tmp_path):
    x, y = clean()
    bad = x.copy()
    bad[0, 0] = np.nan
    for writer, reader in ((QuarantineStore, JQuarantine),
                           (JQuarantine, QuarantineStore)):
        d = tmp_path / writer.__module__.split(".")[0]
        ds_cls = DataSet if writer is QuarantineStore else JDataSet
        store = writer(d)
        store.put(ds_cls(bad, y), ["non_finite"], offset=3)
        store.put(ds_cls(x, y * 2), ["label_range"], offset=5)
        got = list(reader(d).replay())
        assert [(e["offset"], e["reasons"]) for e, _ in got] == [
            (3, ["non_finite"]), (5, ["label_range"])]
        np.testing.assert_array_equal(got[0][1].features, bad)
        np.testing.assert_array_equal(got[1][1].labels, y * 2)
        assert reader(d).entries() == writer(d).entries()


def test_quarantine_eviction_keeps_the_ledger_and_crc_guards_replay(
        tmp_path):
    x, y = clean()
    store = QuarantineStore(tmp_path / "q", max_bytes=900)
    for i in range(3):
        store.put(DataSet(x, y), ["non_finite"], offset=i)
    ents = store.entries()
    assert len(ents) == 3 and ents[0].get("evicted")
    assert store.total_bytes() <= 900
    store2 = QuarantineStore(tmp_path / "r")
    e = store2.put(DataSet(x, y), ["shape"], offset=0)
    (tmp_path / "r" / e["file"]).write_bytes(b"garbage")
    assert [ds for _, ds in store2.replay()] == [None]
    again = QuarantineStore(tmp_path / "r")
    assert again.put(DataSet(x, y), ["shape"], offset=1)["file"] == \
        "q-00000001.npz"


def test_validating_iterator_filters_ledgers_and_aborts(tmp_path):
    x, y = clean()
    nan = x.copy()
    nan[0, 0] = np.nan
    good = [DataSet(x + i, y) for i in range(4)]
    stream = [good[0], DataSet(nan, y), good[1], good[2],
              DataSet(x, y * 3), good[3], DataSet(nan, y)]
    store = QuarantineStore(tmp_path)
    it = ValidatingIterator(ListDataSetIterator(stream),
                            BatchValidator(BatchSchema(**SCHEMA)),
                            quarantine=store)
    assert list(it) == good
    assert it.skipped_offsets == [1, 4, 6] and it.offset == 7
    assert it.ledger() == {"offset": 7, "skipped": [1, 4, 6], "reasons": {
        "non_finite": 2, "label_range": 1}}
    assert [e["offset"] for e in store.entries()] == [1, 4, 6]
    it.reset()
    it.fast_forward(3)  # a resumed stream: three base batches consumed
    rest = []
    while it.has_next():
        rest.append(it.next())
    assert [r is g for r, g in zip(rest, good[2:])] == [True, True]
    plain = ValidatingIterator(stream[:3], BatchValidator(
        BatchSchema(**SCHEMA)))
    assert list(plain) == good[:2]
    capped = ValidatingIterator(ListDataSetIterator(stream),
                                BatchValidator(BatchSchema(**SCHEMA)),
                                max_quarantined=1)
    with pytest.raises(DL4JFaultException, match="max_quarantined"):
        list(capped)


def _stream(seed=1, n=8, poison_at=(2, 5)):
    rng = np.random.RandomState(seed)
    out, clean_only = [], []
    for i in range(n):
        ds = DataSet(rng.randn(8, 4).astype(np.float32),
                     np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)])
        clean_only.append(ds)
        out.append(ds)
        if i in poison_at:
            bad = ds.features.copy()
            bad[1, 1] = np.nan
            out.append(DataSet(bad, ds.labels))
    return out, clean_only


def _bitwise(a, b):
    assert a.iteration_count == b.iteration_count
    for ln, lp in a.params.items():
        for pn, t in lp.items():
            assert torch.equal(t, b.params[ln][pn]), (ln, pn)
    for ln, lp in a.updater_state.items():
        for pn, tup in lp.items():
            for u, v in zip(tup, b.updater_state[ln][pn]):
                assert torch.equal(u, v)


@pytest.mark.parametrize("engine", ["multilayer", "graph", "trainer"])
def test_defended_trajectory_is_the_clean_run(tmp_path, engine):
    stream, survivors = _stream()
    if engine == "graph":
        ref, net = graph_net(), graph_net()
    else:
        ref = MultiLayerNetwork(mlp_conf(), device="cpu").init()
        net = MultiLayerNetwork(mlp_conf(), device="cpu").init(
            params=ref.params)
    for ds in survivors:
        ref.fit_minibatch(ds)
    store = QuarantineStore(tmp_path)
    validator = BatchValidator(BatchSchema(max_abs=1e6))
    if engine == "trainer":
        DistributedTrainer(net).fit(ListDataSetIterator(stream),
                                    prefetch=2, validator=validator,
                                    quarantine=store)
    else:
        net.set_batch_validator(validator, store)
        net.fit(ListDataSetIterator(stream))
    _bitwise(ref, net)
    assert [e["reasons"] for e in store.entries()] == [["non_finite"]] * 2
    assert [e["offset"] for e in store.entries()] == [3, 7]
