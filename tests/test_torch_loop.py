"""The continuous-learning loop in the port (``deeplearning4j_tpu_torch.
loop``) against the JAX package, on the CPU.

One counterpart of every test of ``tests/test_loop.py`` (the journal,
prune protection, the publish cadence, kill / resume bitwise, the shadow
scorer, server mirroring, reload no-op / skip / by step, promote and
seal, reject, quarantine, a failed canary, a kill mid-promotion, the
rollback with zero new shapes, recovery), each scenario written once
over a namespace (``JAX`` or ``PORT``) so the parity tests can run it in
both packages on the same seeded data and hold the port to JAX's:

- the journal's history (state, candidate / previous / promoted step,
  probation, reason) and its rejected and quarantined steps, identical;
- the shadow counters (``requests``, ``shadowed``, ``rows``,
  ``agree_rows``) and ``agreement_rows``, equal;
- the parameters after each publish of a small conv net carried across
  (``params_from_numpy``), within ``kernel_tols``;
- a journal written by one package, read by the other.

Port nets start from the JAX net's weights of the same seed. The port's
checkpoint managers carry no ``device=`` (their default is the card),
so every restore the loop makes must name the server's device itself.
Servers stop in ``finally``; waits poll with a deadline.
"""

import json
import os
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.api import (
    ListDataSetIterator as JListDataSetIterator,
)
from deeplearning4j_tpu.loop import ContinualTrainer as JContinualTrainer
from deeplearning4j_tpu.loop import Promoter as JPromoter
from deeplearning4j_tpu.loop import PromotionGates as JPromotionGates
from deeplearning4j_tpu.loop import PromotionJournal as JPromotionJournal
from deeplearning4j_tpu.loop import ShadowScorer as JShadowScorer
from deeplearning4j_tpu.loop import SimulatedKill as JSimulatedKill
from deeplearning4j_tpu.loop import agreement_rows as jagreement_rows
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.resilience import (
    CheckpointManager as JCheckpointManager,
)
from deeplearning4j_tpu.serving.batcher import BucketLadder as JBucketLadder
from deeplearning4j_tpu.serving.server import ModelServer as JModelServer
from deeplearning4j_tpu_torch.datasets import (
    BatchSchema,
    BatchValidator,
    DataSet,
    ListDataSetIterator,
    QuarantineStore,
)
from deeplearning4j_tpu_torch.loop import (
    ContinualTrainer,
    Promoter,
    PromotionGates,
    PromotionJournal,
    ShadowScorer,
    SimulatedKill,
    agreement_rows,
)
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import DistributedTrainer
from deeplearning4j_tpu_torch.resilience.chaos import PoisonIterator
from deeplearning4j_tpu_torch.resilience.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.resilience.preemption import (
    PreemptedException,
    PreemptionHandler,
    active_handler,
)
from deeplearning4j_tpu_torch.serving import ModelServer
from deeplearning4j_tpu_torch.serving.batcher import BucketLadder
from deeplearning4j_tpu_torch.serving.registry import (
    fault_in,
    weights_on_host,
)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    params_to_numpy,
    updater_state_to_numpy,
)

CHAOS_SEED = int(os.environ.get("DL4J_TPU_CHAOS_SEED", "1337"))
DEAD = 3  # feature column the regression bomb keys on
WAIT_S = 20.0


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _jconf(seed):
    return (JNeuralNetConfiguration.Builder()
            .seed(seed).learning_rate(0.05).updater("ADAM")
            .list()
            .layer(JDense(n_in=4, n_out=8, activation="tanh"))
            .layer(JOutput(n_out=3))
            .build())


def jax_net(seed=7):
    return JMultiLayerNetwork(_jconf(seed)).init()


def port_net(seed=7):
    """The port's twin of ``jax_net(seed)``, on the CPU."""
    jnet = jax_net(seed)
    return MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jnet.conf.to_dict()), device="cpu").init(
            params=params_from_numpy(_flat(jnet.params), "cpu"))


def _jax_set(net, layer, name, value):
    import jax.numpy as jnp

    net.params[layer][name] = jnp.asarray(value)


def _port_set(net, layer, name, value):
    net.params[layer][name] = torch.from_numpy(np.asarray(value))


# the two packages behind one interface: each scenario runs in either
JAX = SimpleNamespace(
    name="jax", net=jax_net, DataSet=JDataSet,
    ListDataSetIterator=JListDataSetIterator,
    ContinualTrainer=JContinualTrainer, Promoter=JPromoter,
    PromotionGates=JPromotionGates, PromotionJournal=JPromotionJournal,
    SimulatedKill=JSimulatedKill, ShadowScorer=JShadowScorer,
    manager=JCheckpointManager, restore_kw={},
    server=lambda mgr, **kw: JModelServer(checkpoint_manager=mgr, **kw),
    set_param=_jax_set)
PORT = SimpleNamespace(
    name="port", net=port_net, DataSet=DataSet,
    ListDataSetIterator=ListDataSetIterator,
    ContinualTrainer=ContinualTrainer, Promoter=Promoter,
    PromotionGates=PromotionGates, PromotionJournal=PromotionJournal,
    SimulatedKill=SimulatedKill, ShadowScorer=ShadowScorer,
    manager=CheckpointManager, restore_kw={"device": "cpu"},
    server=lambda mgr, **kw: ModelServer(checkpoint_manager=mgr,
                                         device="cpu", **kw),
    set_param=_port_set)


def batches(pkg, rng, n_batches=8, batch=8, dead_zero=True):
    out = []
    for _ in range(n_batches):
        x = rng.randn(batch, 4).astype(np.float32)
        if dead_zero:
            x[:, DEAD] = 0.0
        y = np.eye(3)[rng.randint(0, 3, batch)].astype(np.float32)
        out.append(pkg.DataSet(features=x, labels=y))
    return out


def stream(pkg, rng, n_batches):
    return pkg.ListDataSetIterator(batches(pkg, rng, n_batches))


def feats(rng, rows=2, shifted=False):
    x = rng.randn(rows, 4).astype(np.float32)
    x[:, DEAD] = (rng.randn(rows).astype(np.float32) * 8.0
                  if shifted else 0.0)
    return x


def make_server(pkg, manager, **kw):
    kw.setdefault("workers", 2)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("aot", False)
    return pkg.server(manager, **kw).start()


def fast_gates(pkg, **kw):
    kw.setdefault("min_shadow_requests", 3)
    kw.setdefault("min_agreement", 0.5)
    kw.setdefault("probation_requests", 2)
    kw.setdefault("probation_min_seconds", 0.0)
    return pkg.PromotionGates(**kw)


def wait_until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def drive(server, rng, n=4, shifted=False, rows=2):
    """n sequential predicts, every one answered 200; then wait until
    the installed scorer (if any) has mirrored all of them (the mirror
    runs just after each response, and every scorer here mirrors all
    traffic), so the next poll judges the same evidence every run."""
    sh = server.shadow
    base = sh.snapshot()["requests"] if sh is not None else 0
    for _ in range(n):
        code, body, _ = server.submit(feats(rng, rows=rows,
                                            shifted=shifted))
        assert code == 200, body
    if sh is not None:
        def mirrored():
            s = sh.snapshot()
            return s["requests"] >= base + n and s["shadowed"] == s[
                "requests"]
        wait_until(mirrored, "the shadow to mirror the traffic")


def journal_view(doc):
    """The journal with its timestamps left out."""
    keys = ("candidate_step", "previous_step", "promoted_step",
            "probation", "reason")
    return {
        "state": doc["state"],
        "gates_passed": doc["gates_passed"],
        "rejected_steps": doc["rejected_steps"],
        "quarantined_steps": doc["quarantined_steps"],
        **{k: doc[k] for k in keys},
        "history": [tuple([h["state"]] + [h.get(k) for k in keys])
                    for h in doc["history"]],
    }


# -- promotion journal --------------------------------------------------


def test_journal_roundtrip_and_history(tmp_path):
    j = PromotionJournal(tmp_path / "j.json")
    assert j.read()["state"] == "idle"
    j.write("shadowing", candidate_step=12, previous_step=8)
    j.write("canarying", gates_passed=True)
    doc = j.read()
    assert doc["state"] == "canarying" and doc["gates_passed"]
    assert doc["candidate_step"] == 12 and doc["previous_step"] == 8
    assert [h["state"] for h in doc["history"]] == ["shadowing",
                                                    "canarying"]
    with pytest.raises(ValueError):
        j.write("exploded")


def test_journal_corrupt_reads_empty(tmp_path):
    p = tmp_path / "j.json"
    p.write_text("{torn")
    j = PromotionJournal(p)
    assert j.read()["state"] == "idle"
    j.write("promoted", promoted_step=4)
    assert j.read()["promoted_step"] == 4


def test_journal_referenced_and_skip_steps(tmp_path):
    j = PromotionJournal(tmp_path / "j.json")
    j.write("shadowing", candidate_step=12, previous_step=8,
            promoted_step=8)
    assert j.referenced_steps() == [12, 8]
    j.write("rolled_back", rejected_steps=[12])
    j.write("quarantined", quarantined_steps=[16])
    j.write("quarantined", quarantined_steps=[16])  # merge, not dup
    assert sorted(j.skip_steps()) == [12, 16]
    assert j.read()["quarantined_steps"] == [16]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_written_by_one_package_reads_in_the_other(writer,
                                                           tmp_path):
    path = tmp_path / "j.json"
    w_cls, r_cls = ((JPromotionJournal, PromotionJournal) if writer == "jax"
                    else (PromotionJournal, JPromotionJournal))
    w = w_cls(path)
    w.write("shadowing", candidate_step=12, previous_step=8,
            promoted_step=8)
    w.write("rolled_back", rejected_steps=[12], reason="agreement 0.5 < 0.9")
    w.write("quarantined", quarantined_steps=[16])
    w.write("promoted", promoted_step=20, previous_step=8, probation=True)
    r = r_cls(path)
    assert r.read() == w.read() == json.loads(path.read_text())
    assert r.state == "promoted"
    assert r.referenced_steps() == w.referenced_steps() == [12, 8, 20]
    assert r.skip_steps() == w.skip_steps() == [12, 16]
    r.write("promoted", probation=False)  # and the reader writes on
    assert w.read()["history"][-1]["state"] == "promoted"
    assert not w.read()["probation"]


def test_journal_history_is_bounded_and_state_codes_match_jax(tmp_path):
    from deeplearning4j_tpu.loop import journal as jjournal
    from deeplearning4j_tpu_torch.loop import journal

    j = PromotionJournal(tmp_path / "j.json")
    for i in range(40):
        j.write("candidate", candidate_step=i)
    hist = j.read()["history"]
    assert len(hist) == journal.HISTORY_LIMIT == jjournal.HISTORY_LIMIT
    assert hist[-1]["candidate_step"] == 39
    assert journal.STATE_CODES == jjournal.STATE_CODES
    assert journal.state_code(None) == 0
    assert journal.state_code("quarantined") == jjournal.state_code(
        "quarantined")


# -- checkpoint store satellites ----------------------------------------


def test_checkpoint_list_and_latest_step(rng, tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=10)
    assert mgr.list_steps() == [] and mgr.latest_step() is None
    net = port_net()
    for ds in batches(PORT, rng, 3):
        net.fit_minibatch(ds)
        mgr.save(net)
    assert mgr.list_steps() == [1, 2, 3]
    assert mgr.latest_step() == 3 == mgr.last_step()


def test_prune_never_deletes_journal_referenced_step(rng, tmp_path):
    j = PromotionJournal(tmp_path / "j.json")
    mgr = CheckpointManager(tmp_path / "ckpts", keep_last=2,
                            protect=j.referenced_steps)
    net = port_net()
    net.fit_minibatch(batches(PORT, rng, 1)[0])
    mgr.save(net)
    j.write("promoted", promoted_step=1, previous_step=1)
    for ds in batches(PORT, rng, 4):
        net.fit_minibatch(ds)
        mgr.save(net)
    assert mgr.list_steps() == [1, 4, 5]
    j.write("promoted", promoted_step=5, previous_step=4)
    net.fit_minibatch(batches(PORT, rng, 1)[0])
    mgr.save(net)
    assert 1 not in mgr.list_steps()


# -- continual trainer --------------------------------------------------


def test_continual_trainer_publish_cadence(rng, tmp_path):
    reg = MetricsRegistry()
    ct = ContinualTrainer(
        port_net(), CheckpointManager(tmp_path, keep_last=10),
        publish_every=3, registry=reg,
        artifact_fn=lambda m: {"stub": b"blob"})
    assert ct.run(stream(PORT, rng, 7)) == 7
    assert ct.manager.list_steps() == [3, 6, 7]  # trailing published
    assert ct.last_published.step == 7
    assert ct.last_published.artifacts["stub"]["size"] == 4
    assert reg.get("loop_published_total").value == 3
    assert reg.get("loop_train_steps_total").value == 7
    assert reg.get("loop_published_step").value == 7


def _same_bits(a, b):
    for k, v in params_to_numpy(a.params).items():
        np.testing.assert_array_equal(params_to_numpy(b.params)[k], v,
                                      err_msg=k)
    for k, v in updater_state_to_numpy(a.updater_state).items():
        np.testing.assert_array_equal(
            updater_state_to_numpy(b.updater_state)[k], v, err_msg=k)


def test_continual_trainer_kill_resume_bitwise(rng, tmp_path):
    data = batches(PORT, rng, 8)
    full = port_net()
    for ds in data:
        full.fit_minibatch(ds)
    ct = ContinualTrainer(port_net(), CheckpointManager(tmp_path),
                          publish_every=2)
    ct.run(ListDataSetIterator(data), max_steps=5)
    del ct  # the kill: steps 1..5 ran, step 4 and the trailing 5 published
    survivor = port_net()
    ct2 = ContinualTrainer(survivor, CheckpointManager(tmp_path),
                           publish_every=2)
    assert ct2.resume() == 5
    assert ct2.last_published.step == 5
    ct2.run(ListDataSetIterator(data[5:]))
    assert survivor.iteration_count == full.iteration_count == 8
    _same_bits(full, survivor)


def test_continual_trainer_resume_on_an_empty_store_is_a_fresh_start(
        tmp_path):
    ct = ContinualTrainer(port_net(), CheckpointManager(tmp_path))
    assert ct.resume() == 0 and ct.last_published is None
    with pytest.raises(ValueError):
        ContinualTrainer(port_net(), CheckpointManager(tmp_path),
                         publish_every=0)


SCHEMA = BatchSchema(feature_dim=4, label_dim=3, label_range=(0.0, 1.0),
                     max_abs=1e6)


def test_continual_trainer_kill_resume_mid_poison_bitwise(tmp_path):
    """A run dies between publishes while quarantining: the published
    manifest's data ledger fast-forwards the resumed stream past every
    base batch already fit or quarantined, and the resumed run lands
    bitwise on the clean trajectory."""
    rng = np.random.RandomState(CHAOS_SEED + 7)
    bs = batches(PORT, rng, 12, dead_zero=False)
    poison = {1: "huge_values", 4: "wrong_dtype", 8: "label_range"}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    store = QuarantineStore(tmp_path / "q")
    ct1 = ContinualTrainer(port_net(), mgr, publish_every=2,
                           validator=BatchValidator(SCHEMA),
                           quarantine=store)
    ct1.run(PoisonIterator(ListDataSetIterator(bs), poison=poison),
            max_steps=5, publish_trailing=False)
    assert mgr.latest_step() == 4
    m2 = port_net()
    ct2 = ContinualTrainer(m2, mgr, publish_every=2,
                           validator=BatchValidator(SCHEMA),
                           quarantine=store)
    assert ct2.resume() == 4
    assert m2._data_ledger["offset"] == 6
    assert m2._data_ledger["skipped"] == [1, 4]
    ct2.run(PoisonIterator(ListDataSetIterator(bs), poison=poison))
    assert m2._data_ledger["skipped"] == [1, 4, 8]
    assert m2._data_ledger["reasons"] == {"magnitude": 1, "dtype": 1,
                                          "label_range": 1}
    clean = port_net()
    for i, b in enumerate(bs):
        if i not in poison:
            clean.fit_minibatch(b)
    assert m2.iteration_count == clean.iteration_count == 9
    _same_bits(clean, m2)


def test_continual_trainer_over_a_distributed_trainer_bitwise(rng,
                                                              tmp_path):
    """Over a ``DistributedTrainer`` (a world of one process: its step
    is the engine's) the publishes are bitwise the engine path's, and
    ``resume`` goes through the trainer."""
    data = batches(PORT, rng, 6)
    a = port_net()
    ContinualTrainer(a, CheckpointManager(tmp_path / "a"),
                     publish_every=3).run(ListDataSetIterator(data))
    b = port_net()
    ct = ContinualTrainer(b, CheckpointManager(tmp_path / "b"),
                          publish_every=3, trainer=DistributedTrainer(b))
    ct.run(ListDataSetIterator(data[:4]), publish_trailing=False)
    assert ct.manager.list_steps() == [3]
    c = port_net()
    ct2 = ContinualTrainer(c, CheckpointManager(tmp_path / "b"),
                           publish_every=3, trainer=DistributedTrainer(c))
    assert ct2.resume() == 3
    ct2.run(ListDataSetIterator(data[3:]))
    assert ct2.manager.list_steps() == [3, 6]
    _same_bits(a, c)


def test_continual_trainer_async_publish_resumes_exactly(rng, tmp_path):
    data = batches(PORT, rng, 12)
    ref = port_net()
    for ds in data:
        ref.fit_minibatch(ds)
    mgr_a = CheckpointManager(tmp_path, mode="async", keep_last=5)
    tr_a = ContinualTrainer(port_net(), mgr_a, publish_every=4)
    tr_a.run(data[:6], publish_trailing=False)
    assert tr_a.last_published.step == 4
    mgr_a.stop()
    assert mgr_a.latest_step() == 4
    net_b = port_net()
    mgr_b = CheckpointManager(tmp_path, mode="async", keep_last=5)
    tr_b = ContinualTrainer(net_b, mgr_b, publish_every=4)
    assert tr_b.resume() == 4
    tr_b.run(data[4:], publish_trailing=False)
    mgr_b.stop()
    _same_bits(ref, net_b)
    assert mgr_b.latest_step() == 12


class NotifyAt:
    """Fires the simulated preemption notice once, at step ``at``."""

    def __init__(self, at):
        self.at = at
        self.fired = False

    def iteration_done(self, model, it):
        if it == self.at and not self.fired:
            self.fired = True
            active_handler().notify("chaos")


def test_preemption_publishes_through_the_trainer(tmp_path):
    rng = np.random.RandomState(CHAOS_SEED + 2)
    mgr = CheckpointManager(str(tmp_path))
    m = port_net()
    ct = ContinualTrainer(m, mgr, publish_every=100,  # only the emergency
                          artifact_fn=lambda model: {
                              "aot-output-b4": b"stub-bytes"})
    m.listeners.append(NotifyAt(3))
    with PreemptionHandler():
        with pytest.raises(PreemptedException) as exc:
            ct.run(stream(PORT, rng, 12))
    info = exc.value.checkpoint
    assert info is not None and info.step == 3
    assert mgr.load_artifact(info, "aot-output-b4") == b"stub-bytes"
    assert ct.last_published.step == 3


def test_run_span_goes_to_the_tracer(rng, tmp_path):
    from deeplearning4j_tpu_torch.observability.trace import (
        Tracer,
        set_global_tracer,
    )

    tracer = Tracer(seed=1)
    before = set_global_tracer(tracer)
    try:
        ct = ContinualTrainer(port_net(), CheckpointManager(tmp_path),
                              publish_every=2)
        ct.run(stream(PORT, rng, 3))
    finally:
        set_global_tracer(before)
    span = next(s for s in tracer.finished_spans()
                if s.name == "train.continual.run")
    assert span.attrs["start_step"] == 0 and span.attrs["steps"] == 3
    assert span.attrs["publish_every"] == 2


def _conv_jconf():
    """A small conv net (conv 3x3 relu, max pool, dense relu, softmax)
    on 6 x 6 images, SGD: its trajectory agrees within kernel_tols (Adam
    would amplify f32 summation-order noise, tests/test_torch_training
    .py)."""
    return (JNeuralNetConfiguration.Builder().seed(4).updater("SGD")
            .learning_rate(0.05).list()
            .layer(JConv(n_out=4, kernel_size=(3, 3), activation="relu"))
            .layer(JPool(pooling_type="MAX"))
            .layer(JDense(n_out=8, activation="relu"))
            .layer(JOutput(n_out=3, loss="MCXENT"))
            .set_input_type(JInputType.convolutional_flat(6, 6, 1))
            .build())


def test_published_params_match_jax_at_every_publish(tmp_path):
    jnet = JMultiLayerNetwork(_conv_jconf()).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jnet.conf.to_dict()), device="cpu").init(
            params=params_from_numpy(_flat(jnet.params), "cpu"))
    rng = np.random.RandomState(21)
    data = [((rng.rand(8, 36) * 0.9 + 0.05).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)])
            for _ in range(7)]
    JContinualTrainer(jnet, JCheckpointManager(tmp_path / "jax",
                                               keep_last=10),
                      publish_every=2).run(JListDataSetIterator(
                          [JDataSet(x, y) for x, y in data]))
    ct = ContinualTrainer(net, CheckpointManager(tmp_path / "port",
                                                 keep_last=10),
                          publish_every=2)
    ct.run(ListDataSetIterator([DataSet(x, y) for x, y in data]))
    # the port's manager reads the JAX package's store as well
    jstore = CheckpointManager(tmp_path / "jax", device="cpu")
    assert jstore.list_steps() == ct.manager.list_steps() == [2, 4, 6, 7]
    rtol, atol = kernel_tols()
    for jinfo, info in zip(jstore.available(), ct.manager.available()):
        ref = jstore.restore(jinfo, load_updater=False)
        got = ct.manager.restore(info, load_updater=False, device="cpu")
        assert got.iteration_count == ref.iteration_count == info.step
        for k, v in params_to_numpy(ref.params).items():
            np.testing.assert_allclose(params_to_numpy(got.params)[k], v,
                                       rtol=rtol, atol=atol,
                                       err_msg=f"step {info.step} {k}")


# -- shadow scorer ------------------------------------------------------


def test_shadow_identical_model_full_agreement(rng):
    net = port_net()
    reg = MetricsRegistry()
    sc = ShadowScorer(net, fraction=1.0, seed=CHAOS_SEED, registry=reg)
    for _ in range(4):
        x = feats(rng)
        sc.observe(x, net.output(x), live_ms=1.0)
    snap = sc.snapshot()
    assert snap["shadowed"] == 4 and snap["agreement"] == 1.0
    assert snap["errors"] == 0 and snap["p99_delta_ms"] is not None
    assert reg.get("shadow_predicts_total").value == 4
    assert reg.get("shadow_agreement").value == 1.0
    assert len(sc.samples()) > 0


def test_shadow_detects_disagreement_and_never_raises(rng):
    class Hostile:
        def output(self, x):
            raise RuntimeError("shadow fault")

    live = port_net(seed=1)
    x = feats(rng, rows=8)
    out = live.output(x).numpy()
    sc = ShadowScorer(port_net(seed=2), fraction=1.0, seed=CHAOS_SEED)
    sc.observe(x, out)
    assert sc.snapshot()["agreement"] is not None
    bad = ShadowScorer(Hostile(), fraction=1.0, seed=CHAOS_SEED)
    bad.observe(x, out)  # must not raise
    assert bad.snapshot()["errors"] == 1
    nan = ShadowScorer(port_net(), fraction=1.0, seed=CHAOS_SEED)
    nan.observe(x, np.full_like(out, np.nan))
    assert nan.snapshot()["live_nonfinite"] == 1
    # a fault before the mirror (unreadable features) is a counter too
    bad.observe(object(), out)
    assert bad.snapshot()["errors"] == 2
    assert not bad.warmup(x)


def test_shadow_sampling_is_seeded(rng):
    net = port_net()
    x = feats(rng)
    out = net.output(x)

    def run():
        sc = ShadowScorer(net, fraction=0.5, seed=CHAOS_SEED)
        for _ in range(20):
            sc.observe(x, out)
        return sc.snapshot()["shadowed"]

    a, b = run(), run()
    assert a == b and 0 < a < 20
    with pytest.raises(ValueError):
        ShadowScorer(net, fraction=1.5)


def test_shadow_forward_runs_the_ladder_bucket(rng):
    net = port_net()
    seen = []
    orig = net.output_padded

    def spy(x, n_valid):
        seen.append((tuple(np.shape(x)), n_valid))
        return orig(x, n_valid=n_valid)

    net.output_padded = spy
    sc = ShadowScorer(net, fraction=1.0, seed=0,
                      ladder=BucketLadder([1, 4, 8]))
    x = feats(rng, rows=3)
    sc.observe(x, net.output(x))
    assert seen == [((4, 4), 3)]  # padded to bucket 4, 3 rows valid
    assert sc.snapshot()["agreement"] == 1.0


def test_shadow_counters_match_jax():
    """The same live traffic offered to the JAX and the port scorer
    (candidate: the same seed-2 weights in each) mirrors the same
    requests and counts the same agreeing rows."""
    jlive, jcand, cand = jax_net(seed=1), jax_net(seed=2), port_net(seed=2)
    scorers = [
        JShadowScorer(jcand, fraction=0.5, seed=CHAOS_SEED,
                      ladder=JBucketLadder([1, 2, 4])),
        ShadowScorer(cand, fraction=0.5, seed=CHAOS_SEED,
                     ladder=BucketLadder([1, 2, 4]))]
    rng = np.random.RandomState(5)
    for i in range(24):
        x = feats(rng, rows=1 + i % 3, shifted=bool(i % 2))
        live = np.asarray(jlive.output(x))
        if i == 7:
            live = np.full_like(live, np.nan)
        for sc in scorers:
            sc.observe(x, live, live_ms=1.0)
    ref, mine = (sc.snapshot() for sc in scorers)
    for k in ("requests", "shadowed", "rows", "agree_rows", "errors",
              "live_nonfinite", "agreement"):
        assert mine[k] == ref[k], k
    assert 0 < mine["agree_rows"] < mine["rows"]
    np.testing.assert_array_equal(scorers[1].samples(),
                                  scorers[0].samples())


@pytest.mark.parametrize("case", ["classes", "vector", "column", "3d",
                                  "ragged"])
def test_agreement_rows_matches_jax(case):
    rng = np.random.RandomState(sum(map(ord, case)))
    a = {"classes": rng.rand(9, 4), "vector": rng.rand(5),
         "column": rng.rand(7, 1), "3d": rng.rand(4, 2, 3),
         "ragged": rng.rand(6, 3)}[case].astype(np.float32)
    b = a.copy()
    flat = b.reshape(-1)
    flat[::3] += 1e-3  # some rows off by more than the tolerance
    if case == "ragged":
        b = b[:4]
    got = agreement_rows(a, b)
    assert got == jagreement_rows(a, b)
    assert agreement_rows(torch.from_numpy(a), b) == got
    assert agreement_rows(a, b, tol=1e-2) == jagreement_rows(a, b, tol=1e-2)
    assert agreement_rows(a[:0], b[:0]) == jagreement_rows(a[:0], b[:0])


def test_server_mirrors_to_shadow_results_unchanged(rng, tmp_path):
    net = port_net()
    net.iteration_count = 1
    mgr = CheckpointManager(tmp_path)
    mgr.save(net)
    s = make_server(PORT, mgr)
    try:
        x = feats(rng)
        want = s.submit(x)[1]["output"]
        sc = ShadowScorer(port_net(seed=99), fraction=1.0, seed=CHAOS_SEED)
        s.set_shadow(sc)
        code, body, _ = s.submit(x)
        assert code == 200 and body["output"] == want
        wait_until(lambda: sc.snapshot()["shadowed"] >= 1, "the mirror")
        assert sc.snapshot()["shadowed"] == 1
        # the live forward's own ms rides along for the latency gate
        assert sc.snapshot()["live_p99_ms"] is not None
        s.set_shadow(None)
        code, _, _ = s.submit(x)
        assert code == 200
        assert sc.snapshot()["requests"] == 1  # uninstalled = silent
    finally:
        s.stop(drain_timeout=1)


# -- reload idempotence + reload-by-step --------------------------------


def test_reload_same_step_is_counted_noop(tmp_path):
    net = port_net()
    net.iteration_count = 1
    mgr = CheckpointManager(tmp_path)
    mgr.save(net)
    s = make_server(PORT, mgr)
    try:
        warmups = s.metrics.get("warmup_predicts_total")
        code, body = s.reload({})
        assert code == 200 and body["status"] == "skipped"
        assert body["step"] == 1 and s.model_version == 1
        assert s.metrics.get("reload_skipped_total") == 1
        assert s.metrics.get("reload_total") == 0
        assert s.metrics.get("warmup_predicts_total") == warmups
        code, body = s.reload({"force": True})
        assert code == 200 and body["status"] == "reloaded"
        assert s.model_version == 2
        net.iteration_count = 2
        mgr.save(net)
        code, body = s.reload({})
        assert code == 200 and body["status"] == "reloaded"
        assert s._watched_step == 2
    finally:
        s.stop(drain_timeout=1)


def test_reload_skip_over_http(tmp_path):
    net = port_net()
    net.iteration_count = 1
    mgr = CheckpointManager(tmp_path)
    mgr.save(net)
    s = make_server(PORT, mgr)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{s.port}/admin/reload", data=b"{}")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
            assert json.loads(r.read())["status"] == "skipped"
    finally:
        s.stop(drain_timeout=1)


def test_reload_specific_step(rng, tmp_path):
    net = port_net()
    mgr = CheckpointManager(tmp_path, keep_last=10)
    net.iteration_count = 1
    mgr.save(net)
    net.fit_minibatch(batches(PORT, rng, 1)[0])
    mgr.save(net)
    s = make_server(PORT, mgr)  # boots the newest (step 2)
    try:
        assert s._watched_step == 2
        code, body = s.reload({"step": 1})
        assert code == 200 and body["source"] == "checkpoint-step-1"
        assert s._watched_step == 1
        code, body = s.reload({"step": 1})
        assert body["status"] == "skipped"
        code, body = s.reload({"step": 77})
        assert code == 400
    finally:
        s.stop(drain_timeout=1)


# -- the promoter's scenarios, each runnable in either package ------------


def scenario_promote_and_seal(pkg, tmp_path):
    rng = np.random.RandomState(12345)
    mgr = pkg.manager(tmp_path / "c", keep_last=10)
    journal = pkg.PromotionJournal(tmp_path / "j.json")
    ct = pkg.ContinualTrainer(pkg.net(), mgr, publish_every=4,
                              journal=journal)
    ct.run(stream(pkg, rng, 4))
    s = make_server(pkg, mgr)
    try:
        pr = pkg.Promoter(s, mgr, journal, gates=fast_gates(pkg),
                          seed=CHAOS_SEED)
        assert pr.recover() == "idle"
        ct.run(stream(pkg, rng, 4))  # candidate: step 8
        assert pr.poll() == "shadowing"
        assert s.shadow is not None
        drive(s, rng, n=4)
        assert pr.poll() == "promoted"  # gates -> canary -> swap
        doc = journal.read()
        assert doc["promoted_step"] == 8 and doc["probation"]
        assert s._watched_step == 8 and s.model_version == 2
        drive(s, rng, n=3)
        assert pr.poll() == "promoted"
        assert not journal.read()["probation"]  # sealed
        assert s.shadow is None
        snap = pr.snapshot()
        assert snap["promotions"] == 1 and snap["rollbacks"] == 0
        assert pr.poll() == "promoted"  # steady state: no churn
        assert s.metrics.get("reload_total") == 1
        return journal.read()
    finally:
        s.stop(drain_timeout=1)


def scenario_reject(pkg, tmp_path):
    rng = np.random.RandomState(12345)
    mgr = pkg.manager(tmp_path / "c", keep_last=10)
    journal = pkg.PromotionJournal(tmp_path / "j.json")
    net = pkg.net(seed=1)
    net.iteration_count = 1
    mgr.save(net)
    s = make_server(pkg, mgr)
    try:
        pr = pkg.Promoter(s, mgr, journal,
                          gates=fast_gates(pkg, min_agreement=0.999),
                          seed=CHAOS_SEED)
        stranger = pkg.net(seed=42)  # unrelated weights
        stranger.iteration_count = 2
        mgr.save(stranger)
        assert pr.poll() == "shadowing"
        drive(s, rng, n=8, rows=4)
        assert pr.poll() == "rolled_back"
        doc = journal.read()
        assert 2 in doc["rejected_steps"]
        assert s.model_version == 1  # live never changed
        assert pr.snapshot()["rejected"] == 1
        assert pr.poll() == "rolled_back"  # judged: not re-shadowed
        return journal.read()
    finally:
        s.stop(drain_timeout=1)


def scenario_quarantine(pkg, tmp_path):
    """The trainer publishes a candidate whose zip is torn; the promoter
    quarantines it, the live version keeps serving, and the NEXT good
    candidate promotes."""
    rng = np.random.RandomState(12345)
    mgr = pkg.manager(tmp_path / "c", keep_last=10)
    journal = pkg.PromotionJournal(tmp_path / "j.json")
    ct = pkg.ContinualTrainer(pkg.net(), mgr, publish_every=4,
                              journal=journal)
    ct.run(stream(pkg, rng, 4))
    s = make_server(pkg, mgr)
    try:
        pr = pkg.Promoter(s, mgr, journal, gates=fast_gates(pkg),
                          seed=CHAOS_SEED)
        ct.run(stream(pkg, rng, 4))  # step 8
        bad = mgr.available()[-1]
        zpath = mgr.directory / bad.file
        zpath.write_bytes(zpath.read_bytes()[:64])  # the torn tail
        assert pr.poll() == "quarantined"
        assert pr.snapshot()["quarantined"] == 1
        assert 8 in journal.read()["quarantined_steps"]
        drive(s, rng, n=2)  # live keeps serving
        assert s.model_version == 1
        assert pr.poll() == "quarantined"  # not retried
        ct.run(stream(pkg, rng, 4))  # step 12, good
        assert pr.poll() == "shadowing"
        drive(s, rng, n=4)
        assert pr.poll() == "promoted"
        assert journal.read()["promoted_step"] == 12
        return journal.read()
    finally:
        s.stop(drain_timeout=1)


def scenario_canary_fail(pkg, tmp_path):
    """A restorable but poisoned candidate (non-finite on the canary)
    fails the swap at the reload level, and through the promoter is
    rejected at shadow warm-up, before any client traffic touches it."""
    rng = np.random.RandomState(12345)
    mgr = pkg.manager(tmp_path / "c", keep_last=10)
    net = pkg.net()
    net.iteration_count = 1
    mgr.save(net)
    # the port's server refuses to start on a model whose warm-up is
    # non-finite, so the poisoned step lands after the boot
    s = make_server(pkg, mgr)
    poisoned = pkg.net()
    pkg.set_param(poisoned, "1", "b", np.full(
        tuple(poisoned.params["1"]["b"].shape), np.inf, np.float32))
    poisoned.iteration_count = 2
    mgr.save(poisoned)
    try:
        code, body = s.reload({"step": 1, "force": True})
        assert code == 200
        code, body = s.reload({"step": 2})
        assert code == 503
        assert body["error"]["status"] == "reload_failed"
        assert s._watched_step == 1  # old version still serving
        drive(s, rng, n=2)
        journal = pkg.PromotionJournal(tmp_path / "j.json")
        journal.write("promoted", promoted_step=1, previous_step=1)
        pr = pkg.Promoter(s, mgr, journal, gates=fast_gates(pkg),
                          seed=CHAOS_SEED)
        assert pr.poll() == "rolled_back"
        assert 2 in journal.read()["rejected_steps"]
        assert pr.snapshot()["rejected"] == 1
        assert s.model_version >= 2 and s._watched_step == 1
        return journal.read()
    finally:
        s.stop(drain_timeout=1)


def scenario_sigkill(pkg, tmp_path):
    """The promoter dies right after journaling ``canarying`` (gates
    passed, swap not issued); a fresh promoter rolls the promotion
    FORWARD from the journal, exactly once."""
    rng = np.random.RandomState(12345)
    mgr = pkg.manager(tmp_path / "c", keep_last=10)
    journal = pkg.PromotionJournal(tmp_path / "j.json")
    ct = pkg.ContinualTrainer(pkg.net(), mgr, publish_every=4,
                              journal=journal)
    ct.run(stream(pkg, rng, 4))
    s = make_server(pkg, mgr)
    try:
        pr = pkg.Promoter(s, mgr, journal, gates=fast_gates(pkg),
                          seed=CHAOS_SEED)
        ct.run(stream(pkg, rng, 4))  # step 8
        pr.fail_after_journal = "canarying"
        assert pr.poll() == "shadowing"
        drive(s, rng, n=4)
        with pytest.raises(pkg.SimulatedKill):
            pr.poll()
        assert journal.state == "canarying"  # the split instant
        assert s.model_version == 1          # swap never happened
        pr2 = pkg.Promoter(s, mgr, journal, gates=fast_gates(pkg),
                           seed=CHAOS_SEED)
        assert pr2.recover() == "promoted"   # rolled forward
        assert journal.read()["promoted_step"] == 8
        assert s._watched_step == 8 and s.model_version == 2
        assert pr2.snapshot()["journal_recoveries"] == 1
        drive(s, rng, n=3)
        pr2.poll()
        assert not journal.read()["probation"]  # sealed normally
        return journal.read()
    finally:
        s.stop(drain_timeout=1)


def _bomb(pkg, mgr, alternate=True):
    """The newest version with feature DEAD's weights set to +-40: equal
    answers while that feature is 0, divergent once it moves; saved as
    the next step. Returns the restored info."""
    bomb, info = mgr.restore_latest(load_updater=False, **pkg.restore_kw)
    w = np.array(bomb.params["0"]["W"])
    w[DEAD, :] = (np.where(np.arange(w.shape[1]) % 2 == 0, 40.0, -40.0)
                  if alternate else 40.0)
    pkg.set_param(bomb, "0", "W", w.astype(np.float32))
    bomb.iteration_count = info.step + 1
    mgr.save(bomb)
    return info


def scenario_rollback(pkg, tmp_path):
    """A candidate identical on today's traffic but divergent under a
    shift is promoted; the shift lands during probation and the promoter
    rolls back by re-installing the retained snapshot: no new shape,
    every request answered, the old version's answers bitwise."""
    rng = np.random.RandomState(12345)
    mgr = pkg.manager(tmp_path / "c", keep_last=10)
    journal = pkg.PromotionJournal(tmp_path / "j.json")
    ct = pkg.ContinualTrainer(pkg.net(), mgr, publish_every=4,
                              journal=journal)
    ct.run(stream(pkg, rng, 4))
    s = make_server(pkg, mgr)
    try:
        pr = pkg.Promoter(s, mgr, journal, gates=fast_gates(
            pkg, probation_requests=100, probation_min_agreement=0.9),
            seed=CHAOS_SEED)
        probe = feats(np.random.RandomState(77), rows=2, shifted=True)
        before = s.submit(probe)[1]["output"]
        info = _bomb(pkg, mgr)
        base_version = s.model_version
        assert pr.poll() == "shadowing"
        drive(s, rng, n=4)              # baseline traffic: agreement 1
        assert pr.poll() == "promoted"  # the bomb takes traffic
        assert s.model_version == base_version + 1
        entry = s.model_registry.entry()
        promoted_obj = entry.current
        compiles = s.metrics.get("xla_compiles_total")
        post_warmup = s.metrics.get("post_warmup_compiles_total")
        drive(s, rng, n=6, shifted=True)  # the shift goes live
        assert pr.poll() == "rolled_back"
        doc = journal.read()
        assert doc["promoted_step"] == 4
        assert info.step + 1 in doc["rejected_steps"]
        assert entry.current is not promoted_obj
        assert pr.snapshot()["rollbacks"] == 1
        drive(s, rng, n=4)
        drive(s, rng, n=2, shifted=True)
        assert s.metrics.get("xla_compiles_total") == compiles
        assert s.metrics.get("post_warmup_compiles_total") == post_warmup
        assert s.metrics.get("server_error_total") == 0
        assert pr.poll() == "rolled_back"  # the bomb is not re-promoted
        assert s.model_version == base_version
        assert s.submit(probe)[1]["output"] == before
        return journal.read()
    finally:
        s.stop(drain_timeout=1)


def scenario_recover_demotes(pkg, tmp_path):
    """A fresh server boots the NEWEST checkpoint, possibly unvetted;
    recover() restores the journal's promoted step first."""
    rng = np.random.RandomState(12345)
    mgr = pkg.manager(tmp_path / "c", keep_last=10)
    journal = pkg.PromotionJournal(tmp_path / "j.json")
    ct = pkg.ContinualTrainer(pkg.net(), mgr, publish_every=4,
                              journal=journal)
    ct.run(stream(pkg, rng, 8))  # steps 4, 8
    journal.write("promoted", promoted_step=4, previous_step=4,
                  probation=False)
    s = make_server(pkg, mgr)  # boots step 8
    try:
        assert s._watched_step == 8
        pr = pkg.Promoter(s, mgr, journal, gates=fast_gates(pkg),
                          seed=CHAOS_SEED)
        pr.recover()
        assert s._watched_step == 4
        assert pr.snapshot()["journal_recoveries"] == 1
        assert pr.poll() == "shadowing"  # step 8 re-enters as candidate
        return journal.read()
    finally:
        s.stop(drain_timeout=1)


def scenario_recover_rearms(pkg, tmp_path):
    """A kill during probation: the previous version's checkpoint is
    journal-protected, recovery restores it and re-arms the reversed
    shadow, and a regression after the restart still rolls back."""
    rng = np.random.RandomState(12345)
    mgr = pkg.manager(tmp_path / "c", keep_last=10)
    journal = pkg.PromotionJournal(tmp_path / "j.json")
    ct = pkg.ContinualTrainer(pkg.net(), mgr, publish_every=4,
                              journal=journal)
    ct.run(stream(pkg, rng, 4))
    _bomb(pkg, mgr, alternate=False)
    journal.write("promoted", candidate_step=5, previous_step=4,
                  promoted_step=5, probation=True)
    s = make_server(pkg, mgr)  # a fresh process serves the bomb
    try:
        pr = pkg.Promoter(s, mgr, journal, gates=fast_gates(
            pkg, probation_requests=100, probation_min_agreement=0.9),
            seed=CHAOS_SEED)
        assert pr.recover() == "promoted"
        assert s.shadow is not None  # probation re-armed
        assert pr.snapshot()["journal_recoveries"] == 1
        drive(s, rng, n=6, shifted=True)
        assert pr.poll() == "rolled_back"
        assert journal.read()["promoted_step"] == 4
        drive(s, rng, n=2)
        return journal.read()
    finally:
        s.stop(drain_timeout=1)


SCENARIOS = {
    "promote_and_seal": scenario_promote_and_seal,
    "reject": scenario_reject,
    "quarantine": scenario_quarantine,
    "canary_fail": scenario_canary_fail,
    "sigkill": scenario_sigkill,
    "rollback": scenario_rollback,
    "recover_demotes": scenario_recover_demotes,
    "recover_rearms": scenario_recover_rearms,
}


def test_promoter_promotes_and_seals(tmp_path):
    scenario_promote_and_seal(PORT, tmp_path)


def test_promoter_rejects_disagreeing_candidate(tmp_path):
    scenario_reject(PORT, tmp_path)


def test_corrupt_candidate_quarantined_live_serving(tmp_path):
    scenario_quarantine(PORT, tmp_path)


def test_canary_fail_keeps_old_version(tmp_path):
    scenario_canary_fail(PORT, tmp_path)


def test_sigkill_mid_promotion_recovers_from_journal(tmp_path):
    scenario_sigkill(PORT, tmp_path)


def test_rollback_reinstalls_snapshot_zero_compiles(tmp_path):
    scenario_rollback(PORT, tmp_path)


def test_recover_demotes_unvetted_boot(tmp_path):
    scenario_recover_demotes(PORT, tmp_path)


def test_recover_rearms_probation(tmp_path):
    doc = scenario_recover_rearms(PORT, tmp_path)
    assert doc["state"] == "rolled_back" and 5 in doc["rejected_steps"]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_journals_the_same_history_as_jax(name, tmp_path):
    ref = SCENARIOS[name](JAX, tmp_path / "jax")
    mine = SCENARIOS[name](PORT, tmp_path / "port")
    assert journal_view(mine) == journal_view(ref)


@pytest.mark.parametrize("snap", [
    {"agreement": None, "errors": 0, "p99_delta_ms": None},
    {"agreement": 0.97, "errors": 2, "p99_delta_ms": 7.25},
    {"agreement": 0.99, "errors": 0, "p99_delta_ms": 4.0},
], ids=["nothing_mirrored", "every_gate", "clean"])
def test_gate_failures_read_as_jax(snap):
    """The shadow gates' verdicts and reasons on one snapshot: agreement,
    errors, the p99 delta and the divergence-trip budget."""
    def judge(promoter_cls, gates_cls):
        me = SimpleNamespace(
            gates=gates_cls(min_agreement=0.98, max_shadow_errors=1,
                            max_p99_delta_ms=5.0, max_divergence_trips=1),
            trip_source=lambda: 3, _trips_at_candidate=1)
        return promoter_cls._gate_failures(me, snap)

    got = judge(Promoter, PromotionGates)
    assert got == judge(JPromoter, JPromotionGates)
    assert "divergence trips 2 > 1" in got
    assert any("p99" in f for f in got) == (
        (snap["p99_delta_ms"] or 0.0) > 5.0)


# -- the port's own hazards ---------------------------------------------


def test_promoter_restores_candidates_on_the_server_device(tmp_path):
    """The manager's own default device is the card; every restore the
    promoter makes names the server's device, so on the CPU the
    candidate restores (rather than failing into quarantine)."""
    rng = np.random.RandomState(3)
    mgr = CheckpointManager(tmp_path / "c", keep_last=10)
    assert mgr.device is None
    journal = PromotionJournal(tmp_path / "j.json")
    ct = ContinualTrainer(port_net(), mgr, publish_every=2,
                          journal=journal)
    ct.run(stream(PORT, rng, 2))
    s = make_server(PORT, mgr)
    try:
        pr = Promoter(s, mgr, journal, gates=fast_gates(PORT), seed=1)
        ct.run(stream(PORT, rng, 2))
        assert pr.poll() == "shadowing"
        assert s.shadow.candidate.device == s.device
        assert pr.snapshot()["quarantined"] == 0
    finally:
        s.stop(drain_timeout=1)


def test_unusable_candidate_bundle_is_counted_and_the_shadow_runs(
        tmp_path):
    rng = np.random.RandomState(4)
    mgr = CheckpointManager(tmp_path / "c", keep_last=10)
    journal = PromotionJournal(tmp_path / "j.json")
    ct = ContinualTrainer(port_net(), mgr, publish_every=2, journal=journal,
                          artifact_fn=lambda m: {"aot-output-b4": b"torn"})
    ct.run(stream(PORT, rng, 2))
    s = make_server(PORT, mgr, aot=True)
    try:
        fallbacks = s.metrics.registry.get("aot_fallback_total")
        at_start = fallbacks.value
        assert at_start >= 1  # the boot checkpoint's record too
        pr = Promoter(s, mgr, journal, gates=fast_gates(PORT), seed=1)
        ct.run(stream(PORT, rng, 2))
        assert pr.poll() == "shadowing"
        assert fallbacks.value == at_start + 1
        drive(s, rng, n=4)
        assert pr.poll() == "promoted"
    finally:
        s.stop(drain_timeout=1)


def test_rollback_under_concurrent_traffic_drops_nothing(tmp_path):
    """Clients keep sending through the promotion and the rollback: every
    request is answered 200 by one version or the other."""
    rng = np.random.RandomState(12345)
    mgr = CheckpointManager(tmp_path / "c", keep_last=10)
    journal = PromotionJournal(tmp_path / "j.json")
    ct = ContinualTrainer(port_net(), mgr, publish_every=4, journal=journal)
    ct.run(stream(PORT, rng, 4))
    s = make_server(PORT, mgr, workers=4)
    codes, stop = [], threading.Event()
    lock = threading.Lock()

    def client(i):
        crng = np.random.RandomState(100 + i)
        while not stop.is_set():
            code, _, _ = s.submit(feats(crng, shifted=bool(i % 2)))
            with lock:
                codes.append(code)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        pr = Promoter(s, mgr, journal, gates=fast_gates(
            PORT, probation_requests=10_000, probation_min_agreement=0.9),
            seed=CHAOS_SEED)
        _bomb(PORT, mgr)
        for t in threads:
            t.start()
        wait_until(lambda: pr.poll() == "rolled_back",
                   "the promotion and its rollback", timeout=60)
        assert pr.snapshot()["promotions"] == 1
        assert pr.snapshot()["rollbacks"] == 1
        n = len(codes)
        wait_until(lambda: len(codes) > n + 8, "traffic after the rollback")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        s.stop(drain_timeout=1)
    assert not any(t.is_alive() for t in threads)
    assert set(codes) == {200}
    assert s.metrics.get("post_warmup_compiles_total") == 0


def test_fault_in_brings_a_paged_out_snapshot_back_to_its_device():
    """A version paged out to the host (the loop's retained snapshot,
    when its tenant was cold as the promotion landed) comes back onto
    its device; a resident one, or one of the CPU, is left alone (a
    stand-in device, ``meta``, plays the card here)."""
    def model(device):
        return SimpleNamespace(
            device=device, state={"0": {"mean": torch.zeros(4)}},
            params={"0": {"W": torch.ones(3, 4), "b": torch.zeros(4)}})

    paged = model("meta")  # its tensors are still on the CPU: paged out
    assert weights_on_host(paged) and not weights_on_host(model("cpu"))
    ms = fault_in(paged)
    assert ms is not None and ms >= 0.0
    assert not weights_on_host(paged)
    assert all(t.device.type == "meta" for tree in (paged.params,
                                                    paged.state)
               for d in tree.values() for t in d.values())
    assert fault_in(paged) is None  # resident: nothing to do
    assert fault_in(model("cpu")) is None
