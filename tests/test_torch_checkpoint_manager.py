"""The port's checkpoint manager (``resilience/checkpoint.py``), retry,
breaker and retrying store on the CPU, against the JAX package.

- A JAX ``CheckpointManager`` directory, format 1 (zips) and format 2
  at one shard (``LocalCommitBarrier``), restored by the port's
  ``restore_latest``, and the reverse; the manifests carry the same
  keys and each CRC-32 is that of the bytes on disk.
- Retention (``keep_last`` with ``protect``), the corrupted-newest
  fallback and quarantine; write-behind saves bitwise the synchronous
  ones, newest-wins supersede, a sync save that drains the writer,
  stop and restart; format 2 over 2 gloo ranks
  (``ProcessGroupCommitBarrier``) and the GC of uncommitted
  directories; ``scrub_once`` repairing a flipped byte from a
  ``LocalObjectStore`` replica.
- ``RetryPolicy.delay_for`` equal to JAX's for the same seed, the
  breaker's transitions, the retrying store.

Tolerances: checkpoints carry values exactly, so every comparison of
restored tensors is bitwise; the JAX package's and the port's delays
are the same floats.
"""

import json
import os
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.cloud.storage import (
    LocalObjectStore as JLocalObjectStore,
)
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.resilience.breaker import (
    CircuitBreaker as JBreaker,
)
from deeplearning4j_tpu.resilience.checkpoint import (
    CheckpointManager as JManager,
)
from deeplearning4j_tpu.resilience.checkpoint import (
    LocalCommitBarrier as JLocalBarrier,
)
from deeplearning4j_tpu.resilience.retry import RetryPolicy as JRetryPolicy
from deeplearning4j_tpu_torch.cloud.storage import LocalObjectStore
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.exceptions import (
    CheckpointCorruptedException,
    CircuitOpenException,
    RetryExhaustedException,
)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.resilience import (
    CircuitBreaker,
    RetryingObjectStore,
    RetryPolicy,
)
from deeplearning4j_tpu_torch.resilience.checkpoint import (
    CheckpointManager,
    LeaseCommitBarrier,
    LocalCommitBarrier,
)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    params_to_numpy,
    updater_state_to_numpy,
)

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 180


def conf():
    return (NeuralNetConfiguration.Builder().seed(7).learning_rate(0.05)
            .updater("ADAM").list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .build())


def net(init=None):
    return MultiLayerNetwork(conf(), device="cpu").init(params=init)


def batches(n=6, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return [DataSet(rng.randn(batch, 4).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)])
            for _ in range(n)]


def flat_of(model):
    """Parameters and updater state of a port model as host arrays."""
    out = {"p:" + k: v for k, v in params_to_numpy(model.params).items()}
    out.update({"u:" + k: v for k, v in
                updater_state_to_numpy(model.updater_state).items()})
    return out


def jflat_of(jmodel):
    out = {}
    for ln, lp in jmodel.params.items():
        for pn, a in lp.items():
            out[f"p:{ln}/{pn}"] = np.asarray(a)
    for ln, lp in jmodel.updater_state.items():
        for pn, tup in lp.items():
            for i, a in enumerate(tup):
                out[f"u:{ln}/{pn}/{i}"] = np.asarray(a)
    return out


def assert_flat_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def trained_pair(steps=2):
    """A JAX model and the port's twin from the same weights, each
    trained ``steps`` minibatches."""
    jnet = JNet(JConf.from_dict(conf().to_dict())).init()
    flat = {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in jnet.params.items() for pn, a in lp.items()}
    model = net(params_from_numpy(flat, "cpu"))
    for ds in batches(steps):
        jnet.fit_minibatch(JDataSet(ds.features, ds.labels))
        model.fit_minibatch(ds)
    return jnet, model


def manifest_docs(directory):
    docs = []
    for p in sorted(Path(directory).rglob("*.json")):
        doc = json.loads(p.read_text())
        if "format" in doc:
            docs.append((p, doc))
    return docs


# -- the two packages read each other's directories ---------------------------


@pytest.mark.parametrize("sharded", [False, True])
def test_jax_directory_restores_in_the_port(tmp_path, sharded):
    jnet, _ = trained_pair()
    barrier = JLocalBarrier() if sharded else None
    JManager(tmp_path, commit=barrier).save(jnet)
    model, info = CheckpointManager(tmp_path, device="cpu").restore_latest()
    assert info.step == 2 and info.is_sharded == sharded
    assert model.iteration_count == jnet.iteration_count == 2
    assert_flat_equal(flat_of(model), jflat_of(jnet))


@pytest.mark.parametrize("sharded", [False, True])
def test_port_directory_restores_in_jax(tmp_path, sharded):
    _, model = trained_pair()
    barrier = LocalCommitBarrier() if sharded else None
    CheckpointManager(tmp_path, commit=barrier).save(model)
    jmodel, info = JManager(tmp_path).restore_latest()
    assert info.step == 2 and info.is_sharded == sharded
    assert jmodel.iteration_count == 2
    assert_flat_equal(jflat_of(jmodel), flat_of(model))


@pytest.mark.parametrize("sharded", [False, True])
def test_manifests_share_keys_and_their_crc_is_the_bytes(tmp_path,
                                                         sharded):
    jnet, model = trained_pair()
    JManager(tmp_path / "jax", commit=JLocalBarrier() if sharded
             else None).save(jnet)
    CheckpointManager(tmp_path / "port", commit=LocalCommitBarrier()
                      if sharded else None).save(model)
    (jp, jdoc), = manifest_docs(tmp_path / "jax")
    (pp, pdoc), = manifest_docs(tmp_path / "port")
    assert jp.relative_to(tmp_path / "jax") == pp.relative_to(
        tmp_path / "port")
    assert jdoc.keys() == pdoc.keys()
    for root, doc in ((tmp_path / "jax", jdoc), (tmp_path / "port", pdoc)):
        if sharded:
            assert doc["model"].keys() == {"model_type", "configuration",
                                           "iteration_count", "epoch_count"}
            for ent in doc["shards"].values():
                data = (root / doc["dir"] / ent["file"]).read_bytes()
                assert ent["crc32"] == zlib.crc32(data) & 0xFFFFFFFF
                assert ent["size"] == len(data)
        else:
            data = (root / doc["file"]).read_bytes()
            assert doc["crc32"] == zlib.crc32(data) & 0xFFFFFFFF
            assert doc["size"] == len(data)
    if sharded:
        assert [e["keys"] for e in jdoc["shards"].values()] == [
            e["keys"] for e in pdoc["shards"].values()]


# -- retention, fallback, quarantine ------------------------------------------


def test_keep_last_with_protect_and_versioning(tmp_path):
    model = net()
    protected = set()
    mgr = CheckpointManager(tmp_path, keep_last=2, protect=lambda: protected)
    steps = []
    for i, ds in enumerate(batches(5)):
        model.fit_minibatch(ds)
        steps.append(mgr.save(model).step)
        if i == 0:
            protected.add(steps[0])
    assert mgr.list_steps() == [1, 4, 5]
    assert mgr.latest_step() == mgr.last_step() == 5
    assert (tmp_path / "checkpoint-00000005.zip").is_file()
    assert not (tmp_path / "checkpoint-00000002.zip").exists()
    with pytest.raises(ValueError):
        CheckpointManager(tmp_path, keep_last=0)
    with pytest.raises(ValueError):
        CheckpointManager(tmp_path, prefix="bad/prefix")


def test_corrupted_newest_falls_back_and_all_corrupt_raises(tmp_path):
    model = net()
    mgr = CheckpointManager(tmp_path, keep_last=5, device="cpu")
    data = batches(2)
    model.fit_minibatch(data[0])
    older = mgr.save(model)
    want = flat_of(model)
    model.fit_minibatch(data[1])
    newest = mgr.save(model)
    path = tmp_path / newest.file
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    got, info = mgr.restore_latest()
    assert info.step == older.step
    assert_flat_equal(flat_of(got), want)
    (tmp_path / older.file).write_bytes(b"torn")
    with pytest.raises(CheckpointCorruptedException):
        mgr.restore_latest()


def test_scrub_quarantines_without_a_replica_and_resave_clears(tmp_path):
    mgr = CheckpointManager(tmp_path, commit=LocalCommitBarrier(),
                            keep_last=5, device="cpu")
    model = net()
    data = batches(2)
    model.fit_minibatch(data[0])
    older = mgr.save(model)
    model.fit_minibatch(data[1])
    newest = mgr.save(model)
    (tmp_path / newest.dir / "shard-0.npz").write_bytes(b"x")
    report = mgr.scrub_once()
    assert report["quarantined"] == [newest.step]
    assert mgr.is_quarantined(newest.step)
    _, got = mgr.restore_latest()
    assert got.step == older.step
    again = mgr.save(model)
    assert again.step == newest.step and not mgr.is_quarantined(newest.step)
    assert mgr.restore_latest()[1].step == newest.step


# -- write-behind --------------------------------------------------------------


def test_async_save_is_bitwise_the_sync_save(tmp_path):
    model = net()
    model.fit_minibatch(batches(1)[0])
    sync = CheckpointManager(tmp_path / "s", device="cpu")
    asyn = CheckpointManager(tmp_path / "a", mode="async", device="cpu")
    sync.save(model)
    h = asyn.save(model)
    model.fit_minibatch(batches(2)[1])  # training goes on
    info = h.wait(60)
    assert info.step == 1 and h.done() and not h.superseded
    a, _ = sync.restore_latest()
    b, _ = asyn.restore_latest()
    assert_flat_equal(flat_of(a), flat_of(b))
    asyn.stop()


def test_async_supersede_newest_wins(tmp_path, monkeypatch):
    model = net()
    data = batches(3)
    model.fit_minibatch(data[0])
    mgr = CheckpointManager(tmp_path, mode="async", keep_last=5)
    gate, entered = threading.Event(), threading.Event()
    orig = mgr._write_payload

    def gated(payload):
        entered.set()
        assert gate.wait(30)
        return orig(payload)

    monkeypatch.setattr(mgr, "_write_payload", gated)
    h1 = mgr.save(model)
    assert entered.wait(10)
    model.fit_minibatch(data[1])
    h2 = mgr.save(model)
    model.fit_minibatch(data[2])
    h3 = mgr.save(model)
    assert h2.wait(10) is None and h2.superseded
    assert not h3.done()
    gate.set()
    assert h1.wait(60).step == 1 and h3.wait(60).step == 3
    assert mgr.list_steps() == [1, 3]
    mgr.stop()


def test_sync_save_drains_the_writer_and_stop_restarts(tmp_path):
    reg = MetricsRegistry()
    model = net()
    data = batches(3)
    model.fit_minibatch(data[0])
    mgr = CheckpointManager(tmp_path, mode="async", keep_last=5,
                            registry=reg)
    h = mgr.save(model)
    model.fit_minibatch(data[1])
    info = mgr.save(model, mode="sync")
    assert h.done() and h.wait(0).step == 1 and info.step == 2
    assert mgr.latest_step() == 2
    mgr.stop()
    model.fit_minibatch(data[2])
    h2 = mgr.save(model)
    assert h2.wait(60).step == 3
    mgr.stop()
    assert mgr._m_pending.value == 0.0 and mgr._m_stall.count == 3
    assert reg.get("checkpoint_write_ms")._default().count == 3
    with pytest.raises(ValueError):
        mgr.save(model, mode="later")


# -- format 2 over ranks, GC, scrub and repair ---------------------------------

_RANK = r"""
import json, sys
import numpy as np
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    init_distributed, shutdown_distributed)
from deeplearning4j_tpu_torch.resilience.checkpoint import (
    CheckpointManager, ProcessGroupCommitBarrier)
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

spec = json.loads(sys.argv[1])
init_distributed("file://" + spec["rdv"], spec["world"], spec["rank"],
                 device="cpu", timeout_s=120)
conf = MultiLayerConfiguration.from_dict(json.loads(open(spec["conf"]).read()))
model = MultiLayerNetwork(conf, device="cpu").init(
    params=params_from_numpy(dict(np.load(spec["init"])), "cpu"))
model.iteration_count = 5
mgr = CheckpointManager(spec["dir"], commit=ProcessGroupCommitBarrier(),
                        mode=spec["mode"])
out = mgr.save(model)
info = out.wait(60) if spec["mode"] == "async" else out
print(json.dumps({"step": info.step, "nshards": info.nshards}))
shutdown_distributed()
"""


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sharded_save_over_two_gloo_ranks(tmp_path, mode):
    """Two ranks each write their slice of the flat state
    (``shard-<rank>.npz``) through a ``ProcessGroupCommitBarrier``; rank
    0's manifest lists both; the port and the JAX package restore the
    whole model from the two shards."""
    model = net()
    model.fit_minibatch(batches(1)[0])
    np.savez(tmp_path / "init.npz", **params_to_numpy(model.params))
    (tmp_path / "conf.json").write_text(json.dumps(conf().to_dict()))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = []
    for r in range(2):
        spec = dict(rank=r, world=2, rdv=str(tmp_path / "rdv"),
                    conf=str(tmp_path / "conf.json"),
                    init=str(tmp_path / "init.npz"),
                    dir=str(tmp_path / "ck"), mode=mode)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, json.dumps(spec)], cwd=str(ROOT),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("ranks hung")
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs == [{"step": 5, "nshards": 2}] * 2
    d = tmp_path / "ck" / "checkpoint-00000005"
    assert sorted(p.name for p in d.iterdir()) == [
        "manifest.json", "shard-0.npz", "shard-1.npz"]
    got, info = CheckpointManager(tmp_path / "ck",
                                  device="cpu").restore_latest(
        load_updater=False)
    assert info.nshards == 2 and got.iteration_count == 5
    for ln, lp in model.params.items():
        for pn, t in lp.items():
            assert torch.equal(got.params[ln][pn], t)
    jmodel, _ = JManager(tmp_path / "ck").restore_latest(load_updater=False)
    for ln, lp in model.params.items():
        for pn, t in lp.items():
            np.testing.assert_array_equal(np.asarray(jmodel.params[ln][pn]),
                                          t.numpy())


def test_uncommitted_directories_are_collected(tmp_path):
    mgr = CheckpointManager(tmp_path, commit=LocalCommitBarrier(),
                            keep_last=5)
    model = net()
    for ds in batches(2):
        model.fit_minibatch(ds)
    committed = mgr.save(model)
    torn = tmp_path / "checkpoint-00000001"
    torn.mkdir()
    (torn / "shard-0.npz").write_bytes(b"partial")
    fresh = tmp_path / "checkpoint-00000099"
    fresh.mkdir()
    mgr._prune()
    assert not torn.exists() and fresh.exists()
    mgr.gc_grace_s = 0.0
    with mgr._wcond:
        mgr._active_steps.add(99)
    mgr._prune()
    assert fresh.exists()
    with mgr._wcond:
        mgr._active_steps.discard(99)
    mgr._prune()
    assert not fresh.exists()
    assert mgr.latest_step() == committed.step
    assert mgr.available()[0].is_sharded


def test_scrub_repairs_a_flipped_byte_from_the_replica(tmp_path):
    replica = RetryingObjectStore(LocalObjectStore(tmp_path / "rep"))
    reg = MetricsRegistry()
    mgr = CheckpointManager(tmp_path / "ck", commit=LocalCommitBarrier(),
                            replica_store=replica, registry=reg,
                            keep_last=5, device="cpu")
    model = net()
    model.fit_minibatch(batches(1)[0])
    info = mgr.save(model)
    shard = tmp_path / "ck" / info.dir / "shard-0.npz"
    raw = bytearray(shard.read_bytes())
    raw[100] ^= 0x01
    shard.write_bytes(bytes(raw))
    report = mgr.scrub_once()
    assert report == {"checked": 1, "corrupt": 1, "repaired": 1,
                      "quarantined": []}
    assert mgr._m_scrub.value == 1 and mgr._m_repair.value == 1
    assert mgr.verify(info)
    got, _ = mgr.restore_latest()
    assert_flat_equal(flat_of(got), flat_of(model))
    # a format-1 zip repairs the same way, inline on restore
    mgr1 = CheckpointManager(tmp_path / "ck1", device="cpu",
                             replica_store=LocalObjectStore(tmp_path / "r1"))
    info1 = mgr1.save(model)
    (tmp_path / "ck1" / info1.file).write_bytes(b"junk")
    assert_flat_equal(flat_of(mgr1.restore(info1)), flat_of(model))


def test_artifacts_ride_the_manifest_and_never_gate_a_restore(tmp_path):
    model = net()
    mgr = CheckpointManager(tmp_path, device="cpu")
    info = mgr.save(model, artifacts={"flightrec.jsonl": b"{}\n"})
    assert mgr.load_artifact(info, "flightrec.jsonl") == b"{}\n"
    (tmp_path / info.artifacts["flightrec.jsonl"]["file"]).write_bytes(b"x")
    assert mgr.load_artifact(info, "flightrec.jsonl") is None
    assert mgr.restore_latest()[1].step == info.step


def test_lease_barrier_names_the_control_plane():
    """``LeaseCommitBarrier`` rides the control plane's agent: its
    rank and shard count are the agent's grant, and a control-plane
    failure aborts the commit naming it."""
    from deeplearning4j_tpu_torch.exceptions import (
        CheckpointCommitAbortedException,
    )
    from deeplearning4j_tpu_torch.parallel.control_plane import (
        CoordinatorLostException,
    )

    class Agent:
        rank, num = 1, 3

        def sync_barrier(self, token, payload, timeout_s=None):
            raise CoordinatorLostException("control coordinator unreachable")

    barrier = LeaseCommitBarrier(agent=Agent())
    assert (barrier.rank, barrier.nshards) == (1, 3)
    with pytest.raises(CheckpointCommitAbortedException,
                       match="control coordinator"):
        barrier.barrier("step-1", {})


# -- retry, breaker, retrying store ---------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 1337])
def test_retry_delays_are_jax(seed):
    kw = dict(max_attempts=8, base_delay=0.05, multiplier=1.7,
              max_delay=2.0, jitter=0.5, seed=seed)
    a, b = RetryPolicy(**kw), JRetryPolicy(**kw)
    assert [a.delay_for(i) for i in range(8)] == [
        b.delay_for(i) for i in range(8)]


def test_retry_call_bounds_attempts_and_chains_the_cause():
    from deeplearning4j_tpu_torch.resilience import retry_call, retrying

    slept, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"

    policy = RetryPolicy(max_attempts=5, seed=1, sleep=slept.append)
    assert retry_call(flaky, policy=policy) == "ok" and len(slept) == 2

    @retrying(RetryPolicy(max_attempts=2, sleep=slept.append))
    def always():
        raise OSError("down")

    with pytest.raises(RetryExhaustedException) as ei:
        always()
    assert ei.value.attempts == 2 and isinstance(ei.value.__cause__, OSError)
    with pytest.raises(ValueError):
        retry_call(lambda: (_ for _ in ()).throw(ValueError("bug")),
                   policy=RetryPolicy(sleep=slept.append))


def test_breaker_transitions_are_jax():
    """The same call sequence under a scripted clock: the same states
    and rejections in both packages."""
    def drive(cls):
        now = [0.0]
        b = cls(failure_threshold=2, reset_timeout=10.0,
                clock=lambda: now[0])
        trace = []
        for t, ok in ((0, False), (1, False), (2, True), (12, True),
                      (13, False), (14, False), (30, False)):
            now[0] = float(t)
            if not b.try_acquire():
                trace.append(("rejected", b.state))
                continue
            (b.record_success if ok else b.record_failure)()
            trace.append((ok, b.state))
        return trace, b.trips

    assert drive(CircuitBreaker) == drive(JBreaker)
    b = CircuitBreaker(failure_threshold=1, reset_timeout=60.0)
    with pytest.raises(OSError):
        b.call(lambda: (_ for _ in ()).throw(OSError("x")))
    with pytest.raises(CircuitOpenException):
        b.call(lambda: 1)


def test_retrying_store_survives_two_failures(tmp_path):
    class Flaky(LocalObjectStore):
        fails = 2

        def read(self, key):
            if Flaky.fails:
                Flaky.fails -= 1
                raise OSError("blip")
            return super().read(key)

    store = RetryingObjectStore(Flaky(tmp_path), RetryPolicy(
        max_attempts=3, sleep=lambda s: None))
    store.write("a/b", b"data")
    assert store.read("a/b") == b"data" and store.keys("a") == ["a/b"]
    assert JLocalObjectStore(tmp_path).read("a/b") == b"data"
