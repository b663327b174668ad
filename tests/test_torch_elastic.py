"""The port's elastic training (``parallel/elastic.py``) on the CPU,
against the JAX package's.

- ``HeartbeatMonitor``: the crc32-seeded jitter intervals, the deaths
  under a fake clock and the epoch-fenced ``clear``, each against the
  JAX monitor on the same script; ``StragglerDetector``'s flags and
  counts against JAX's on the same step times.
- ``SnapshotRing``: capacity, host isolation, the base key (JAX's
  ``model._base_key``), a rollback and replay bitwise the run that
  never rolled back.
- ``ElasticTrainer`` on 4 gloo CPU ranks (each a subprocess of torch,
  numpy and the port; ``_CHILD``): ranks 2-3 lost at step 6 with
  snapshots every 4, with and without ZeRO. The survivors (re-formed
  as a world of 2) finish bitwise a piecewise reference in the port (4
  ranks to the snapshot, 2 after), and within ``kernel_tols()`` of the
  JAX package's 8-device ``ElasticTrainer`` losing devices 4-7 on the
  same batches (the same math, the shards summed in another order).
  The lost ranks leave with ``DeviceLostException``; losing every
  rank raises.
- ``HostElasticTrainer``: the two-process SIGKILL storm on gloo CPU
  (a ``LeaseCoordinator`` in this process, ``KillAtStep(7)`` on rank
  1), with and without ZeRO: one recovery within one snapshot window
  of the kill, 12 steps, and the survivor bitwise a piecewise
  reference (a process that loads the recovery snapshot and replays
  at survivor width, JAX ``tests/test_control_plane.py`` ``_REFERENCE``).

Every multi-process run has a timeout of its own: it kills its ranks
and fails with their stderr.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest
from conftest import kernel_tols
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.observability.metrics import (
    MetricsRegistry as JRegistry,
)
from deeplearning4j_tpu.parallel.elastic import ElasticTrainer as JElastic
from deeplearning4j_tpu.parallel.elastic import (
    HeartbeatMonitor as JHeartbeat,
)
from deeplearning4j_tpu.parallel.elastic import (
    StragglerDetector as JStraggler,
)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import (
    DeviceLostException,
    ElasticTrainer,
    HeartbeatMonitor,
    HostElasticTrainer,
    LeaseCoordinator,
    SnapshotRing,
    StragglerDetector,
)
from deeplearning4j_tpu_torch.parallel.elastic import derive_rendezvous
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 150
CHAOS_SEED = 1337


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def jax_net(seed=7):
    conf = (JBuilder.Builder().seed(seed).learning_rate(0.05)
            .updater("ADAM").list()
            .layer(JDense(n_in=4, n_out=8, activation="tanh"))
            .layer(JOutput(n_out=3))
            .build())
    return JNet(conf).init()


def port_twin(jnet):
    """The port's net from the JAX net's configuration and weights."""
    flat = {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in jnet.params.items() for pn, a in lp.items()}
    conf = MultiLayerConfiguration.from_dict(jnet.conf.to_dict())
    return MultiLayerNetwork(conf, device="cpu").init(
        params=params_from_numpy(flat, "cpu"))


def arrays(rng, n_batches=12, batch=16):
    xs = [rng.randn(batch, 4).astype(np.float32) for _ in range(n_batches)]
    ys = [np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)]
          for _ in range(n_batches)]
    return xs, ys


def flat_trees(params, upd):
    """``p:<layer>/<param>`` and ``u:<layer>/<param>/<i>`` host arrays
    of parameter and updater trees (torch tensors or JAX arrays)."""
    out = {f"p:{ln}/{pn}": np.asarray(t)
           for ln, lp in params.items() for pn, t in lp.items()}
    for ln, lp in upd.items():
        for pn, tup in lp.items():
            for i, t in enumerate(tup):
                out[f"u:{ln}/{pn}/{i}"] = np.asarray(t)
    return out


# -- heartbeat and straggler schedules against the JAX package --------------


@pytest.mark.parametrize("seed,jitter", [(5, 0.2), (0, 0.5), (1337, 0.0)])
def test_heartbeat_jitter_matches_jax(seed, jitter):
    shards = ["0", "1", "2", "17"]
    m = HeartbeatMonitor(shards, timeout=30.0, jitter=jitter, seed=seed,
                         registry=MetricsRegistry())
    j = JHeartbeat(shards, timeout=30.0, jitter=jitter, seed=seed,
                   registry=JRegistry())
    for _ in range(6):
        for s in shards:
            assert m.next_interval(s) == j.next_interval(s)
    if jitter:
        assert ([m.next_interval("0") for _ in range(4)]
                != [m.next_interval("1") for _ in range(4)])
    with pytest.raises(KeyError):
        m.next_interval("nope")


def test_heartbeat_deaths_and_fenced_clear_match_jax():
    fc = FakeClock()
    reg, jreg = MetricsRegistry(), JRegistry()
    mons = [HeartbeatMonitor(["0", "1", "2"], timeout=10.0, clock=fc,
                             registry=reg),
            JHeartbeat(["0", "1", "2"], timeout=10.0, clock=fc,
                       registry=jreg)]

    def both(fn):
        a, b = (fn(mon) for mon in mons)
        assert a == b
        return a

    assert both(lambda m: m.dead()) == []
    fc.advance(6.0)
    both(lambda m: (m.beat("0"), m.beat("1")))
    fc.advance(6.0)
    assert both(lambda m: m.dead()) == ["2"]
    assert both(lambda m: m.alive()) == ["0", "1"]
    both(lambda m: m.mark_dead("1"))
    both(lambda m: m.beat("1"))  # a zombie's beat: ignored
    assert both(lambda m: m.dead()) == ["1", "2"]
    epoch = both(lambda m: m.epoch)
    assert both(lambda m: m.clear("1", epoch - 1)) is False
    assert both(lambda m: m.clear("1", epoch)) is True
    assert both(lambda m: m.dead()) == ["2"]
    both(lambda m: m.reset(["0", "1"]))
    assert both(lambda m: (m.shards, m.dead(), m.epoch)) == (
        ["0", "1"], [], epoch + 1)
    assert both(lambda m: m.clear("1", epoch)) is False
    for s in "012":
        assert (reg.get("heartbeat_missed_total").labels(s).value
                == jreg.get("heartbeat_missed_total").labels(s).value)
    assert reg.get("heartbeat_missed_total").labels("2").value == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_flags_match_jax(seed):
    rng = np.random.RandomState(seed)
    reg, jreg = MetricsRegistry(), JRegistry()
    det = StragglerDetector(alpha=0.5, factor=2.0, warmup=3, registry=reg)
    jdet = JStraggler(alpha=0.5, factor=2.0, warmup=3, registry=jreg)
    slow = str(seed % 4)
    for step in range(24):
        for s in "0123":
            t = float(rng.uniform(0.08, 0.12))
            if s == slow and 6 <= step < 16:
                t *= 4.0
            det.observe(s, t)
            jdet.observe(s, t)
        assert det.stragglers() == jdet.stragglers()
        assert det.ewma(slow) == jdet.ewma(slow)
    det.forget(slow)
    jdet.forget(slow)
    assert det.stragglers() == jdet.stragglers()
    for s in "0123":
        assert (reg.get("straggler_detected_total").labels(s).value
                == jreg.get("straggler_detected_total").labels(s).value)
    assert reg.get("straggler_detected_total").labels(slow).value == 1


# -- the snapshot ring -------------------------------------------------------


def _batches(rng, n, batch=8):
    xs, ys = arrays(rng, n, batch)
    return [DataSet(x, y) for x, y in zip(xs, ys)]


def test_snapshot_ring_capacity_and_host_isolation():
    reg = MetricsRegistry()
    ring = SnapshotRing(capacity=2, registry=reg)
    m = port_twin(jax_net())
    with pytest.raises(DeviceLostException):
        ring.restore_into_model(m)
    bs = _batches(np.random.RandomState(CHAOS_SEED), 3)
    ring.push(m, epoch_index=0)
    snap0 = ring.latest()
    first = next(iter(snap0["params"]))
    frozen = {k: v.clone() for k, v in snap0["params"][first].items()}
    for i, ds in enumerate(bs):
        m.fit_minibatch(ds)
        ring.push(m, epoch_index=i + 1)
    assert len(ring) == 2 and ring.latest()["step"] == 3
    assert ring.latest()["epoch_index"] == 3
    assert reg.get("snapshot_ring_saves_total").value == 4
    for k, v in frozen.items():
        assert torch.equal(v, snap0["params"][first][k])
    with pytest.raises(ValueError):
        SnapshotRing(capacity=0)


def test_snapshot_base_key_is_jax():
    jnet = jax_net(seed=1234)
    ring = SnapshotRing(registry=MetricsRegistry())
    snap = ring.push(port_twin(jnet))
    np.testing.assert_array_equal(snap["rng"], np.asarray(jnet._base_key))
    assert snap["rng"].dtype == np.asarray(jnet._base_key).dtype


def test_snapshot_restore_roundtrip_is_bitwise():
    jnet = jax_net()
    m, ref = port_twin(jnet), port_twin(jnet)
    bs = _batches(np.random.RandomState(CHAOS_SEED + 1), 6)
    for ds in bs[:3]:
        m.fit_minibatch(ds)
    ring = SnapshotRing(capacity=1, registry=MetricsRegistry())
    ring.push(m)
    for ds in bs:
        ref.fit_minibatch(ds)
    for ds in bs[3:5]:
        m.fit_minibatch(ds)
    before = m.params
    snap = ring.restore_into_model(m)
    assert snap["step"] == m.iteration_count == 3
    # fresh dicts and tensors: nothing of the live model nor the ring
    assert m.params is not before
    first = next(iter(m.params))
    assert (m.params[first]["W"].data_ptr()
            != snap["params"][first]["W"].data_ptr())
    for ds in bs[3:]:
        m.fit_minibatch(ds)
    got, want = (flat_trees(m.params, m.updater_state),
                 flat_trees(ref.params, ref.updater_state))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_snapshot_of_another_model_is_refused():
    ring = SnapshotRing(registry=MetricsRegistry())
    ring.push(port_twin(jax_net(seed=1)))
    with pytest.raises(ValueError, match="base key"):
        ring.restore_into_model(port_twin(jax_net(seed=2)))


def test_derive_rendezvous_never_reuses_a_store():
    assert derive_rendezvous("file:///t/rdv", 1) == "file:///t/rdv.elastic1"
    assert derive_rendezvous("file:///t/rdv", 2) == "file:///t/rdv.elastic2"
    assert derive_rendezvous("tcp://127.0.0.1:4000", 3) == \
        "tcp://127.0.0.1:4003"
    with pytest.raises(ValueError):
        derive_rendezvous("env://", 1)


def test_total_loss_is_unrecoverable():
    et = ElasticTrainer(port_twin(jax_net()), snapshot_every=2,
                        registry=MetricsRegistry())
    et.ring.push(et.model)
    with pytest.raises(DeviceLostException) as e:
        et.recover([str(r) for r in et.devices()])
    assert e.value.dead == ("0",)
    # ... and through the fit loop
    et.inject_device_loss(["0"])
    with pytest.raises(DeviceLostException):
        et.fit(_batches(np.random.RandomState(0), 3))


@pytest.mark.parametrize("cls", ["ElasticTrainer", "HostElasticTrainer"])
def test_elastic_rejects_tensor_parallel(cls):
    net = port_twin(jax_net())
    with pytest.raises(ValueError, match="data-parallel only"):
        if cls == "ElasticTrainer":
            ElasticTrainer(net, tensor_parallel=True)
        else:
            HostElasticTrainer(net, agent=None, tensor_parallel=True)


def test_elastic_world_of_one_is_the_engine_bitwise():
    """Without a loss, a world of one: the elastic loop's trajectory is
    the engine's own, snapshots and heartbeats included."""
    jnet = jax_net()
    m, ref = port_twin(jnet), port_twin(jnet)
    bs = _batches(np.random.RandomState(3), 6)
    reg = MetricsRegistry()
    scores = ElasticTrainer(m, snapshot_every=2, registry=reg).fit(bs)
    for ds in bs:
        ref.fit_minibatch(ds)
    assert len(scores) == 1 and np.isfinite(scores[0])
    assert m.iteration_count == 6 and m.epoch_count == 1
    assert reg.get("snapshot_ring_saves_total").value == 3
    got, want = (flat_trees(m.params, m.updater_state),
                 flat_trees(ref.params, ref.updater_state))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- ElasticTrainer on 4 gloo ranks -----------------------------------------

# One rank: the elastic run (ranks 2-3 lost at step 6), then the
# piecewise reference in a fresh world of 4 to the snapshot and of 2
# after. argv[1]: a JSON spec.
_CHILD = r"""
import json, sys
import numpy as np
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import (
    DeviceLostException, DistributedTrainer, ElasticTrainer, build_mesh,
    init_distributed, shutdown_distributed)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy, params_to_numpy, updater_state_to_numpy)

spec = json.loads(sys.argv[1])
rank, zero = spec["rank"], spec["zero"]
conf = MultiLayerConfiguration.from_dict(json.loads(open(spec["conf"]).read()))
init = dict(np.load(spec["init"]))
data = np.load(spec["data"])
batches = [DataSet(data[f"x{i}"], data[f"y{i}"])
           for i in range(len(data.files) // 2)]


def fresh():
    return MultiLayerNetwork(conf, device="cpu").init(
        params=params_from_numpy(init, "cpu"))


def dump(tag, model, upd, **extra):
    out = {"p:" + k: v for k, v in params_to_numpy(model.params).items()}
    out.update({"u:" + k: v for k, v in updater_state_to_numpy(upd).items()})
    out.update({k: np.asarray(v) for k, v in extra.items()})
    out["iteration"] = np.asarray(model.iteration_count)
    np.savez(spec["out"].format(tag=tag), **out)


class LoseAt:
    def __init__(self, et, at, shards):
        self.et, self.at, self.shards, self.fired = et, at, shards, False

    def iteration_done(self, model, it):
        if it == self.at and not self.fired:
            self.fired = True
            self.et.inject_device_loss(self.shards)


# -- the elastic run ---------------------------------------------------------
init_distributed("file://" + spec["rdv"], 4, rank, device="cpu",
                 timeout_s=120)
m = fresh()
reg = MetricsRegistry()
et = ElasticTrainer(m, snapshot_every=4, zero=zero, registry=reg)
m.listeners.append(LoseAt(et, 6, [2, 3]))
try:
    scores = et.fit(batches, epochs=1)
    dump("elastic", m, et.trainer.gather_updater_state(),
         recoveries=et.recoveries, devices=et.devices(),
         world=et.mesh.data, new_rank=et.mesh.rank, score=scores[0],
         layout=str(m._zero_layout),
         recovery_count=reg.get("elastic_recoveries_total").value,
         missed=reg.get("heartbeat_missed_total").labels("3").value,
         mesh_devices=reg.get("elastic_mesh_devices").value,
         snap_step=et.ring.latest()["step"])
except DeviceLostException as e:
    np.savez(spec["out"].format(tag="elastic"), lost=np.asarray(list(e.dead)),
             iteration=np.asarray(m.iteration_count))
shutdown_distributed()

# -- the piecewise reference -------------------------------------------------
init_distributed("file://" + spec["rdv"] + ".ref4", 4, rank, device="cpu",
                 timeout_s=120)
ref = fresh()
tr = DistributedTrainer(ref, zero=zero)
for ds in batches[:4]:
    tr.fit_minibatch(ds)
core.canonicalize_updater_state(ref)  # over the world of 4
shutdown_distributed()
if rank < 2:
    init_distributed("file://" + spec["rdv"] + ".ref2", 2, rank, device="cpu",
                     timeout_s=120)
    tr = DistributedTrainer(ref, mesh=build_mesh(data=2), zero=zero)
    for ds in batches[4:]:
        tr.fit_minibatch(ds)
    dump("reference", ref, tr.gather_updater_state())
    shutdown_distributed()
"""


def run_ranks(run, world, child, spec_of, timeout=RANK_TIMEOUT_S):
    """Run ``child`` on ``world`` processes (``spec_of(rank)``: each
    one's JSON spec); a run past ``timeout`` kills every rank and fails
    with their stderr. Returns the return codes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        logs.append(run / f"err{r}.txt")
        with open(logs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", child, json.dumps(spec_of(r))],
                cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL,
                stderr=err))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"ranks hung past {timeout} s:\n" + "\n---\n".join(
            log.read_text()[-2000:] for log in logs))
    return [p.returncode for p in procs], [log.read_text() for log in logs]


def jax_elastic(xs, ys, zero):
    """The JAX package's 8-device ElasticTrainer losing devices 4-7 at
    step 6, snapshots every 4."""
    conftest.require_devices(8)
    jnet = jax_net()
    et = JElastic(jnet, snapshot_every=4, zero=zero, registry=JRegistry())

    class Lose:
        fired = False

        def iteration_done(self, model, it):
            if it == 6 and not self.fired:
                self.fired = True
                et.inject_device_loss([4, 5, 6, 7])

    jnet.listeners.append(Lose())
    et.fit([JDataSet(x, y) for x, y in zip(xs, ys)], epochs=1)
    assert et.recoveries == 1 and len(et.devices()) == 4
    upd = jnet.updater_state
    if getattr(jnet, "_zero_layout", None):
        from deeplearning4j_tpu.nn import core as jcore

        upd = jcore.zero_gather_updater_state(upd, jnet.params)
    return flat_trees(jnet.params, upd)


@pytest.mark.chaos
@pytest.mark.parametrize("zero", [False, True])
def test_elastic_four_ranks_lose_two_bitwise_piecewise(tmp_path, zero):
    xs, ys = arrays(np.random.RandomState(CHAOS_SEED))
    jnet = jax_net()
    np.savez(tmp_path / "data.npz",
             **{f"x{i}": x for i, x in enumerate(xs)},
             **{f"y{i}": y for i, y in enumerate(ys)})
    np.savez(tmp_path / "init.npz", **{
        f"{ln}/{pn}": np.asarray(a)
        for ln, lp in jnet.params.items() for pn, a in lp.items()})
    (tmp_path / "conf.json").write_text(json.dumps(jnet.conf.to_dict()))
    rcs, logs = run_ranks(tmp_path, 4, _CHILD, lambda r: dict(
        rank=r, zero=zero, rdv=str(tmp_path / "rdv"),
        conf=str(tmp_path / "conf.json"), init=str(tmp_path / "init.npz"),
        data=str(tmp_path / "data.npz"),
        out=str(tmp_path / ("{tag}" + f"{r}.npz"))))
    for rc, log in zip(rcs, logs):
        assert rc == 0, log[-4000:]
    for r in (2, 3):  # the lost ranks left with DeviceLostException
        lost = np.load(tmp_path / f"elastic{r}.npz")
        assert sorted(lost["lost"].tolist()) == ["2", "3"]
        assert int(lost["iteration"]) == 6
    res = [dict(np.load(tmp_path / f"elastic{r}.npz")) for r in (0, 1)]
    refs = [dict(np.load(tmp_path / f"reference{r}.npz")) for r in (0, 1)]
    for r, got in enumerate(res):
        assert int(got["recoveries"]) == 1
        assert got["devices"].tolist() == [0, 1]
        assert (int(got["world"]), int(got["new_rank"])) == (2, r)
        assert int(got["iteration"]) == 12
        assert int(got["snap_step"]) == 8  # snapshots at 4 (rollback), 8
        assert float(got["recovery_count"]) == 1
        assert float(got["missed"]) == 1
        assert float(got["mesh_devices"]) == 2
        assert str(got["layout"]) == ("{'shards': 2}" if zero else "None")
        for k, v in refs[r].items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # ... and the JAX package's 8-device run, within kernel_tols
    want = jax_elastic(xs, ys, zero)
    rtol, atol = kernel_tols()
    got = {k: v for k, v in res[0].items() if k[:2] in ("p:", "u:")}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# -- HostElasticTrainer: the two-process SIGKILL storm ----------------------

_WORKER = r"""
import json, os, pickle, sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    HostElasticTrainer, WorkerAgent, build_mesh, init_distributed_elastic)
from deeplearning4j_tpu_torch.resilience.chaos import KillAtStep
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy, params_to_numpy, updater_state_to_numpy)

spec = json.loads(sys.argv[1])
rank = spec["rank"]
conf = MultiLayerConfiguration.from_dict(json.loads(open(spec["conf"]).read()))
data = np.load(spec["data"])
batches = [DataSet(data[f"x{i}"], data[f"y{i}"])
           for i in range(len(data.files) // 2)]
agent = WorkerAgent(spec["control"], rank_hint=rank)
grant = agent.join(timeout_s=60)
agent.start_renewals()  # before the bring-up: keep renewing
init_distributed_elastic(grant.rendezvous, grant.num, grant.rank,
                         device="cpu", timeout_s=60)
net = MultiLayerNetwork(conf, device="cpu").init(
    params=params_from_numpy(dict(np.load(spec["init"])), "cpu"))
tr = HostElasticTrainer(net, agent, mesh=build_mesh(data=grant.num),
                        snapshot_every=spec["snap_every"], zero=spec["zero"])
if spec["kill_at"] >= 0:
    net.listeners.append(KillAtStep(spec["kill_at"]))
tr.fit(batches, epochs=1)
upd = tr.trainer.gather_updater_state()
with open(spec["out"], "wb") as f:
    pickle.dump({
        "member": agent.member, "epoch": agent.epoch,
        "iteration": int(net.iteration_count),
        "recoveries": tr.recoveries, "last_recovery": tr.last_recovery,
        "snapshot": tr.last_recovery_snapshot,
        "params": params_to_numpy(net.params),
        "updater": updater_state_to_numpy(upd)}, f)
agent.close()
print(f"CP_OK rank={rank} recoveries={tr.recoveries}")
"""

_REFERENCE = r"""
import json, pickle, sys
import numpy as np
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import (
    DistributedTrainer, SnapshotRing, build_mesh, init_distributed,
    shutdown_distributed)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_to_numpy, updater_state_to_numpy)

spec = json.loads(sys.argv[1])
conf = MultiLayerConfiguration.from_dict(json.loads(open(spec["conf"]).read()))
data = np.load(spec["data"])
batches = [DataSet(data[f"x{i}"], data[f"y{i}"])
           for i in range(len(data.files) // 2)]
with open(spec["snapshot"], "rb") as f:
    snap = pickle.load(f)
net = MultiLayerNetwork(conf, device="cpu").init()
ring = SnapshotRing(registry=MetricsRegistry())
ring._ring.append(snap)
ring.restore_into_model(net)
# survivor width: a gloo world of one, the survivor's zero flag
init_distributed("file://" + spec["rdv"], 1, 0, device="cpu", timeout_s=60)
tr = DistributedTrainer(net, mesh=build_mesh(data=1), zero=spec["zero"])
for ds in batches[snap["epoch_index"]:]:
    tr.fit_minibatch(ds)
with open(spec["out"], "wb") as f:
    pickle.dump({"iteration": int(net.iteration_count),
                 "params": params_to_numpy(net.params),
                 "updater": updater_state_to_numpy(
                     tr.gather_updater_state())}, f)
shutdown_distributed()
print("REF_OK")
"""


def sigkill_storm(tmp_path, zero, n_batches=12, snap_every=4, kill_at=7):
    """SIGKILL rank 1 at step ``kill_at``: rank 0 re-forms a world of
    one within one snapshot window and finishes bitwise the piecewise
    reference."""
    xs, ys = arrays(np.random.RandomState(0), n_batches, batch=8)
    jnet = jax_net(seed=42)
    np.savez(tmp_path / "data.npz",
             **{f"x{i}": x for i, x in enumerate(xs)},
             **{f"y{i}": y for i, y in enumerate(ys)})
    np.savez(tmp_path / "init.npz", **{
        f"{ln}/{pn}": np.asarray(a)
        for ln, lp in jnet.params.items() for pn, a in lp.items()})
    (tmp_path / "conf.json").write_text(json.dumps(jnet.conf.to_dict()))
    common = dict(conf=str(tmp_path / "conf.json"),
                  data=str(tmp_path / "data.npz"), zero=zero)
    coord = LeaseCoordinator(2, lease_s=2.0, barrier_timeout_s=60.0,
                             registry=MetricsRegistry()).start()
    try:
        rcs, logs = run_ranks(tmp_path, 2, _WORKER, lambda r: dict(
            common, rank=r, control=coord.address,
            init=str(tmp_path / "init.npz"), snap_every=snap_every,
            kill_at=kill_at if r == 1 else -1,
            out=str(tmp_path / f"rank{r}.pkl")))
    finally:
        coord.stop()
    assert rcs[1] == -signal.SIGKILL, logs[1][-3000:]
    assert rcs[0] == 0, logs[0][-4000:]
    with open(tmp_path / "rank0.pkl", "rb") as f:
        surv = pickle.load(f)
    assert surv["recoveries"] == 1
    assert surv["iteration"] == n_batches
    rec = surv["last_recovery"]
    assert rec["survivors"] == 1 and rec["dead"] == [1]
    assert kill_at - snap_every <= rec["rolled_back_to"] <= kill_at
    snap = surv["snapshot"]
    assert snap["step"] == rec["rolled_back_to"] == 4
    with open(tmp_path / "snapshot.pkl", "wb") as f:
        pickle.dump(snap, f)
    rcs, logs = run_ranks(tmp_path, 1, _REFERENCE, lambda r: dict(
        common, snapshot=str(tmp_path / "snapshot.pkl"),
        rdv=str(tmp_path / "ref_rdv"), out=str(tmp_path / "ref.pkl")))
    assert rcs[0] == 0, logs[0][-4000:]
    with open(tmp_path / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    assert ref["iteration"] == surv["iteration"]
    for tree in ("params", "updater"):
        assert surv[tree].keys() == ref[tree].keys()
        for k, v in ref[tree].items():
            np.testing.assert_array_equal(surv[tree][k], v,
                                          err_msg=f"{tree} {k}")


@pytest.mark.chaos
def test_storm_sigkill_host_loss_bitwise(tmp_path):
    sigkill_storm(tmp_path, zero=False)


@pytest.mark.chaos
def test_storm_sigkill_host_loss_bitwise_zero(tmp_path):
    sigkill_storm(tmp_path, zero=True)
