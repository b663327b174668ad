"""The port's control plane (``parallel/control_plane.py``) on the CPU,
against the JAX package's.

- ``LeaseState``: the port's and the JAX package's under one fake
  clock, the same scripted sequences (formation, renew, expiry with
  its fence and epoch bump, a barrier turned into a plan, a rejoin as
  a fresh member, a graceful leave, a stale epoch, the sync fence) and
  seeded random ones through both; every response and ``info()`` is
  compared after each op, and the metrics after the run. The JAX
  package's ``jax_coordinator`` (``host:port``) is the port's
  ``rendezvous`` (``tcp://host:port``); nothing else differs.
- ``WorkerAgent`` over ``LocalTransport`` and over TCP threads: join,
  barrier, a stale epoch turned into a plan, a fence, a third member
  admitted mid-run.
- ``ControlChannelChaos`` storms: dropped renewals survived, delayed
  frames, a partition ending in ``CoordinatorLostException``, and the
  coordinator lost mid-fit ending in a checkpoint and exit 75 through
  ``exit_on_preemption`` (76 without a manager).
- ``LeaseCommitBarrier``: a two-agent sharded checkpoint committed and
  restored bitwise; a commit aborted when membership changes under it.
- ``init_distributed``'s bounded retry (the JAX package's
  ``tests/test_control_plane.py`` cases over ``dist.init_process_group``)
  and ``reform_distributed`` on a gloo world of one.

Tolerances: none; the state machines are compared exactly, and
checkpoints carry values bitwise.
"""

import json
import random
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.observability.metrics import (
    MetricsRegistry as JRegistry,
)
from deeplearning4j_tpu.parallel.control_plane import LeaseState as JLeaseState
from deeplearning4j_tpu.parallel.control_plane import (
    RecoveryPlan as JRecoveryPlan,
)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.exceptions import (
    CheckpointCommitAbortedException,
    DL4JFaultException,
)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import (
    ControlPlaneException,
    CoordinatorLostException,
    HostElasticTrainer,
    HostFencedException,
    LeaseCoordinator,
    LeaseState,
    LocalTransport,
    RecoveryPlan,
    TcpTransport,
    WorkerAgent,
    build_mesh,
    init_distributed,
    reform_distributed,
    shutdown_distributed,
)
from deeplearning4j_tpu_torch.parallel import control_plane
from deeplearning4j_tpu_torch.resilience.chaos import (
    ChaosPolicy,
    ControlChannelChaos,
)
from deeplearning4j_tpu_torch.resilience.checkpoint import (
    CheckpointManager,
    LeaseCommitBarrier,
)
from deeplearning4j_tpu_torch.resilience.preemption import (
    EXIT_PREEMPTED,
    EXIT_PREEMPTED_DIRTY,
    PreemptedException,
    exit_on_preemption,
)
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy

CHAOS_SEED = 1337


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _state(n=2, lease_s=2.0, **kw):
    fc = FakeClock()
    kw.setdefault("port_factory", lambda: 4242)
    kw.setdefault("registry", MetricsRegistry())
    return LeaseState(n, lease_s=lease_s, clock=fc, **kw), fc


def _fast_policy():
    return RetryPolicy(max_attempts=3, base_delay=0.001,
                       max_delay=0.002, total_timeout=5.0)


def simple_net(seed=11):
    conf = (NeuralNetConfiguration.Builder().seed(seed).learning_rate(0.05)
            .updater("ADAM").list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def mk_batches(rng, n_batches=8, batch=8):
    return [DataSet(rng.randn(batch, 4).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)])
            for _ in range(n_batches)]


# -- LeaseState against the JAX package's, op by op -------------------------


def _norm(x):
    """A JAX response in the port's names: ``jax_coordinator`` ``h:p``
    is ``rendezvous`` ``tcp://h:p``."""
    if isinstance(x, dict):
        return {("rendezvous" if k == "jax_coordinator" else k):
                ("tcp://" + v if k == "jax_coordinator" else _norm(v))
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


class Twin:
    """The port's and the JAX package's ``LeaseState`` under one fake
    clock; ``do(op)`` runs ``op`` on both and asserts the same answer
    and the same ``info()``."""

    def __init__(self, n=2, lease_s=2.0, admit_joins=True):
        self.clock = FakeClock()
        self.reg, self.jreg = MetricsRegistry(), JRegistry()
        kw = dict(lease_s=lease_s, clock=self.clock,
                  port_factory=lambda: 4242, admit_joins=admit_joins)
        self.port = LeaseState(n, registry=self.reg, **kw)
        self.jax = JLeaseState(n, registry=self.jreg, **kw)
        self.ops = []

    @staticmethod
    def _run(st, op):
        kind, *a = op
        return {"join": st.join, "grant": st.grant_for, "renew": st.renew,
                "leave": st.leave, "arrive": st.arrive, "sync": st.sync,
                "touch": st.touch, "info": st.info}[kind](*a)

    def do(self, *op):
        self.ops.append(op)
        if op[0] == "advance":
            self.clock.advance(op[1])
            return None
        got, want = self._run(self.port, op), self._run(self.jax, op)
        assert got == _norm(want), (self.ops, got, want)
        assert self.port.info() == _norm(self.jax.info()), self.ops
        return got

    def metrics(self):
        def read(reg, name, label=None):
            fam = reg.get(name)
            inst = fam._default() if label is None else fam.labels(label)
            return inst.value

        out = {}
        for name in ("lease_renewals_total", "control_epoch"):
            out[name] = (read(self.reg, name), read(self.jreg, name))
        for m in range(6):
            out[f"expired{m}"] = (
                read(self.reg, "lease_expired_total", str(m)),
                read(self.jreg, "lease_expired_total", str(m)))
        return out


SCRIPTS = {
    # formation at the expected count; the grant before and after
    "formation": [("grant", 0), ("join", 0), ("grant", 0), ("join", 1),
                  ("grant", 0), ("grant", 1), ("join", 7), ("grant", 2)],
    "renew": [("join", 0), ("join", 1)]
    + [op for _ in range(5) for op in (("advance", 1.5), ("renew", 0, 1),
                                       ("renew", 1, 1))],
    # member 0's lease runs out: fenced, epoch 2, plan to member 1
    "expiry": [("join", 0), ("join", 1), ("advance", 1.0), ("renew", 1, 1),
               ("advance", 1.5), ("renew", 1, 1), ("renew", 0, 1),
               ("arrive", 0, 2, 9), ("grant", 0), ("info",)],
    "no_expiry_while_forming": [("join", 0), ("advance", 100.0),
                                ("join", 1), ("grant", 0)],
    "barrier_refreshes": [("join", 0), ("join", 1), ("arrive", 0, 1, 0),
                          ("advance", 1.5), ("arrive", 0, 1, 0),
                          ("renew", 1, 1), ("advance", 1.0),
                          ("arrive", 1, 1, 0), ("arrive", 0, 1, 0)],
    "barrier_into_plan": [("join", 0), ("join", 1), ("arrive", 0, 1, 3),
                          ("advance", 1.5), ("arrive", 0, 1, 3),
                          ("advance", 1.0), ("arrive", 0, 1, 3)],
    "rejoin_fresh": [("join", 0), ("join", 1), ("advance", 1.0),
                     ("renew", 1, 1), ("advance", 1.5), ("renew", 1, 1),
                     ("join", 0), ("grant", 2), ("arrive", 1, 2, 7),
                     ("grant", 2), ("renew", 0, 3), ("arrive", 2, 3, 7),
                     ("arrive", 1, 3, 7)],
    "leave": [("join", 0), ("join", 1), ("leave", 0), ("grant", 1),
              ("renew", 0, 2), ("leave", 1), ("info",), ("grant", 1)],
    "stale_epoch": [("join", 0), ("join", 1), ("leave", 1),
                    ("renew", 0, 1), ("arrive", 0, 1, 0),
                    ("sync", 0, 1, "k", None)],
    # the commit fence: payloads returned on proceed; a pending join
    # does not bump the epoch here; a death clears in-flight keys
    "sync_fence": [("join", 0), ("join", 1), ("sync", 0, 1, "c1", {"d": 0}),
                   ("sync", 1, 1, "c1", {"d": 1}),
                   ("sync", 0, 1, "c1", {"d": 0}), ("join", None),
                   ("sync", 0, 1, "c2", [1, 2]), ("advance", 2.5),
                   ("sync", 0, 1, "c2", [1, 2]), ("info",)],
    "three_members": [("join", 2), ("join", 2), ("join", None),
                      ("grant", 0), ("grant", 2), ("arrive", 0, 1, 0),
                      ("arrive", 1, 1, 0), ("arrive", 2, 1, 0),
                      ("advance", 1.9), ("renew", 2, 1), ("advance", 0.5),
                      ("arrive", 2, 1, 1), ("info",)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_lease_state_scripts_match_jax(name):
    n = 3 if name == "three_members" else 2
    tw = Twin(n)
    for op in SCRIPTS[name]:
        tw.do(*op)
    for k, (got, want) in tw.metrics().items():
        assert got == want, (k, got, want)


@pytest.mark.parametrize("seed", range(8))
def test_lease_state_random_sequences_match_jax(seed):
    rng = random.Random(seed)
    n = 1 + seed % 3
    tw = Twin(n, lease_s=2.0, admit_joins=seed % 4 != 3)
    for _ in range(80):
        # read without a sweep: the draw must not move either state
        epoch = tw.port.epoch
        m = rng.choice(range(tw.port._next_id + 1))
        e = rng.choice([epoch, epoch, max(epoch - 1, 0)])
        kind = rng.choice(["join", "grant", "renew", "renew", "leave",
                           "arrive", "arrive", "sync", "touch", "info",
                           "advance", "advance"])
        if kind == "join":
            tw.do("join", rng.choice([None, 0, 1, 2, 3]))
        elif kind in ("grant", "leave", "touch"):
            tw.do(kind, m)
        elif kind == "renew":
            tw.do("renew", m, e)
        elif kind == "arrive":
            tw.do("arrive", m, e, rng.randrange(4))
        elif kind == "sync":
            tw.do("sync", m, e, rng.choice("ab"), {"d": m})
        elif kind == "info":
            tw.do("info")
        else:
            tw.do("advance", rng.choice([0.3, 0.9, 1.6, 2.5]))
    for k, (got, want) in tw.metrics().items():
        assert got == want, (k, got, want)


def test_recovery_plan_fields_match_jax():
    tw = Twin(2)
    for op in SCRIPTS["expiry"][:6]:
        tw.do(*op)
    r = tw.port.renew(1, 1)
    plan, jplan = (RecoveryPlan.from_dict(r["plan"]),
                   JRecoveryPlan.from_dict(tw.jax.renew(1, 1)["plan"]))
    assert plan.rendezvous == "tcp://" + jplan.jax_coordinator \
        == "tcp://127.0.0.1:4242"
    for f in ("epoch", "term", "members", "num", "member", "rank", "dead",
              "admitted", "lease_s"):
        assert getattr(plan, f) == getattr(jplan, f), f
    assert (plan.epoch, plan.members, plan.dead) == (2, (1,), (0,))


def test_lease_state_refuses_bad_arguments():
    with pytest.raises(ValueError):
        LeaseState(0)
    with pytest.raises(ValueError):
        LeaseState(1, lease_s=0)


# -- the worker agent over the in-process transport --------------------------


def _local_agent(st, rank=0, **kw):
    kw.setdefault("policy", _fast_policy())
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("registry", MetricsRegistry())
    return WorkerAgent(LocalTransport(st), rank_hint=rank, **kw)


def _join_pair(st):
    a0, a1 = _local_agent(st, 0), _local_agent(st, 1)
    t = threading.Thread(target=a0.join)  # polls until formed
    t.start()
    a1.join()
    t.join(5)
    assert not t.is_alive()
    return a0, a1


def test_agent_join_and_barrier_local():
    st, fc = _state(2)
    a0, a1 = _join_pair(st)
    assert (a0.rank, a0.num, a1.rank) == (0, 2, 1)
    assert a1.epoch == 1 and a1.rendezvous == "tcp://127.0.0.1:4242"
    done = []
    t = threading.Thread(target=lambda: done.append(a1.step_barrier(0)))
    t.start()
    assert a0.step_barrier(0) is None
    t.join(5)
    assert done == [None]


def test_agent_stale_epoch_returns_plan_and_adopt():
    st, fc = _state(2)
    a0, a1 = _join_pair(st)
    fc.advance(1.0)
    a1.renew()
    fc.advance(1.5)  # a0's member dies
    plan = a1.step_barrier(1)
    assert isinstance(plan, RecoveryPlan)
    assert plan.dead == (0,) and plan.num == 1
    a1.adopt(plan)
    assert a1.epoch == plan.epoch and a1.rank == 0
    assert a1.step_barrier(1) is None  # alone at the new epoch


def test_agent_fence_raises_and_sticks():
    st, fc = _state(1)
    a = _local_agent(st, 0)
    a.join()
    fc.advance(5.0)
    st.info()  # the sweep declares the member dead
    with pytest.raises(HostFencedException):
        a.renew()
    with pytest.raises(HostFencedException):
        a.raise_verdicts()
    control_plane.install_agent(a)
    try:
        assert control_plane.active_agent() is a
        with pytest.raises(HostFencedException):
            control_plane.check_fit()
    finally:
        control_plane.uninstall_agent(a)
    assert control_plane.active_agent() is None
    control_plane.check_fit()  # no agent: a no-op


def test_fit_loops_surface_an_agents_verdict():
    """Every fit loop calls ``control_plane.check_fit`` at its step
    boundary: a verdict the renewal thread reached stops the engine's
    per-step fit, its scan chunks and the trainer's fit."""
    st, fc = _state(1)
    a = _local_agent(st, 0)
    a.join()
    a._lost = True
    net = simple_net()
    data = mk_batches(np.random.RandomState(0), n_batches=4)
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer

    control_plane.install_agent(a)
    try:
        for scan_chunk in (1, 16):
            net.scan_chunk = scan_chunk
            with pytest.raises(CoordinatorLostException):
                net.fit(ListDataSetIterator(data))
        with pytest.raises(CoordinatorLostException):
            DistributedTrainer(net).fit(ListDataSetIterator(data))
        assert net.iteration_count == 0
    finally:
        control_plane.uninstall_agent(a)


def test_agent_renewal_thread_keeps_the_lease():
    st = LeaseState(1, lease_s=0.3, port_factory=lambda: 4242,
                    registry=MetricsRegistry())
    a = WorkerAgent(LocalTransport(st), rank_hint=0, policy=_fast_policy(),
                    registry=MetricsRegistry())
    a.join()
    a.start_renewals()
    try:
        time.sleep(1.0)  # three lease windows
        assert st.info()["members"] == [0]
        assert a.step_barrier(0) is None
    finally:
        a.close()


# -- chaos storms over the control channel -----------------------------------


@pytest.mark.chaos
def test_storm_heartbeat_drops_survive_retry():
    st, fc = _state(1, lease_s=10.0)
    chaos = ControlChannelChaos(
        LocalTransport(st),
        policy=ChaosPolicy(seed=CHAOS_SEED, fail_calls={"renew": {0, 2, 4}}))
    a = WorkerAgent(chaos, rank_hint=0, policy=_fast_policy(),
                    sleep=lambda s: None, registry=MetricsRegistry())
    a.join()
    for _ in range(3):
        assert a.renew() is None  # success despite the drop
    assert len(chaos.policy.injected) == 3
    assert st.info()["members"] == [0]


@pytest.mark.chaos
def test_storm_heartbeat_delay_frames():
    st, fc = _state(1, lease_s=10.0)
    slept = []
    chaos = ControlChannelChaos(LocalTransport(st), delay={"renew": 0.25},
                                sleep=slept.append)
    reg = MetricsRegistry()
    a = WorkerAgent(chaos, rank_hint=0, policy=_fast_policy(),
                    sleep=lambda s: None, registry=reg)
    a.join()
    assert a.renew() is None
    assert slept == [0.25]
    assert reg.get("control_rtt_ms")._default().count >= 2


@pytest.mark.chaos
def test_storm_partition_concludes_coordinator_lost():
    st, fc = _state(1, lease_s=10.0)
    chaos = ControlChannelChaos(LocalTransport(st), partition=(2, 1 << 30))
    a = WorkerAgent(chaos, rank_hint=0, policy=_fast_policy(),
                    sleep=lambda s: None, registry=MetricsRegistry())
    a.join()
    with pytest.raises(CoordinatorLostException) as ei:
        for step in range(10):
            a.step_barrier(step)
    assert isinstance(ei.value.__cause__, DL4JFaultException)
    assert all(op == "barrier" for op, _ in chaos.requests[2:5])
    # the verdict is sticky for the fit loops' hook
    with pytest.raises(CoordinatorLostException):
        a.raise_verdicts()


def _partitioned_trainer(tmp_path, manager):
    st, _ = _state(1, lease_s=1000.0)
    a = WorkerAgent(ControlChannelChaos(LocalTransport(st),
                                        partition=(4, 1 << 30)),
                    rank_hint=0, policy=_fast_policy(), sleep=lambda s: None,
                    registry=MetricsRegistry())
    a.join()
    net = simple_net()
    return net, HostElasticTrainer(net, a, mesh=build_mesh(device="cpu"),
                                   snapshot_every=2,
                                   checkpoint_manager=manager,
                                   registry=MetricsRegistry())


@pytest.mark.chaos
def test_storm_coordinator_loss_checkpoints_and_exits_75(tmp_path):
    """Coordinator gone mid-fit: the trainer checkpoints, raises
    ``PreemptedException(reason="coordinator-lost")`` at the step it
    reached, and ``exit_on_preemption`` exits 75; the checkpoint holds
    that step and restores bitwise."""
    mgr = CheckpointManager(tmp_path, keep_last=2, device="cpu")
    data = mk_batches(np.random.RandomState(0), n_batches=8)
    net, tr = _partitioned_trainer(tmp_path, mgr)
    with pytest.raises(PreemptedException) as ei:
        tr.fit(data)
    e = ei.value
    assert e.reason == "coordinator-lost"
    assert e.checkpoint is not None and not e.checkpoint_failed
    assert e.exit_code == EXIT_PREEMPTED == 75
    # requests 0-3 (join, barriers 0-2) pass: three steps were taken
    assert e.step == net.iteration_count == 3
    restored, info = mgr.restore_latest()
    assert info.step == 3
    for ln, lp in net.params.items():
        for pn, t in lp.items():
            assert torch.equal(restored.params[ln][pn], t)
    _, tr2 = _partitioned_trainer(tmp_path, mgr)
    with pytest.raises(SystemExit) as se:
        with exit_on_preemption():
            tr2.fit(data)
    assert se.value.code == 75


@pytest.mark.chaos
def test_storm_coordinator_loss_without_a_manager_exits_76(tmp_path):
    _, tr = _partitioned_trainer(tmp_path, None)
    data = mk_batches(np.random.RandomState(0), n_batches=8)
    with pytest.raises(SystemExit) as se:
        with exit_on_preemption():
            tr.fit(data)
    assert se.value.code == EXIT_PREEMPTED_DIRTY == 76


def test_coordinator_loss_is_bounded_by_the_retry_policy():
    """A real coordinator stopped: the agent's barrier exhausts its
    retries within the policy's bound instead of hanging."""
    coord = LeaseCoordinator(1, lease_s=30.0).start()
    pol = RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=0.1,
                      total_timeout=3.0)
    a = WorkerAgent(coord.address, rank_hint=0, policy=pol,
                    registry=MetricsRegistry())
    a.join(timeout_s=10)
    assert a.step_barrier(0) is None
    coord.stop()
    t0 = time.monotonic()
    with pytest.raises(CoordinatorLostException):
        a.step_barrier(1)
    assert time.monotonic() - t0 < 3.5


# -- the TCP coordinator -----------------------------------------------------


def test_tcp_join_barrier_and_rejoin():
    with LeaseCoordinator(2, lease_s=5.0) as coord:
        agents, errs = {}, []

        def run(r):
            try:
                a = WorkerAgent(coord.address, rank_hint=r,
                                registry=MetricsRegistry())
                a.join(timeout_s=15)
                agents[r] = a
                for step in range(3):
                    assert a.step_barrier(step) is None
            except Exception as e:  # surfaced below
                errs.append(e)

        ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not errs, errs
        assert {agents[r].rank for r in agents} == {0, 1}
        assert agents[0].rendezvous.startswith("tcp://127.0.0.1:")
        info = TcpTransport(coord.address).request({"op": "info"})
        assert info["members"] == sorted(a.member for a in agents.values())
        assert TcpTransport(coord.address).request(
            {"op": "nope"})["error"] == "bad_op"
        # a third worker joins mid-run: admitted at the next barrier
        joined = {}
        t3 = threading.Thread(target=lambda: joined.update(
            plan=WorkerAgent(coord.address,
                             registry=MetricsRegistry()).join(timeout_s=20)))
        t3.start()
        deadline = time.monotonic() + 10
        while not coord.state.info()["pending"]:
            assert time.monotonic() < deadline, "join never registered"
            time.sleep(0.01)
        plans = [agents[r].step_barrier(3) for r in range(2)]
        assert all(isinstance(p, RecoveryPlan) for p in plans)
        for r in range(2):
            agents[r].adopt(plans[r])
        t3.join(20)
        assert joined["plan"].num == 3
        assert set(joined["plan"].admitted) == {joined["plan"].member}
        assert plans[0].epoch == 2
        assert agents[0].rendezvous == joined["plan"].rendezvous


# -- the commit fence over the lease coordinator ----------------------------


def _join_all(agents):
    ts = [threading.Thread(target=a.join, kwargs={"timeout_s": 10})
          for a in agents]
    for t in ts:
        t.start()
    for t in ts:
        t.join(20)


def _trained_net():
    net = simple_net(seed=7)
    for ds in mk_batches(np.random.RandomState(1), n_batches=2):
        net.fit_minibatch(ds)
    return net


def test_lease_commit_barrier_two_host_commit(tmp_path):
    net = _trained_net()
    st = LeaseState(2, lease_s=10.0, registry=MetricsRegistry())
    agents = [WorkerAgent(LocalTransport(st), rank_hint=r,
                          sleep=lambda s: time.sleep(0.001),
                          registry=MetricsRegistry()) for r in range(2)]
    _join_all(agents)
    mgrs = [CheckpointManager(tmp_path, commit=LeaseCommitBarrier(a),
                              keep_last=5, device="cpu") for a in agents]
    assert [b.commit.rank for b in mgrs] == [0, 1]
    assert [b.commit.nshards for b in mgrs] == [2, 2]
    infos = [None, None]

    def save(r):
        infos[r] = mgrs[r].save(net)

    ts = [threading.Thread(target=save, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert all(i is not None for i in infos)
    assert infos[0].nshards == 2 and sorted(infos[0].shards) == ["0", "1"]
    assert infos[0].to_manifest() == infos[1].to_manifest()
    restored, got = mgrs[0].restore_latest()
    assert got.step == 2 == restored.iteration_count
    for ln, lp in net.params.items():
        for pn, t in lp.items():
            assert torch.equal(restored.params[ln][pn], t)
        for pn, tup in net.updater_state[ln].items():
            for u, v in zip(restored.updater_state[ln][pn], tup):
                assert torch.equal(u, v)


def test_lease_commit_barrier_aborts_on_membership_change(tmp_path):
    net = _trained_net()
    st = LeaseState(2, lease_s=10.0, registry=MetricsRegistry())
    agents = [WorkerAgent(LocalTransport(st), rank_hint=r,
                          sleep=lambda s: time.sleep(0.002),
                          registry=MetricsRegistry()) for r in range(2)]
    _join_all(agents)
    mgr = CheckpointManager(tmp_path, commit=LeaseCommitBarrier(agents[0]),
                            keep_last=5, device="cpu")
    errs = []

    def save():
        try:
            mgr.save(net)
        except Exception as e:  # surfaced below
            errs.append(e)

    t = threading.Thread(target=save)
    t.start()
    deadline = time.monotonic() + 10
    while not st._synced:  # member 0 waits at the fence
        assert time.monotonic() < deadline
        time.sleep(0.005)
    st.leave(1)  # the membership the shards were written under is gone
    t.join(20)
    assert len(errs) == 1
    assert isinstance(errs[0], CheckpointCommitAbortedException)
    assert mgr.latest_step() is None  # nothing committed


# -- init_distributed's bounded retry and the re-formation ------------------


def test_init_distributed_bounded_retry_fails_fast(monkeypatch):
    import torch.distributed as dist

    calls = []

    def boom(backend, **kw):
        calls.append(kw)
        raise RuntimeError("DistStoreError: timed out waiting for peers")

    monkeypatch.setattr(dist, "init_process_group", boom)
    pol = RetryPolicy(max_attempts=3, base_delay=0.001, max_delay=0.002,
                      retry_on=(OSError, TimeoutError, RuntimeError))
    with pytest.raises(DL4JFaultException) as ei:
        init_distributed("tcp://127.0.0.1:1", 2, 0, device="cpu",
                         timeout_s=5.0, policy=pol)
    assert len(calls) == 3  # bounded, not hanging
    assert "tcp://127.0.0.1:1" in str(ei.value)
    assert ei.value.__cause__ is not None  # chained
    # the per-attempt slice of the budget reached torch
    assert calls[0]["timeout"].total_seconds() == 2


def test_init_distributed_file_rendezvous_is_one_attempt(monkeypatch):
    import torch.distributed as dist

    calls = []

    def boom(backend, **kw):
        calls.append(kw)
        raise RuntimeError("timed out")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(DL4JFaultException):
        init_distributed("file:///nowhere/rdv", 2, 0, device="cpu",
                         timeout_s=5.0)
    assert len(calls) == 1 and calls[0]["timeout"].total_seconds() == 5


def test_init_distributed_double_init_not_retried(monkeypatch):
    import torch.distributed as dist

    calls = []

    def boom(backend, **kw):
        calls.append(kw)
        raise RuntimeError("trying to initialize the default process "
                           "group twice!")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(DL4JFaultException) as ei:
        init_distributed("tcp://127.0.0.1:1", 2, 0, device="cpu",
                         timeout_s=5.0)
    assert len(calls) == 1  # not retryable: fails at once
    assert "shutdown_distributed" in str(ei.value)


def test_init_distributed_no_budget_is_unchanged(monkeypatch):
    import torch.distributed as dist

    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    monkeypatch.delenv("DL4J_TPU_INIT_TIMEOUT_S", raising=False)
    init_distributed("tcp://127.0.0.1:9", 2, 1, device="cpu")
    assert len(seen) == 1
    backend, kw = seen[0]
    assert backend == "gloo" and kw["init_method"] == "tcp://127.0.0.1:9"
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert kw["timeout"].total_seconds() == 300


def test_gloo_on_a_card_is_named_never_picked():
    from deeplearning4j_tpu_torch.parallel.mesh import _world_backend

    assert _world_backend(torch.device("cpu"), None) == "gloo"
    assert _world_backend(torch.device("cuda", 0), None) == "nccl"
    assert _world_backend(torch.device("cuda", 0), "gloo") == "gloo"
    with pytest.raises(ValueError):
        _world_backend(torch.device("cpu"), "nccl")
    with pytest.raises(ValueError):
        _world_backend(torch.device("cpu"), "mpi")


def test_reform_distributed_world_of_one_on_gloo():
    """The re-formation cycle on a gloo world of one: join a first
    world, then ``reform_distributed`` over a plan's fresh rendezvous
    (the old group aborted, never waited on); the new world reduces."""
    import torch.distributed as dist

    port = control_plane._ephemeral_port()
    try:
        init_distributed(f"tcp://127.0.0.1:{port}", 1, 0, device="cpu",
                         timeout_s=30)
        plan = RecoveryPlan(epoch=2, term=2, members=(5,), num=1,
                            rendezvous="tcp://127.0.0.1:%d"
                            % control_plane._ephemeral_port(),
                            member=5, rank=0)
        mesh = reform_distributed(plan, device="cpu")
        assert (mesh.data, mesh.rank, mesh.backend) == (1, 0, "gloo")
        x = torch.ones(3)
        dist.all_reduce(x)
        assert x.tolist() == [1.0, 1.0, 1.0]
        with pytest.raises(DL4JFaultException):
            reform_distributed({"num": 1, "rank": 0}, device="cpu")
    finally:
        shutdown_distributed()
    assert not dist.is_initialized()


def test_control_plane_exceptions_are_faults():
    assert issubclass(CoordinatorLostException, ControlPlaneException)
    assert issubclass(HostFencedException, ControlPlaneException)
    assert issubclass(ControlPlaneException, DL4JFaultException)
    doc = json.loads(json.dumps({"epoch": 3, "term": 3, "members": [1, 4],
                                 "num": 2, "rendezvous": "tcp://h:1",
                                 "member": 4, "rank": 1}))
    plan = RecoveryPlan.from_dict(doc)
    assert plan.members == (1, 4) and plan.rank == 1 and plan.lease_s == 2.0
