"""The port's pipelined training loop on the CPU: the prefetching input
pipeline (``datasets/prefetch.py``), the dispatch window
(``parallel/dispatch.py``), the engines' epoch loop (``core.fit_batches``)
and the trainer's ``fit`` with prefetch and megastep, against the plain
per-step loop and the JAX package.

The contract is trajectory equivalence: pipelining changes when the
host waits, never what is trained. So within the port every comparison
is bitwise (``torch.equal``): a prefetched fit, the window at any lag
(with a guard skipping a NaN batch), the trainer's megastep on one and
two gloo ranks (ZeRO too), and its prefetched chunk feed. Against the
JAX package's trainer megastep the same math runs in another framework:
``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5). Multi-rank runs are
subprocesses of torch, numpy and the port over a gloo file rendezvous
under ``tmp_path``, each with a timeout of its own.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.api import ListDataSetIterator as JList
from deeplearning4j_tpu.datasets.prefetch import (
    PrefetchIterator as JPrefetch,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.observability.metrics import (
    MetricsRegistry as JRegistry,
)
from deeplearning4j_tpu.parallel import AsyncDispatchWindow as JWindow
from deeplearning4j_tpu.parallel import DistributedTrainer as JTrainer
from deeplearning4j_tpu.parallel import build_mesh as jbuild_mesh
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.prefetch import PrefetchIterator
from deeplearning4j_tpu_torch.exceptions import DL4JFaultException
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import DistributedTrainer
from deeplearning4j_tpu_torch.parallel.dispatch import AsyncDispatchWindow
from deeplearning4j_tpu_torch.resilience.guard import DivergenceGuard
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    params_to_numpy,
)

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 180


@pytest.fixture
def rng():
    return np.random.RandomState(12345)


def mlp_conf(seed=7, updater="ADAM", lr=0.05):
    return (NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
            .updater(updater).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .build())


def make_net(init=None, **kw):
    return MultiLayerNetwork(mlp_conf(**kw), device="cpu").init(params=init)


def make_graph(init=None):
    conf = (NeuralNetConfiguration.Builder().seed(2).learning_rate(0.1)
            .graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_in=4, n_out=8, activation="tanh"),
                       "in")
            .add_layer("out", OutputLayer(n_in=8, n_out=3), "d")
            .set_outputs("out").build())
    return ComputationGraph(conf, device="cpu").init(params=init)


def batches(rng, n_batches=8, batch=8):
    return [DataSet(rng.randn(batch, 4).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)])
            for _ in range(n_batches)]


def nan_batch(batch=8):
    return DataSet(np.full((batch, 4), np.nan, np.float32),
                   np.eye(3, dtype=np.float32)[np.zeros(batch, int)])


def clone(tree):
    return {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in tree.items()}


def assert_bitwise(a, b):
    """Parameters, updater state, layer state and the step count of two
    models, bit for bit."""
    assert a.iteration_count == b.iteration_count
    for tree in ("params", "state"):
        ta, tb = getattr(a, tree), getattr(b, tree)
        for ln, lp in ta.items():
            for k, t in lp.items():
                assert torch.equal(t, tb[ln][k]), f"{tree} {ln}/{k}"
    for ln, lp in a.updater_state.items():
        for pn, tup in lp.items():
            for i, (u, v) in enumerate(zip(tup, b.updater_state[ln][pn])):
                assert torch.equal(u, v), f"updater {ln}/{pn}/{i}"


class SlowIterator(ListDataSetIterator):
    """A source with a host cost a batch."""

    def __init__(self, data, delay_s=0.002):
        super().__init__(data)
        self.delay_s = delay_s

    def next(self):
        time.sleep(self.delay_s)
        return super().next()


class FlakyIterator(ListDataSetIterator):
    """A source whose ``next`` raises at the given call."""

    def __init__(self, data, fail_at):
        super().__init__(data)
        self.fail_at = fail_at
        self.calls = 0

    def next(self):
        self.calls += 1
        if self.calls == self.fail_at:
            raise OSError("flaky source")
        return super().next()


# -- PrefetchIterator --------------------------------------------------------


def test_prefetch_preserves_order_and_count(rng):
    data = batches(rng, n_batches=7)
    it = PrefetchIterator(SlowIterator(data), queue_depth=2,
                          registry=MetricsRegistry())
    got = list(it)
    it.shutdown()
    assert len(got) == 7
    assert all(g is d for g, d in zip(got, data))


def test_prefetch_reset_restarts_from_top(rng):
    data = batches(rng, n_batches=5)
    it = PrefetchIterator(ListDataSetIterator(data), queue_depth=2,
                          registry=MetricsRegistry())
    first = [next(it) for _ in range(2)]
    it.reset()
    again = list(it)
    it.shutdown()
    assert first == data[:2] and again == data


def test_prefetch_shutdown_joins_worker_and_is_idempotent(rng):
    it = PrefetchIterator(SlowIterator(batches(rng, n_batches=50)),
                          queue_depth=1, registry=MetricsRegistry())
    next(it)  # the worker is now blocked on a full queue
    worker = it._thread
    it.shutdown(timeout=5.0)
    assert not worker.is_alive() and it._thread is None
    it.shutdown()
    with PrefetchIterator(ListDataSetIterator(batches(rng, 2)),
                          registry=MetricsRegistry()) as ctx:
        assert len(list(ctx)) == 2
    assert ctx._thread is None


def test_prefetch_worker_fault_surfaces_after_the_batches_before_it(rng):
    """A fault on the worker reaches the consumer as ``DL4JFaultException``
    (the original chained) once the batches fetched before it are
    delivered; a fault parked at shutdown re-raises with
    ``raise_pending`` (the preemption path) and is dropped without."""
    data = batches(rng, n_batches=5)
    it = PrefetchIterator(FlakyIterator(data, fail_at=3), queue_depth=2,
                          registry=MetricsRegistry())
    seen = []
    with pytest.raises(DL4JFaultException) as ei:
        for ds in it:
            seen.append(ds)
    assert seen == data[:2] and isinstance(ei.value.__cause__, OSError)
    it.shutdown()
    for raise_pending in (True, False):
        it = PrefetchIterator(FlakyIterator(data, fail_at=1), queue_depth=2,
                              registry=MetricsRegistry())
        it.has_next()  # the worker has parked the fault
        if raise_pending:
            with pytest.raises(DL4JFaultException, match="pending"):
                it.shutdown(raise_pending=True)
        else:
            it.shutdown()


def test_prefetch_and_window_metric_names_are_jax(rng):
    """The pipeline's and the window's metrics under the JAX package's
    names, kinds and help strings (``/metrics`` reads them alike)."""
    def families(reg):
        return {n: (f.kind, f.help, tuple(f.buckets or ()))
                for n, f in reg._families.items()}

    regs = []
    for registry, prefetch, window, ds in (
            (JRegistry(), JPrefetch, JWindow, JDataSet),
            (MetricsRegistry(), PrefetchIterator, AsyncDispatchWindow,
             DataSet)):
        data = [ds(np.zeros((2, 4), np.float32), np.zeros((2, 3),
                                                            np.float32))]
        it = prefetch(JList(data) if ds is JDataSet
                      else ListDataSetIterator(data), registry=registry)
        list(it)
        it.shutdown()
        window(max_in_flight=2, registry=registry)
        regs.append(families(registry))
    assert regs[0] == regs[1]
    assert {"training_prefetch_queue_depth", "training_prefetch_wait_ms",
            "training_step_gap_ms"} <= set(regs[1])


def test_prefetch_metrics_count_each_take(rng):
    reg = MetricsRegistry()
    it = PrefetchIterator(ListDataSetIterator(batches(rng, n_batches=6)),
                          queue_depth=2, registry=reg)
    list(it)
    it.shutdown()
    assert reg.get("training_prefetch_wait_ms")._default().count >= 6
    assert reg.get("training_prefetch_queue_depth") is not None


# -- pipelined fit, bitwise the plain loop -----------------------------------


@pytest.mark.parametrize("engine", ["multilayer", "graph", "trainer"])
def test_pipelined_fit_is_the_plain_loop_bitwise(rng, engine):
    data = batches(rng, n_batches=8)
    make = make_graph if engine == "graph" else make_net
    ref = make()
    init = clone(ref.params)
    for ds in data:
        ref.fit_minibatch(ds)
    pipe = make(init)
    if engine == "trainer":
        DistributedTrainer(pipe).fit(ListDataSetIterator(data), prefetch=2)
    else:
        it = PrefetchIterator(SlowIterator(data), queue_depth=3,
                              registry=MetricsRegistry())
        pipe.fit(it)
        it.shutdown()
    assert_bitwise(ref, pipe)


@pytest.mark.parametrize("lag", [0, 1, 2, None])
def test_skip_guard_at_any_lag_is_the_synchronous_loop(rng, lag):
    """A NaN batch mid-run under the SKIP guard: the window reading the
    flags ``lag`` steps late trains the same bits and records the same
    skipped iteration as the unpipelined loop."""
    data = batches(rng, n_batches=6)
    data.insert(3, nan_batch())
    ref = make_net()
    init = clone(ref.params)
    ref.set_divergence_guard(DivergenceGuard("skip"))
    for ds in data:
        ref.fit_minibatch(ds)
    net = make_net(init)
    net.guard_lag = lag
    net.set_divergence_guard(DivergenceGuard("skip"))
    net.fit(ListDataSetIterator(data))
    assert_bitwise(ref, net)
    assert (net.divergence_guard.skipped_batches
            == ref.divergence_guard.skipped_batches == [3])


def test_rollback_policy_forces_a_synchronous_consult(rng, tmp_path):
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )

    data = batches(rng, n_batches=4)
    net = make_net()
    mgr = CheckpointManager(tmp_path)
    for ds in data[:2]:
        net.fit_minibatch(ds)
    mgr.save(net)
    guard = DivergenceGuard("rollback", checkpoint_manager=mgr)
    window = AsyncDispatchWindow(model=net, guard_fn=lambda: guard,
                                 max_in_flight=4, guard_lag=4,
                                 registry=MetricsRegistry())
    assert window._effective_lag(guard) == 0
    net.set_divergence_guard(guard)
    net.guard_lag = 4
    net.fit([nan_batch()])
    assert guard.rollbacks == 1 and net.iteration_count == 2


class FakeEvent:
    """A completion handle that records its wait."""

    def __init__(self, log, i):
        self.log, self.i = log, i

    def synchronize(self):
        self.log.append(self.i)


def test_window_bounds_the_steps_in_flight():
    reg = MetricsRegistry()
    window = AsyncDispatchWindow(max_in_flight=2, registry=reg)
    waited = []
    for i in range(6):
        window.push(FakeEvent(waited, i))
        assert len(window._inflight) <= 2
    assert waited == [0, 1, 2, 3]  # the oldest first, 2 steps late
    window.drain()
    assert waited == list(range(6)) and window.pending == 0
    assert reg.get("training_step_gap_ms")._default().count == 5
    window.push(FakeEvent(waited, 6))
    window.abandon()
    assert window.pending == 0 and waited[-1] == 5
    with pytest.raises(ValueError):
        AsyncDispatchWindow(max_in_flight=0, registry=reg)
    with pytest.raises(ValueError):
        AsyncDispatchWindow(guard_lag=-1, registry=reg)


def test_per_step_loop_reads_nothing_back(rng, monkeypatch):
    """Without a guard the engines' loop reads no value back from a step
    between epoch boundaries (on the card it waits on events only; the
    CUDA test holds that)."""
    data = batches(rng, n_batches=5)
    net = make_net()
    net.fit(data[:1])

    def refuse(*a, **k):
        raise AssertionError("a host readback in the per-step loop")

    for name in ("item", "__float__", "cpu", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    net.fit(ListDataSetIterator(data))
    monkeypatch.undo()
    assert net.iteration_count == 6


def test_trainer_fit_returns_epoch_means_and_resets_on_exception(rng):
    data = batches(rng, n_batches=4, batch=16)
    tr = DistributedTrainer(make_net())
    scores = tr.fit(ListDataSetIterator(data), epochs=3)
    assert len(scores) == 3 and all(np.isfinite(scores))
    assert scores[2] < scores[0]

    class Exploding(ListDataSetIterator):
        resets = 0

        def next(self):
            if self._pos == 2:
                raise RuntimeError("boom mid-epoch")
            return super().next()

        def reset(self):
            Exploding.resets += 1
            super().reset()

    it = Exploding(data)
    with pytest.raises(RuntimeError, match="boom"):
        tr.fit(it)
    assert it._pos == 0 and Exploding.resets >= 1
    # through the prefetch worker the source's fault is the pipeline's
    with pytest.raises(DL4JFaultException, match="boom"):
        tr.fit(it, prefetch=2)
    assert it._pos == 0 and Exploding.resets >= 1


# -- megastep ------------------------------------------------------------------


class ChunkAware:
    def __init__(self):
        self.chunks = []
        self.iterations = []

    def chunk_done(self, model, it0, k, host):
        self.chunks.append((it0, k, list(host["scores"])))

    def iteration_done(self, model, iteration):
        self.iterations.append(iteration)


class PerStep:
    def __init__(self):
        self.seen = []

    def iteration_done(self, model, iteration):
        self.seen.append((iteration, model.score_value))


@pytest.mark.parametrize("engine", ["multilayer", "trainer"])
def test_listener_cadence_under_megastep(rng, monkeypatch, engine):
    """Six batches at K = 3: two chunks, two readbacks; a chunk-aware
    listener gets one ``chunk_done`` a chunk and no per-step call; a
    per-step listener gets ``iteration_done`` for each step, after the
    chunk's readback, with that step's score."""
    calls = []
    real = core.megastep_readback

    def counting(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(core, "megastep_readback", counting)
    data = batches(rng, n_batches=6)
    ref = make_net()
    init = clone(ref.params)
    ref_scores = [float(ref.fit_minibatch(ds)) for ds in data]
    net = make_net(init)
    aware, per_step = ChunkAware(), PerStep()
    net.set_listeners(aware, per_step)
    if engine == "trainer":
        DistributedTrainer(net).fit(ListDataSetIterator(data), megastep=3)
    else:
        net.fit(ListDataSetIterator(data), megastep=3)
    assert len(calls) == 2
    assert [(it0, k) for it0, k, _ in aware.chunks] == [(0, 3), (3, 3)]
    assert aware.iterations == []
    assert [i for i, _ in per_step.seen] == [1, 2, 3, 4, 5, 6]
    assert [s for _, s in per_step.seen] == ref_scores
    assert_bitwise(ref, net)


def test_megastep_trainer_prefetch_feed_bitwise(rng):
    """``trainer.fit(prefetch=2, megastep=4)``: the prefetch worker runs
    ``place_chunk`` and the trainer launches the placed blocks: bitwise
    the per-step trainer loop (the JAX package's test of this name fails
    on its own fused scan; the port's chunk runs the trainer's step)."""
    data = batches(rng, n_batches=8, batch=16)
    ref = make_net()
    init = clone(ref.params)
    tr_ref = DistributedTrainer(ref)
    for ds in data:
        tr_ref.fit_minibatch(ds)
    mega = make_net(init)
    DistributedTrainer(mega).fit(ListDataSetIterator(data), prefetch=2,
                                 megastep=4)
    assert_bitwise(ref, mega)


def test_trainer_megastep_refused_under_a_rollback_guard(rng, tmp_path):
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )

    net = make_net()
    tr = DistributedTrainer(net, divergence_guard=DivergenceGuard(
        "rollback", checkpoint_manager=CheckpointManager(tmp_path)))
    tr.fit(batches(rng, 4), megastep=4)
    assert not tr._can_megastep() and net.iteration_count == 4
    assert net._megastep_graphs == {}


def test_trainer_megastep_is_close_to_the_jax_trainer(rng):
    """The port's trainer megastep (K = 4, 8 batches, Adam) against the
    JAX package's ``DistributedTrainer`` at megastep 4 on one device,
    from the same weights: scores and weights at ``kernel_tols()``."""
    data = batches(rng, n_batches=8, batch=16)
    conf = mlp_conf()
    jnet = JNet(JConf.from_dict(conf.to_dict())).init()
    flat = {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in jnet.params.items() for pn, a in lp.items()}
    net = MultiLayerNetwork(conf, device="cpu").init(
        params=params_from_numpy(flat, "cpu"))
    jtr = JTrainer(jnet, mesh=jbuild_mesh(data=1, devices=jax.devices()[:1]))
    jscores = jtr.fit(JList([JDataSet(d.features, d.labels) for d in data]),
                      megastep=4)
    scores = DistributedTrainer(net).fit(ListDataSetIterator(data),
                                         megastep=4)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(scores, jscores, rtol=rtol, atol=atol)
    got = params_to_numpy(net.params)
    for k, v in flat.items():
        ln, pn = k.rsplit("/", 1)
        np.testing.assert_allclose(got[k], np.asarray(jnet.params[ln][pn]),
                                   rtol=rtol, atol=atol, err_msg=k)
    assert net.iteration_count == jnet.iteration_count == 8


# -- the trainer's megastep on gloo ranks --------------------------------------

_RANK = r"""
import json, sys
import jax
import numpy as np
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    DistributedTrainer, build_mesh, init_distributed, shutdown_distributed)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy, params_to_numpy, updater_state_to_numpy)

spec = json.loads(sys.argv[1])
init_distributed("file://" + spec["rdv"], spec["world"], spec["rank"],
                 device="cpu", timeout_s=120)
conf = MultiLayerConfiguration.from_dict(json.loads(open(spec["conf"]).read()))
init = params_from_numpy(dict(np.load(spec["init"])), "cpu")
data = np.load(spec["data"])
batches = [DataSet(data[f"x{i}"], data[f"y{i}"])
           for i in range(len(data.files) // 2)]
out = {}
for run in ("per_step", "mega"):
    model = MultiLayerNetwork(conf, device="cpu").init(params=init)
    tr = DistributedTrainer(model, mesh=build_mesh(data=spec["world"]),
                            zero=spec["zero"])
    if run == "per_step":
        for ds in batches:
            tr.fit_minibatch(ds)
    else:
        tr.fit(ListDataSetIterator(batches), megastep=spec["k"],
               prefetch=spec["prefetch"])
    out[run + ":it"] = np.asarray(model.iteration_count)
    for k, v in params_to_numpy(model.params).items():
        out[run + ":p:" + k] = v
    for k, v in updater_state_to_numpy(tr.gather_updater_state()).items():
        out[run + ":u:" + k] = v
np.savez(spec["out"], **out)
shutdown_distributed()
"""


def run_ranks(tmp_path, world, data, init, **opts):
    np.savez(tmp_path / "data.npz", **{
        f"{c}{i}": getattr(d, f) for i, d in enumerate(data)
        for c, f in (("x", "features"), ("y", "labels"))})
    np.savez(tmp_path / "init.npz", **params_to_numpy(init))
    (tmp_path / "conf.json").write_text(json.dumps(mlp_conf().to_dict()))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        spec = dict(rank=r, world=world, rdv=str(tmp_path / "rdv"),
                    conf=str(tmp_path / "conf.json"),
                    init=str(tmp_path / "init.npz"),
                    data=str(tmp_path / "data.npz"),
                    out=str(tmp_path / f"out{r}.npz"), **opts)
        logs.append(tmp_path / f"err{r}.txt")
        with open(logs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK, json.dumps(spec)],
                cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL,
                stderr=err))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail("ranks hung:\n" + "\n".join(
            log.read_text()[-2000:] for log in logs))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world,zero,prefetch", [
    (1, False, None), (2, False, None), (2, True, 2)])
def test_trainer_megastep_on_gloo_ranks_is_the_per_step_loop(
        rng, tmp_path, world, zero, prefetch):
    """K = 3 over 7 batches of 8 (two chunks and a per-step tail) on 1 and
    2 gloo ranks, with ZeRO-1 and the prefetched chunk feed: every rank's
    parameters and (gathered) updater state bitwise its per-step run."""
    data = batches(rng, n_batches=7, batch=8)
    results = run_ranks(tmp_path, world, data, make_net().params, k=3,
                        zero=zero, prefetch=prefetch)
    for res in results:
        assert int(res["per_step:it"]) == int(res["mega:it"]) == 7
        keys = [k[len("mega:"):] for k in res if k.startswith("mega:")
                and k != "mega:it"]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(res["mega:" + k],
                                          res["per_step:" + k], err_msg=k)
    for res in results[1:]:
        for k, v in results[0].items():
            np.testing.assert_array_equal(res[k], v, err_msg=k)


def test_prefetch_placement_runs_on_the_worker(rng):
    """``place_minibatch`` as the prefetch placement: the consumer gets
    ``PlacedDataSet`` batches placed on the worker thread, and the
    trainer takes them as they are."""
    from deeplearning4j_tpu_torch.datasets.api import PlacedDataSet

    data = batches(rng, n_batches=4)
    tr = DistributedTrainer(make_net())
    threads = set()
    real = tr.place_minibatch

    def placing(ds):
        threads.add(threading.current_thread().name)
        return real(ds)

    it = PrefetchIterator(ListDataSetIterator(data), placement=placing,
                          registry=MetricsRegistry())
    got = list(it)
    it.shutdown()
    assert all(isinstance(p, PlacedDataSet) for p in got)
    assert threading.current_thread().name not in threads
    assert all(p.num_examples() == 8 and p.weights == [([1.0], 1.0)]
               for p in got)
    ref = make_net()
    pipe = make_net(clone(ref.params))
    for ds in data:
        DistributedTrainer(ref).fit_minibatch(ds)
    tr2 = DistributedTrainer(pipe)
    for p in got:
        tr2.fit_minibatch(p)
    assert_bitwise(ref, pipe)
