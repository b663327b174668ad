"""Preemption in the port (``resilience/preemption.py``) on the CPU,
against the JAX package's handler.

- The handler: install replaces the SIGTERM / SIGINT dispositions and
  uninstall restores them, callbacks run on the notice (and at once when
  registered after it), the exit codes of ``exit_on_preemption`` (75
  with a checkpoint, 76 without): the same observations as JAX's
  handler.
- A notice mid-epoch on both engines' fit, on the trainer with prefetch
  (its worker joined, the window drained) and at a megastep chunk
  boundary: an emergency checkpoint of the step reached, and a resume
  from it bitwise the uninterrupted run.
- The real signal: SIGTERM against a training subprocess mid-epoch exits
  75 with an emergency checkpoint, and a fresh process resumes from it
  to the uninterrupted run's bits.

Within the port every comparison is bitwise (``torch.equal`` /
``assert_array_equal``): a resumed run repeats the same operations on
the same values.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.resilience.preemption import (
    PreemptionHandler as JHandler,
)
from deeplearning4j_tpu.resilience.preemption import (
    exit_on_preemption as jexit_on_preemption,
)
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import DistributedTrainer
from deeplearning4j_tpu_torch.resilience import (
    EXIT_PREEMPTED,
    EXIT_PREEMPTED_DIRTY,
    CheckpointManager,
    PreemptedException,
    PreemptionHandler,
    active_handler,
    exit_on_preemption,
    preemption_requested,
)

ROOT = Path(__file__).resolve().parent.parent


def mlp_conf():
    return (NeuralNetConfiguration.Builder().seed(7).learning_rate(0.05)
            .updater("ADAM").list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3)).build())


def graph_conf():
    return (NeuralNetConfiguration.Builder().seed(2).learning_rate(0.1)
            .graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_in=4, n_out=8, activation="tanh"),
                       "in")
            .add_layer("out", OutputLayer(n_in=8, n_out=3), "d")
            .set_outputs("out").build())


def mlp():
    return MultiLayerNetwork(mlp_conf(), device="cpu").init()


def graph():
    return ComputationGraph(graph_conf(), device="cpu").init()


def batches(n=10, seed=3):
    rng = np.random.RandomState(seed)
    return [DataSet(rng.randn(8, 4).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)])
            for _ in range(n)]


class NotifyAt:
    """A listener delivering the simulated notice after step ``at``."""

    def __init__(self, at):
        self.at = at

    def iteration_done(self, model, iteration):
        if iteration == self.at:
            active_handler().notify("simulated")


def assert_bitwise(a, b):
    assert a.iteration_count == b.iteration_count
    for ln, lp in a.params.items():
        for pn, t in lp.items():
            assert torch.equal(t, b.params[ln][pn]), (ln, pn)
    for ln, lp in a.updater_state.items():
        for pn, tup in lp.items():
            for u, v in zip(tup, b.updater_state[ln][pn]):
                assert torch.equal(u, v), (ln, pn)


# -- the handler, as JAX's -----------------------------------------------------


@pytest.mark.parametrize("cls", [PreemptionHandler, JHandler])
def test_handler_install_uninstall_restores_dispositions(cls):
    prev_term = signal.getsignal(signal.SIGTERM)
    prev_int = signal.getsignal(signal.SIGINT)
    h = cls()
    with h:
        assert signal.getsignal(signal.SIGTERM) != prev_term
        assert signal.getsignal(signal.SIGINT) != prev_int
        h.notify("simulated")
        assert h.requested and h.reason == "simulated"
    assert signal.getsignal(signal.SIGTERM) == prev_term
    assert signal.getsignal(signal.SIGINT) == prev_int
    port = PreemptionHandler()
    assert not preemption_requested() and active_handler() is None
    with port:
        assert active_handler() is port
    assert active_handler() is None


@pytest.mark.parametrize("cls", [PreemptionHandler, JHandler])
def test_callbacks_run_on_notice_and_late_registration(cls):
    h = cls()
    seen = []
    h.on_preemption(lambda reason: seen.append(("early", reason)))
    h.notify("chaos")
    deadline = time.monotonic() + 5
    while not seen and time.monotonic() < deadline:
        time.sleep(0.01)
    assert seen == [("early", "chaos")]
    h.on_preemption(lambda reason: seen.append(("late", reason)))
    assert seen[-1] == ("late", "chaos")
    h.notify("again")  # idempotent: no callback runs again
    time.sleep(0.05)
    assert len(seen) == 2 and h.reason == "chaos"
    h.clear()
    assert not h.requested


def test_exit_codes_are_jax(tmp_path):
    """75 when the emergency checkpoint landed, 76 without a manager:
    the same codes from both packages' handlers and managers."""
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.resilience.checkpoint import (
        CheckpointManager as JManager,
    )

    codes = {}
    for pkg, handler, exit_ctx, manager, model in (
            ("port", PreemptionHandler, exit_on_preemption,
             CheckpointManager, mlp()),
            ("jax", JHandler, jexit_on_preemption, JManager,
             JNet(JConf.from_dict(mlp_conf().to_dict())).init())):
        for with_mgr in (True, False):
            h = handler(manager=manager(str(tmp_path / pkg))
                        if with_mgr else None)
            h.notify("chaos")
            with pytest.raises(SystemExit) as e:
                with exit_ctx():
                    h.emergency_stop(model)
            codes[pkg, with_mgr] = e.value.code
    assert codes == {("port", True): EXIT_PREEMPTED,
                     ("port", False): EXIT_PREEMPTED_DIRTY,
                     ("jax", True): 75, ("jax", False): 76}


# -- a notice mid-epoch: emergency checkpoint, bitwise resume -------------------


@pytest.mark.parametrize("engine", ["multilayer", "graph"])
def test_notice_mid_epoch_on_the_engines(tmp_path, engine):
    make = mlp if engine == "multilayer" else graph
    bs = batches()
    mgr = CheckpointManager(tmp_path, device="cpu")
    m = make()
    m.set_listeners(NotifyAt(4))
    with PreemptionHandler(manager=mgr):
        with pytest.raises(PreemptedException) as exc:
            m.fit(ListDataSetIterator(bs))
    assert exc.value.step == 4 and exc.value.checkpoint.step == 4
    assert exc.value.exit_code == EXIT_PREEMPTED
    survivor = make()
    assert survivor.resume(mgr) == 4
    survivor.fit(ListDataSetIterator(bs[4:]))
    full = make()
    full.fit(ListDataSetIterator(bs))
    assert_bitwise(survivor, full)


@pytest.mark.parametrize("megastep", [None, 2])
def test_notice_on_the_trainer_with_prefetch(tmp_path, megastep):
    """The trainer with prefetch (and with its megastep: the notice at a
    chunk's end): the window drains, the worker joins, the emergency
    checkpoint lands at the boundary, the resume is bitwise."""
    bs = batches()
    mgr = CheckpointManager(tmp_path, device="cpu")
    m = mlp()
    m.set_listeners(NotifyAt(4))
    tr = DistributedTrainer(m)
    with PreemptionHandler(manager=mgr):
        with pytest.raises(PreemptedException) as exc:
            tr.fit(ListDataSetIterator(bs), epochs=2, prefetch=2,
                   megastep=megastep)
    assert exc.value.checkpoint.step == 4 == mgr.latest_step()
    survivor = mlp()
    tr2 = DistributedTrainer(survivor)
    assert tr2.resume(mgr) == 4
    tr2.fit(ListDataSetIterator(bs[4:]), prefetch=2, megastep=megastep)
    tr2.fit(ListDataSetIterator(bs), prefetch=2, megastep=megastep)
    full = mlp()
    DistributedTrainer(full).fit(ListDataSetIterator(bs), epochs=2)
    assert_bitwise(survivor, full)
    assert survivor.iteration_count == 20


def test_notice_at_an_engine_megastep_chunk_boundary(tmp_path):
    """Megastep 3 on the engine: the notice after step 3 (a chunk's
    end) saves step 3; the buffered minibatch of the next chunk has not
    run."""
    bs = batches(9)
    mgr = CheckpointManager(tmp_path, device="cpu")
    m = mlp()
    m.set_listeners(NotifyAt(3))
    with PreemptionHandler(manager=mgr):
        with pytest.raises(PreemptedException) as exc:
            m.fit(ListDataSetIterator(bs), megastep=3)
    assert exc.value.step == 3 and m.iteration_count == 3
    survivor = mlp()
    survivor.resume(mgr)
    survivor.fit(ListDataSetIterator(bs[3:]), megastep=3)
    full = mlp()
    full.fit(ListDataSetIterator(bs), megastep=3)
    assert_bitwise(survivor, full)


# -- the real signal ----------------------------------------------------------

_CHILD = r"""
import sys, time
import numpy as np
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import DistributedTrainer
from deeplearning4j_tpu_torch.resilience import (
    CheckpointManager, PreemptionHandler, exit_on_preemption)
from deeplearning4j_tpu_torch.util.model_serializer import params_to_numpy

mode, ckpt_dir, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
N = 30
conf = (NeuralNetConfiguration.Builder().seed(7).learning_rate(0.05)
        .updater("ADAM").list()
        .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
        .layer(OutputLayer(n_out=3)).build())
m = MultiLayerNetwork(conf, device="cpu").init()
rng = np.random.RandomState(1337)
bs = [DataSet(rng.randn(8, 4).astype(np.float32),
              np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)])
      for _ in range(N)]

class Paced:
    # a slow source: the SIGTERM lands with the worker and window live
    def __init__(self, items):
        self.items = items
    def __iter__(self):
        for ds in self.items:
            time.sleep(0.05)
            yield ds
    def reset(self):
        pass

tr = DistributedTrainer(m)
mgr = CheckpointManager(ckpt_dir, device="cpu")
if mode == "train":
    class Progress:
        def iteration_done(self, model, it):
            print(f"step {it}", flush=True)
    m.set_listeners(Progress())
    PreemptionHandler(manager=mgr).install()
    with exit_on_preemption():
        tr.fit(Paced(bs), prefetch=2)
elif mode == "resume":
    step = tr.resume(mgr)
    tr.fit(ListDataSetIterator(bs[step:]))
else:
    tr.fit(ListDataSetIterator(bs))
np.savez(out_path, step=m.iteration_count, **params_to_numpy(m.params))
"""


def _run(mode, ckpt, out, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", _CHILD, mode, ckpt, out],
                          env=env, cwd=str(ROOT), capture_output=True,
                          text=True, timeout=timeout)


def test_sigterm_mid_epoch_exits_75_and_resumes_bitwise(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    ckpt = str(tmp_path / "ckpt")
    p = subprocess.Popen([sys.executable, "-c", _CHILD, "train", ckpt,
                          str(tmp_path / "train.npz")], env=env,
                         cwd=str(ROOT), stdout=subprocess.PIPE, text=True)
    try:
        seen = 0
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            line = p.stdout.readline()
            if line.startswith("step "):
                seen = int(line.split()[1])
                if seen >= 3:
                    break
        assert seen >= 3, "the trainer never reached step 3"
        os.kill(p.pid, signal.SIGTERM)
        rc = p.wait(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    assert rc == EXIT_PREEMPTED
    step = CheckpointManager(ckpt).latest_step()
    assert step is not None and 3 <= step < 30
    r = _run("resume", ckpt, str(tmp_path / "resume.npz"))
    assert r.returncode == 0, r.stderr[-2000:]
    f = _run("full", str(tmp_path / "unused"), str(tmp_path / "full.npz"))
    assert f.returncode == 0, f.stderr[-2000:]
    resumed = np.load(tmp_path / "resume.npz")
    full = np.load(tmp_path / "full.npz")
    assert int(resumed["step"]) == int(full["step"]) == 30
    for key in full.files:
        np.testing.assert_array_equal(resumed[key], full[key], err_msg=key)
