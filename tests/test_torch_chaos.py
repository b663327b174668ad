"""The port's fault injection (``resilience/chaos.py``) on the CPU,
against the JAX package's.

- ``ChaosPolicy``: explicit and seeded-random schedules, ``max_failures``
  and the exception factory give the JAX policy's injections call by
  call for the same seed.
- ``PoisonIterator``: the same offsets and kinds as JAX's for the same
  seed and the same corrupted batches, replayed after ``reset``.
- ``FaultyObjectStore`` under ``RetryingObjectStore`` and
  ``FlakyIterator`` under a retry: the faults are survived and the
  data order is kept.
- ``ControlChannelChaos``: the same request log and the same faults as
  JAX's over the same storm of requests.
- ``KillAtStep``: a fit in a subprocess dies by SIGKILL at the step.

Tolerances: none; schedules and corrupted arrays are compared exactly.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.api import ListDataSetIterator as JList
from deeplearning4j_tpu.resilience.chaos import ChaosError as JChaosError
from deeplearning4j_tpu.resilience.chaos import ChaosPolicy as JPolicy
from deeplearning4j_tpu.resilience.chaos import (
    ControlChannelChaos as JChannelChaos,
)
from deeplearning4j_tpu.resilience.chaos import PoisonIterator as JPoison
from deeplearning4j_tpu_torch.cloud.storage import LocalObjectStore
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.exceptions import RetryExhaustedException
from deeplearning4j_tpu_torch.resilience import (
    RetryingObjectStore,
    RetryPolicy,
    retry_call,
)
from deeplearning4j_tpu_torch.resilience.chaos import (
    POISON_KINDS,
    ChaosError,
    ChaosPolicy,
    ControlChannelChaos,
    FaultyObjectStore,
    FlakyIterator,
    KillAtStep,
    PoisonIterator,
)

ROOT = Path(__file__).resolve().parent.parent
CHAOS_SEED = 1337


def _drive(policy, ops, n):
    """``n`` calls of each op in turn; the (op, index) of each fault
    and its message."""
    out = []
    for i in range(n):
        for op in ops:
            try:
                policy.check(op)
            except Exception as e:  # noqa: PERF203 — the point
                out.append((op, i, type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("kw", [
    dict(seed=CHAOS_SEED, failure_rate=0.2),
    dict(seed=7, failure_rate=0.5, max_failures=5),
    dict(fail_calls={"read": {0, 1}, "write": {3}}),
    dict(seed=3, failure_rate=0.3, fail_calls={"keys": {0, 2}}),
], ids=["rate", "bounded", "explicit", "both"])
def test_chaos_policy_schedule_matches_jax(kw):
    ops = ("read", "write", "keys")
    a, b = ChaosPolicy(**kw), JPolicy(**kw)
    got, want = _drive(a, ops, 30), _drive(b, ops, 30)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert [g[3] for g in got] == [w[3] for w in want]
    assert all(g[2] == "ChaosError" for g in got)
    assert a.injected == b.injected and a.calls == b.calls
    assert issubclass(ChaosError, OSError)


def test_chaos_policy_fail_first_and_factory():
    p = ChaosPolicy.fail_first(2, ops=("open", "read"))
    j = JPolicy.fail_first(2, ops=("open", "read"))
    assert _drive(p, ("open", "read"), 4)[:4] == _drive(j, ("open", "read"),
                                                        4)[:4]
    made = ChaosPolicy(fail_calls={"x": {1}},
                       exception=lambda op, i: KeyError(f"{op}#{i}"))
    made.check("x")
    with pytest.raises(KeyError, match="x#1"):
        made.check("x")
    with pytest.raises(ValueError):
        ChaosPolicy(failure_rate=1.5)


def test_faulty_store_under_retry(tmp_path):
    inner = LocalObjectStore(tmp_path)
    inner.write("a/b", b"payload")
    faulty = FaultyObjectStore(inner, ChaosPolicy.fail_first(
        2, ops=("read", "keys", "write")))
    store = RetryingObjectStore(faulty, policy=RetryPolicy(
        max_attempts=3, base_delay=0.0, sleep=lambda s: None))
    assert store.read("a/b") == b"payload"
    assert store.keys("a") == ["a/b"]
    store.write("c", b"x")
    assert inner.read("c") == b"x"
    assert faulty.policy.injected == [("read", 0), ("read", 1),
                                      ("keys", 0), ("keys", 1),
                                      ("write", 0), ("write", 1)]
    # a budget smaller than the storm is exhausted, chained
    tight = RetryingObjectStore(
        FaultyObjectStore(inner, ChaosPolicy.fail_first(3, ops=("read",))),
        policy=RetryPolicy(max_attempts=2, base_delay=0.0,
                           sleep=lambda s: None))
    with pytest.raises(RetryExhaustedException) as ei:
        tight.read("a/b")
    assert isinstance(ei.value.__cause__, ChaosError)


def _pairs(rng, n=12, batch=4):
    return [(rng.randn(batch, 5).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)])
            for _ in range(n)]


@pytest.mark.parametrize("kw", [
    dict(seed=CHAOS_SEED, poison_rate=0.4),
    dict(poison={1: "wrong_shape", 3: "wrong_dtype", 5: "label_range",
                 8: "huge_values"}),
    dict(seed=9, poison_rate=0.25, poison={0: "label_range"}),
], ids=["rate", "explicit", "both"])
def test_poison_iterator_storm_matches_jax(kw):
    pairs = _pairs(np.random.RandomState(0))
    it = PoisonIterator(ListDataSetIterator([DataSet(x, y)
                                             for x, y in pairs]), **kw)
    jit = JPoison(JList([JDataSet(x, y) for x, y in pairs]), **kw)
    for _ in range(2):  # the same storm after reset
        got, want = list(it), list(jit)
        assert it.poisoned == jit.poisoned
        assert len(got) == len(want) == len(pairs)
        for g, w in zip(got, want):
            for a, b in ((g.features, w.features), (g.labels, w.labels)):
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    assert it.poisoned == jit.poisoned and it.poisoned
    assert {k for _, k in it.poisoned} <= set(POISON_KINDS)
    # the source batches were copied, never corrupted in place
    for (x, y), ds in zip(pairs, _pairs(np.random.RandomState(0))):
        np.testing.assert_array_equal(x, ds[0])
    with pytest.raises(ValueError):
        PoisonIterator(ListDataSetIterator([]), poison={0: "nope"})


def test_flaky_iterator_keeps_the_order_under_retry():
    pairs = _pairs(np.random.RandomState(1), n=5)
    it = FlakyIterator(ListDataSetIterator([DataSet(x, y) for x, y in pairs]),
                       ChaosPolicy(fail_calls={"next": {0, 2, 3}}))
    pol = RetryPolicy(max_attempts=3, base_delay=0.0, sleep=lambda s: None)
    it.reset()
    got = []
    while it.has_next():
        got.append(retry_call(it.next, policy=pol))
    assert [np.asarray(d.features).tobytes() for d in got] == [
        x.tobytes() for x, _ in pairs]
    assert it.policy.injected == [("next", 0), ("next", 2), ("next", 3)]
    assert it.batch() == 4 and it.total_examples() == 20


class _Echo:
    def __init__(self):
        self.seen = []

    def request(self, payload, timeout_s=None):
        self.seen.append(payload["op"])
        return {"ok": True, "op": payload["op"]}


def test_control_channel_storm_matches_jax():
    slept, jslept = [], []
    kw = dict(delay={"renew": 0.25}, partition=(9, 12))
    a = ControlChannelChaos(_Echo(), ChaosPolicy(seed=CHAOS_SEED,
                                                 failure_rate=0.3),
                            sleep=slept.append, **kw)
    b = JChannelChaos(_Echo(), JPolicy(seed=CHAOS_SEED, failure_rate=0.3),
                      sleep=jslept.append, **kw)
    ops = ["join", "renew", "barrier", "renew", "sync", "barrier"] * 4
    got, want = [], []
    for ch, out, err in ((a, got, ChaosError), (b, want, JChaosError)):
        for op in ops:
            try:
                out.append(ch.request({"op": op})["op"])
            except err as e:
                out.append(f"fault: {e}")
    assert got == want
    assert a.requests == b.requests and a.total == b.total == len(ops)
    assert slept == jslept and slept
    assert a.inner.seen == b.inner.seen
    assert all(g.startswith("fault: chaos: control channel partitioned")
               for g in got[9:12])


_KILLED = r"""
import numpy as np
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience.chaos import KillAtStep

conf = (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.05)
        .updater("ADAM").list()
        .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
        .layer(OutputLayer(n_out=3)).build())
net = MultiLayerNetwork(conf, device="cpu").init()
net.listeners.append(KillAtStep(3))
rng = np.random.RandomState(0)
for i in range(6):
    net.fit_minibatch(DataSet(rng.randn(8, 4).astype(np.float32),
                              np.eye(3, dtype=np.float32)[
                                  rng.randint(0, 3, 8)]))
    print("step", net.iteration_count, flush=True)
"""


def test_kill_at_step_sigkills_its_own_process():
    p = subprocess.run([sys.executable, "-c", _KILLED], cwd=str(ROOT),
                       env=dict(os.environ, PYTHONPATH=str(ROOT),
                                OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == -signal.SIGKILL, p.stderr[-3000:]
    assert p.stdout.split() == ["step", "1", "step", "2"]
    k = KillAtStep(5, sig=signal.SIGUSR1)
    assert (k.at_step, k.sig) == (5, signal.SIGUSR1)
