"""The line-search solvers in the port against the JAX package, on the
CPU.

- ``backtrack_line_search`` returns JAX's ``alpha`` and score, the
  no-decrease case (``alpha == 0``, the score unchanged) included;
- LINE_GRADIENT_DESCENT, CONJUGATE_GRADIENT and LBFGS give JAX's
  trajectory (scores, parameters and each step's accepted ``alpha``) on
  JAX ``tests/test_solvers.py``'s nets, a convex output layer and a
  tanh hidden layer, and the convex one at a first trial step of 6
  (every step backtracks, 1 to 3 times), through
  ``MultiLayerNetwork.fit_minibatch`` and
  ``ComputationGraph.fit_minibatch``; ``fit`` routes through the solver;
- the flat vector is ``ravel_pytree``'s order; the LBFGS / CG state
  persists across minibatches and across ``init`` (as in JAX) until
  ``reset_state``;
- an unknown algorithm raises ``ValueError``; ``DistributedTrainer``,
  ``ParallelWrapper`` and the chunk path refuse a solver configuration
  (and the trainers a pretraining one) with a ``ValueError`` naming the
  deferral; ``megastep`` and the scan path leave a solver to the
  per-step loop.

Tolerance ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5): the dot
products and the forward sum in other orders than XLA's; over 8 steps
the parameters are held to 10x that, the LBFGS memory compounding it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.datasets.api import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.optimize import (
    backtrack_line_search as jbacktrack_line_search,
)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.api import MultiDataSet
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import (
    Solver,
    backtrack_line_search,
    is_solver_algo,
)
from deeplearning4j_tpu_torch.parallel import (
    DistributedTrainer,
    ParallelWrapper,
)
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

ALGOS = ["LINE_GRADIENT_DESCENT", "CONJUGATE_GRADIENT", "LBFGS"]
STEPS = 8


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# -- the line search ----------------------------------------------------------


@pytest.mark.parametrize("p0,flip,step0,max_iters", [
    ([4.0, 3.0], False, 1.0, 10),    # accepted after backtracking
    ([0.3, -0.2], False, 0.25, 5),   # accepted at once
    ([4.0, 3.0], False, 8.0, 2),     # out of trials: no decrease
    ([1.0, 1.0], True, 1.0, 5),      # an ascent direction: alpha 0
])
def test_backtrack_line_search_matches_jax(p0, flip, step0, max_iters):
    def jf(p):
        return jnp.sum(p * p * jnp.asarray([1.0, 3.0]))

    def f(p):
        return torch.sum(p * p * torch.tensor([1.0, 3.0]))

    jp = jnp.asarray(p0, jnp.float32)
    jg = jax.grad(jf)(jp)
    jd = jg if flip else -jg
    jalpha, jscore = jbacktrack_line_search(jf, jp, jf(jp), jg, jd, step0,
                                            max_iters=max_iters)
    p = torch.tensor(p0)
    g = torch.from_numpy(np.array(jg))
    d = g if flip else -g
    alpha, score, trials = backtrack_line_search(f, p, f(p), g, d, step0,
                                                 max_iters=max_iters)
    assert float(alpha) == float(jalpha)
    np.testing.assert_allclose(float(score), float(jscore), *kernel_tols())
    assert 0 <= trials <= max_iters
    if flip or float(jalpha) == 0.0:
        assert float(alpha) == 0.0 and float(score) == float(f(p))


# -- trajectories -------------------------------------------------------------


def _convex(seed=0, n=60, d=8, k=3):
    r = np.random.RandomState(seed)
    w = r.randn(d, k).astype(np.float32)
    x = r.randn(n, d).astype(np.float32)
    return x, x @ w + 0.01 * r.randn(n, k).astype(np.float32)


def _blobs(seed=1):
    r = np.random.RandomState(seed)
    centers = r.randn(3, 4) * 3
    x = np.concatenate([centers[i] + r.randn(30, 4)
                        for i in range(3)]).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[np.repeat(np.arange(3), 30)]


def _builder(algo, lr, seed):
    return (JNeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
            .optimization_algo(algo))


NETS = {
    # JAX tests/test_solvers.py:27 (convex: identity + MSE)
    "convex": (lambda algo: _builder(algo, 1.0, 7).list()
               .layer(JOutput(n_in=8, n_out=3, activation="identity",
                              loss="MSE")).build(), _convex),
    # JAX tests/test_solvers.py:126 (a tanh hidden layer, MCXENT)
    "hidden": (lambda algo: _builder(algo, 0.5, 5).list()
               .layer(JDense(n_in=4, n_out=16, activation="tanh"))
               .layer(JOutput(n_out=3, loss="MCXENT")).build(), _blobs),
    # the convex net at a first trial step of 6: every step backtracks
    "steep": (lambda algo: _builder(algo, 6.0, 7).list()
              .layer(JOutput(n_in=8, n_out=3, activation="identity",
                             loss="MSE")).build(), _convex),
}


def _graph_conf(algo, hidden, lr):
    b = _builder(algo, lr, 4).graph_builder()
    b.add_inputs("in")
    if hidden:
        b.add_layer("h", JDense(n_in=4, n_out=16, activation="tanh"), "in")
        b.add_layer("out", JOutput(n_in=16, n_out=3, loss="MCXENT"), "h")
    else:
        b.add_layer("out", JOutput(n_in=8, n_out=3, activation="identity",
                                   loss="MSE"), "in")
    return b.set_outputs("out").build()


def _carried(jnet, device="cpu"):
    return params_from_numpy(
        {f"{ln}/{pn}": np.asarray(a) for ln, lp in jnet.params.items()
         for pn, a in lp.items()}, device)


def _pair(engine, net_name, algo):
    """(JAX model, port model on its carried weights, x, y)."""
    build, data = NETS[net_name]
    x, y = data()
    if engine == "multilayer":
        jconf = build(algo)
        jnet = JMultiLayerNetwork(jconf).init()
        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(jconf.to_json()),
            device="cpu").init(params=_carried(jnet))
    else:
        jconf = _graph_conf(algo, net_name == "hidden",
                            {"convex": 1.0, "hidden": 0.5, "steep": 6.0}[
                                net_name])
        jnet = JGraph(jconf).init()
        net = ComputationGraph(
            ComputationGraphConfiguration.from_json(jconf.to_json()),
            device="cpu").init(params=_carried(jnet))
    return jnet, net, x, y


def _batch(engine, x, y, jax_side):
    if engine == "multilayer":
        return (JDataSet if jax_side else DataSet)(features=x, labels=y)
    return (JMultiDataSet if jax_side else MultiDataSet)(features=[x],
                                                         labels=[y])


@pytest.mark.parametrize("engine", ["multilayer", "graph"])
@pytest.mark.parametrize("net_name", sorted(NETS))
@pytest.mark.parametrize("algo", ALGOS)
def test_solver_trajectory_matches_jax(engine, net_name, algo):
    jnet, net, x, y = _pair(engine, net_name, algo)
    rtol, atol = kernel_tols()
    for step in range(STEPS):
        before = np.asarray(ravel_pytree(jnet.params)[0])
        js = float(jnet.fit_minibatch(_batch(engine, x, y, True)))
        s = float(net.fit_minibatch(_batch(engine, x, y, False)))
        np.testing.assert_allclose(s, js, rtol=rtol, atol=atol,
                                   err_msg=f"step {step}")
        # the accepted step, alpha times the direction: another alpha
        # would move the parameters twice (or half) as far
        move = np.asarray(ravel_pytree(jnet.params)[0]) - before
        got = _np(net._solver.ravel(net.params)) - before
        np.testing.assert_allclose(got, move, rtol=10 * rtol,
                                   atol=10 * atol, err_msg=f"step {step}")
        (rec,) = net._solver.last_steps
        assert (float(rec["alpha"]) == 0.0) == (not np.any(move))
    assert net.iteration_count == jnet.iteration_count == STEPS
    flat, _ = ravel_pytree(jnet.params)
    np.testing.assert_allclose(_np(net._solver.ravel(net.params)),
                               np.asarray(flat), rtol=10 * rtol,
                               atol=10 * atol)
    assert np.isfinite(net.score_value)


def test_flat_order_is_ravel_pytrees():
    jnet, net, x, y = _pair("multilayer", "hidden", "LBFGS")
    solver = Solver(net)
    flat, _ = ravel_pytree(jnet.params)
    np.testing.assert_array_equal(_np(solver.ravel(net.params)),
                                  np.asarray(flat))
    again = solver.unravel(solver.ravel(net.params))
    for ln, lp in net.params.items():
        for pn, t in lp.items():
            assert torch.equal(again[ln][pn], t)


def test_fit_routes_through_the_solver_and_keeps_its_state():
    """``fit`` (per step: the scan and megastep paths are the SGD
    step's) runs the solver on each minibatch; the LBFGS memory fills
    across minibatches and survives ``init`` as JAX's does, until
    ``reset_state``."""
    x, y = _convex()
    jconf = NETS["convex"][0]("LBFGS")
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.optimization_algo == "LBFGS" and is_solver_algo("LBFGS")
    net = MultiLayerNetwork(conf, device="cpu").init()
    s0 = net.score(DataSet(features=x, labels=y))
    net.fit([DataSet(features=x, labels=y)] * 4, megastep=2)
    net.fit(x, y, epochs=6)
    assert net.iteration_count == 10
    assert net.score(DataSet(features=x, labels=y)) < 0.05 * s0
    solver = net._solver
    assert int(solver._count) == 10
    net.init()
    assert net._solver is solver and int(solver._count) == 10
    solver.reset_state()
    assert int(solver._count) == 0 and solver._prev_g is None


def test_unknown_algorithm_and_the_sgd_only_paths_refuse():
    jconf = NETS["convex"][0]("LBFGS")
    d = MultiLayerConfiguration.from_json(jconf.to_json()).to_dict()
    x, y = _convex()
    odd = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        dict(d, optimization_algo="HESSIAN_FREE")), device="cpu").init()
    with pytest.raises(ValueError, match="HESSIAN_FREE"):
        odd.fit_minibatch(DataSet(features=x, labels=y))
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(d),
                            device="cpu").init()
    with pytest.raises(ValueError, match="LBFGS solver"):
        DistributedTrainer(net)
    with pytest.raises(ValueError, match="LBFGS solver"):
        ParallelWrapper(net, workers=2).fit([DataSet(features=x, labels=y)])
    from deeplearning4j_tpu_torch.nn import core

    chunk = net._stack_chunk([DataSet(features=x, labels=y)] * 2)
    with pytest.raises(ValueError, match="LBFGS solver"):
        core.launch_chunk(net, chunk, net._scan_step())
    sgd = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        dict(d, optimization_algo="STOCHASTIC_GRADIENT_DESCENT",
             pretrain=True)), device="cpu").init()
    with pytest.raises(ValueError, match="pretraining"):
        DistributedTrainer(sgd)
    assert net.iteration_count == 0


def test_conjugate_gradient_state_persists_across_minibatches():
    """CG's previous gradient and direction carry from one minibatch to
    the next, as JAX's do: two minibatches of different data, each of
    two iterations, against JAX."""
    jconf2 = dataclasses.replace(NETS["hidden"][0]("CONJUGATE_GRADIENT"),
                                 iterations=2)
    jnet = JMultiLayerNetwork(jconf2).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf2.to_json()), device="cpu").init(params=_carried(jnet))
    x, y = _blobs()
    for sl in (slice(0, 45), slice(45, 90)):
        js = float(jnet.fit_minibatch(JDataSet(features=x[sl],
                                               labels=y[sl])))
        s = float(net.fit_minibatch(DataSet(features=x[sl], labels=y[sl])))
        np.testing.assert_allclose(s, js, *kernel_tols())
        assert len(net._solver.last_steps) == 2
    np.testing.assert_allclose(_np(net._solver._prev_d),
                               np.asarray(jnet._solver._prev_d),
                               rtol=10 * kernel_tols()[0],
                               atol=10 * kernel_tols()[1])
