"""The port's ComputationGraph against the JAX package's, on the CPU.

Each of the 13 vertex types is held against its JAX ``apply`` (and its
JSON against JAX's); graph configurations go both ways through
``configuration.json`` with equal topological orders; a two-input graph
(Merge, ElementWise, Subset) and a narrow conv graph whose flatten sees
2 x 2 x 6 compute JAX's ``output`` and ``score`` from carried weights,
and fit three NESTEROVS steps along JAX's trajectory; checkpoint zips
restore across the two packages. Inputs are made from a numpy seed and
handed to both.

Tolerances: ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5), the same
math summed in other orders. The training data has no exact zeros (so
no relu pre-activation is exactly 0, where the port's conv kernel
gradient is 0.5 and JAX's XLA route gives 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.conf import graph_conf as jgc
from deeplearning4j_tpu.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor as JCnnToFF,
)
from deeplearning4j_tpu.nn.conf.preprocessors import (
    RnnToFeedForwardPreProcessor as JRnnToFF,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import BatchNormalization as JBatchNorm
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration,
    InputType,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf import graph_conf as gc
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.serving import ModelServer
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    params_to_numpy,
    restore_computation_graph,
    restore_model,
    write_model,
)


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# -- the 13 vertex types ------------------------------------------------------

def _vertex_cases():
    """(id, JAX vertex, port vertex, input shapes, params, extra kwargs of
    apply)."""
    dense = dict(n_in=6, n_out=4, activation="tanh")
    flat_dense = dict(n_in=12, n_out=4, activation="relu")
    cases = [
        ("layer", jgc.LayerVertex(layer_conf=JDense(**dense)),
         gc.LayerVertex(layer_conf=DenseLayer(**dense)), [(5, 6)],
         {"W": (6, 4), "b": (4,)}, {}),
        ("layer_preprocessor",
         jgc.LayerVertex(layer_conf=JDense(**flat_dense),
                         preprocessor=JCnnToFF(2, 2, 3)),
         gc.LayerVertex(layer_conf=DenseLayer(**flat_dense),
                        preprocessor=gc.InputPreProcessor.from_json(
                            JCnnToFF(2, 2, 3).to_json())),
         [(5, 3, 2, 2)], {"W": (12, 4), "b": (4,)}, {}),
        ("merge_ff", jgc.MergeVertex(), gc.MergeVertex(), [(5, 3), (5, 4)],
         {}, {}),
        ("merge_cnn", jgc.MergeVertex(), gc.MergeVertex(),
         [(2, 3, 4, 4), (2, 5, 4, 4)], {}, {}),
        ("subset", jgc.SubsetVertex(from_idx=1, to_idx=3),
         gc.SubsetVertex(from_idx=1, to_idx=3), [(5, 6)], {}, {}),
        ("l2", jgc.L2Vertex(), gc.L2Vertex(), [(5, 3, 2, 2), (5, 3, 2, 2)],
         {}, {}),
        ("l2_normalize", jgc.L2NormalizeVertex(), gc.L2NormalizeVertex(),
         [(5, 3, 2)], {}, {}),
        ("stack", jgc.StackVertex(), gc.StackVertex(), [(5, 3), (4, 3)], {},
         {}),
        ("unstack", jgc.UnstackVertex(from_idx=1, stack_size=3),
         gc.UnstackVertex(from_idx=1, stack_size=3), [(9, 3)], {}, {}),
        ("preprocessor_cnn", jgc.PreprocessorVertex(
            preprocessor=JCnnToFF(2, 2, 3)),
         gc.PreprocessorVertex(preprocessor=gc.InputPreProcessor.from_json(
             JCnnToFF(2, 2, 3).to_json())), [(5, 3, 2, 2)], {}, {}),
        ("preprocessor_rnn", jgc.PreprocessorVertex(
            preprocessor=JRnnToFF()),
         gc.PreprocessorVertex(preprocessor=gc.InputPreProcessor.from_json(
             JRnnToFF().to_json())), [(5, 3, 4)], {}, {}),
        ("scale", jgc.ScaleVertex(scale=-2.5), gc.ScaleVertex(scale=-2.5),
         [(5, 3)], {}, {}),
        ("shift", jgc.ShiftVertex(shift=0.75), gc.ShiftVertex(shift=0.75),
         [(5, 3)], {}, {}),
        ("last_time_step", jgc.LastTimeStepVertex(),
         gc.LastTimeStepVertex(), [(5, 3, 4)], {}, {}),
        ("last_time_step_masked", jgc.LastTimeStepVertex(),
         gc.LastTimeStepVertex(), [(5, 3, 4)], {}, {"mask": True}),
        ("duplicate_to_time_series", jgc.DuplicateToTimeSeriesVertex(
            reference_input="r"),
         gc.DuplicateToTimeSeriesVertex(reference_input="r"), [(5, 3)], {},
         {"time": 4}),
    ]
    for op in ("Add", "Subtract", "Product", "Average", "Max"):
        cases.append((f"elementwise_{op.lower()}",
                      jgc.ElementWiseVertex(op=op),
                      gc.ElementWiseVertex(op=op), [(5, 3), (5, 3)], {}, {}))
    return cases


VERTEX_CASES = _vertex_cases()


def test_every_vertex_type_is_covered():
    covered = {type(c[2]).__name__ for c in VERTEX_CASES}
    assert covered == set(gc.VERTEX_REGISTRY) == set(jgc.VERTEX_REGISTRY)
    assert len(covered) == 13


@pytest.mark.parametrize("case", VERTEX_CASES, ids=[c[0] for c in
                                                     VERTEX_CASES])
def test_vertex_matches_jax(case):
    _, jv, pv, shapes, pshapes, extra = case
    rng = np.random.RandomState(3)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    params = {k: rng.randn(*s).astype(np.float32) * 0.5
              for k, s in pshapes.items()}
    kw = dict(extra)
    if kw.pop("mask", False):
        mask = np.ones((shapes[0][0], shapes[0][2]), np.float32)
        mask[0, 2:] = 0.0
        mask[3, 1:] = 0.0
        mask[4, :] = 0.0  # no step: the first one (argmax of zeros)
        kw["mask"] = mask
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    pkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want, _ = jv.apply({k: jnp.asarray(v) for k, v in params.items()},
                       [jnp.asarray(x) for x in xs], {}, **jkw)
    got, _ = pv.apply({k: torch.from_numpy(v) for k, v in params.items()},
                      [torch.from_numpy(x) for x in xs], {}, **pkw)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)
    assert pv.to_json() == jv.to_json()
    assert gc.GraphVertexSpec.from_json(jv.to_json()) == pv


# -- configurations -----------------------------------------------------------

def jax_two_input_graph():
    """Two inputs: dense branches joined by an ElementWise Add, merged
    with input "a", a Subset of the merge, a softmax output."""
    return (
        JNeuralNetConfiguration.Builder().seed(11).updater("NESTEROVS")
        .learning_rate(0.05).graph_builder()
        .add_inputs("a", "b")
        .add_layer("da", JDense(n_out=6, activation="tanh"), "a")
        .add_layer("db", JDense(n_out=6, activation="relu"), "b")
        .add_vertex("sum", jgc.ElementWiseVertex(op="Add"), "da", "db")
        .add_vertex("merge", jgc.MergeVertex(), "sum", "a")
        .add_vertex("sub", jgc.SubsetVertex(from_idx=2, to_idx=7), "merge")
        .add_layer("out", JOutput(n_out=3, loss="MCXENT"), "sub")
        .set_outputs("out")
        .set_input_types(JInputType.feed_forward(4),
                         JInputType.feed_forward(5))
        .build())


def jax_conv_graph(bn: bool = False):
    """A narrow conv graph on [b, 3, 8, 8]: conv 3x3 pad 1 -> 4 relu,
    max pool, conv -> 6 relu (with ``bn``: identity, then a BN vertex
    with the relu), max pool to 2 x 2, dense 16 relu (its CNN -> FF
    flatten sees 6 x 2 x 2), softmax 10."""
    b = (JNeuralNetConfiguration.Builder().seed(5).updater("NESTEROVS")
         .learning_rate(0.05).graph_builder().add_inputs("in")
         .add_layer("c0", JConv(n_out=4, kernel_size=(3, 3), padding=(1, 1),
                                activation="relu"), "in")
         .add_layer("p0", JPool(pooling_type="MAX"), "c0"))
    if bn:
        b.add_layer("c1", JConv(n_out=6, kernel_size=(3, 3), padding=(1, 1),
                                activation="identity"), "p0")
        b.add_layer("bn1", JBatchNorm(activation="relu"), "c1")
        last = "bn1"
    else:
        b.add_layer("c1", JConv(n_out=6, kernel_size=(3, 3), padding=(1, 1),
                                activation="relu"), "p0")
        last = "c1"
    return (b.add_layer("p1", JPool(pooling_type="MAX"), last)
            .add_layer("fc", JDense(n_out=16, activation="relu"), "p1")
            .add_layer("out", JOutput(n_out=10, loss="MCXENT"), "fc")
            .set_outputs("out")
            .set_input_types(JInputType.convolutional(8, 8, 3))
            .build())


def port_two_input_graph():
    return (
        NeuralNetConfiguration.Builder().seed(11).updater("NESTEROVS")
        .learning_rate(0.05).graph_builder()
        .add_inputs("a", "b")
        .add_layer("da", DenseLayer(n_out=6, activation="tanh"), "a")
        .add_layer("db", DenseLayer(n_out=6, activation="relu"), "b")
        .add_vertex("sum", gc.ElementWiseVertex(op="Add"), "da", "db")
        .add_vertex("merge", gc.MergeVertex(), "sum", "a")
        .add_vertex("sub", gc.SubsetVertex(from_idx=2, to_idx=7), "merge")
        .add_layer("out", OutputLayer(n_out=3, loss="MCXENT"), "sub")
        .set_outputs("out")
        .set_input_types(InputType.feed_forward(4), InputType.feed_forward(5))
        .build())


def port_conv_graph():
    return (NeuralNetConfiguration.Builder().seed(5).updater("NESTEROVS")
            .learning_rate(0.05).graph_builder().add_inputs("in")
            .add_layer("c0", ConvolutionLayer(
                n_out=4, kernel_size=(3, 3), padding=(1, 1),
                activation="relu"), "in")
            .add_layer("p0", SubsamplingLayer(pooling_type="MAX"), "c0")
            .add_layer("c1", ConvolutionLayer(
                n_out=6, kernel_size=(3, 3), padding=(1, 1),
                activation="relu"), "p0")
            .add_layer("p1", SubsamplingLayer(pooling_type="MAX"), "c1")
            .add_layer("fc", DenseLayer(n_out=16, activation="relu"), "p1")
            .add_layer("out", OutputLayer(n_out=10, loss="MCXENT"), "fc")
            .set_outputs("out")
            .set_input_types(InputType.convolutional(8, 8, 3))
            .build())


@pytest.mark.parametrize("build", [jax_two_input_graph, jax_conv_graph,
                                   lambda: jax_conv_graph(bn=True)],
                         ids=["two_input", "conv", "conv_bn"])
def test_configuration_json_round_trips_jax_port_jax(build):
    jconf = build()
    d = jconf.to_dict()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert conf.to_dict() == d
    back = jgc.ComputationGraphConfiguration.from_dict(conf.to_dict())
    assert back.to_dict() == d
    assert conf.topological_order() == jconf.topological_order()


@pytest.mark.parametrize("pair", [(port_two_input_graph, jax_two_input_graph),
                                  (port_conv_graph, jax_conv_graph)],
                         ids=["two_input", "conv"])
def test_port_builder_gives_jax_configuration(pair):
    port_build, jax_build = pair
    conf, jconf = port_build(), jax_build()
    assert conf.to_dict() == jconf.to_dict()
    assert (jgc.ComputationGraphConfiguration.from_dict(conf.to_dict())
            .topological_order() == conf.topological_order())


def test_conv_graph_flattens_before_the_dense_vertex():
    conf = port_conv_graph()
    pre = conf.vertices["fc"].preprocessor
    assert (pre.height, pre.width, pre.channels) == (2, 2, 6)
    assert conf.vertices["fc"].layer_conf.n_in == 24


def test_topological_order_ties_and_refusals():
    """Sources sorted, then discovery order; cycles and unknown inputs
    raise in both packages alike."""
    def build(pkg, vs):
        b = pkg.GraphBuilder().add_inputs("x")
        for name, ins in vs:
            b.add_vertex(name, pkg.ScaleVertex(scale=2.0), *ins)
        return b.set_outputs(vs[-1][0])

    vs = [("z", ("x",)), ("a", ("x",)), ("m", ("z", "a")), ("b", ("a",)),
          ("y", ("m", "b"))]
    assert (build(gc, vs).build().topological_order()
            == build(jgc, vs).build().topological_order()
            == ["a", "z", "b", "m", "y"])
    with pytest.raises(ValueError, match="cycle"):
        build(gc, [("p", ("x", "q")), ("q", ("p",))]).build()
    with pytest.raises(ValueError, match="unknown input"):
        build(gc, [("p", ("nope",))]).build()


# -- forward, score and fit against JAX ---------------------------------------

def _pair(jconf):
    jnet = JGraph(jconf).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_dict(
        jconf.to_dict()), device="cpu").init(
            params=params_from_numpy(_flat(jnet.params), "cpu"))
    return jnet, net


def _zero_free(rng, *shape):
    return (rng.rand(*shape) * 0.9 + 0.05).astype(np.float32)


def _onehot(rng, b, n):
    return np.eye(n, dtype=np.float32)[rng.randint(0, n, b)]


def test_two_input_graph_output_and_score_match_jax():
    jnet, net = _pair(jax_two_input_graph())
    rng = np.random.RandomState(0)
    a, b = rng.randn(7, 4).astype(np.float32), rng.randn(7, 5).astype(
        np.float32)
    y = _onehot(rng, 7, 3)
    rtol, atol = kernel_tols()
    got = net.output(a, b)
    want = jnet.output(a, b)
    assert len(got) == 1 and tuple(got[0].shape) == (7, 3)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=rtol,
                               atol=atol)
    acts = net.feed_forward(a, b)
    jacts = jnet.feed_forward(a, b)
    for name in ("da", "db", "sum", "merge", "sub"):
        np.testing.assert_allclose(_np(acts[name]), np.asarray(jacts[name]),
                                   rtol=rtol, atol=atol, err_msg=name)
    ds = DataSet(features=[a, b], labels=[y])
    np.testing.assert_allclose(
        net.score(ds), jnet.score(JDataSet(features=[a, b], labels=[y])),
        rtol=rtol, atol=atol)


def _fit_both(jnet, net, batches):
    js, ps = [], []
    for x, y in batches:
        jnet.fit(JDataSet(x, y))
        js.append(float(jnet.score_value))
        net.fit(DataSet(x, y))
        ps.append(net.score_value)
    return np.array(js), np.array(ps)


def _check_params(net, jnet):
    rtol, atol = kernel_tols()
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        np.testing.assert_allclose(_np(net.params[ln][pn]), ref, rtol=rtol,
                                   atol=atol, err_msg=key)


def test_conv_graph_output_score_and_three_nesterovs_steps_match_jax():
    jnet, net = _pair(jax_conv_graph())
    rng = np.random.RandomState(1)
    rtol, atol = kernel_tols()
    x = _zero_free(rng, 6, 3, 8, 8)
    y = _onehot(rng, 6, 10)
    np.testing.assert_allclose(_np(net.output(x)[0]),
                               np.asarray(jnet.output(x)[0]), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(net.score(DataSet(x, y)),
                               jnet.score(JDataSet(x, y)), rtol=rtol,
                               atol=atol)
    batches = [(_zero_free(rng, 6, 3, 8, 8), _onehot(rng, 6, 10))
               for _ in range(3)]
    js, ps = _fit_both(jnet, net, batches)
    np.testing.assert_allclose(ps, js, rtol=rtol, atol=atol)
    _check_params(net, jnet)
    for key, ref in jax_serializer._flatten_updater(
            jnet.updater_state).items():
        ln, pn, i = key.rsplit("/", 2)
        np.testing.assert_allclose(
            _np(net.updater_state[ln][pn][int(i)]), ref, rtol=rtol,
            atol=atol, err_msg=key)
    assert net.iteration_count == jnet.iteration_count == 3


def jax_dropout_graph():
    """``jax_conv_graph`` with dropout on the second conv's input, on the
    dense vertex's input, and on the softmax head's weights
    (drop-connect: its pre-output sees the mask of its apply)."""
    return (JNeuralNetConfiguration.Builder().seed(5).updater("NESTEROVS")
            .learning_rate(0.05).graph_builder().add_inputs("in")
            .add_layer("c0", JConv(n_out=4, kernel_size=(3, 3),
                                   padding=(1, 1), activation="relu"), "in")
            .add_layer("p0", JPool(pooling_type="MAX"), "c0")
            .add_layer("c1", JConv(n_out=6, kernel_size=(3, 3),
                                   padding=(1, 1), activation="relu",
                                   dropout=0.2), "p0")
            .add_layer("p1", JPool(pooling_type="MAX"), "c1")
            .add_layer("fc", JDense(n_out=16, activation="relu",
                                    dropout=0.5), "p1")
            .add_layer("out", JOutput(n_out=10, loss="MCXENT", dropout=0.3,
                                      drop_connect=True), "fc")
            .set_outputs("out")
            .set_input_types(JInputType.convolutional(8, 8, 3))
            .build())


def test_graph_with_dropout_three_steps_match_jax():
    """Vertex i of the topological order draws from ``fold_in(step key,
    i)``, as in the JAX engine: the same masks, the same trajectory."""
    jnet, net = _pair(jax_dropout_graph())
    rng = np.random.RandomState(4)
    rtol, atol = kernel_tols()
    batches = [(_zero_free(rng, 6, 3, 8, 8), _onehot(rng, 6, 10))
               for _ in range(3)]
    js, ps = _fit_both(jnet, net, batches)
    np.testing.assert_allclose(ps, js, rtol=rtol, atol=atol)
    _check_params(net, jnet)
    x = _zero_free(rng, 2, 3, 8, 8)
    acts = net.feed_forward(x, train=True)
    jacts = jnet.feed_forward(x, train=True)
    for name in ("c1", "fc"):
        np.testing.assert_allclose(_np(acts[name]), np.asarray(jacts[name]),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_params_flat_round_trips_in_jax_order():
    jnet, net = _pair(jax_conv_graph())
    flat = net.params_flat()
    np.testing.assert_array_equal(flat, np.asarray(jnet.params_flat()))
    assert flat.size == net.num_params() == jnet.num_params()
    net.set_params_flat(flat * 2.0)
    np.testing.assert_array_equal(net.params_flat(), flat * 2.0)


def test_fit_over_epochs_and_an_inputs_labels_pair():
    _, net = _pair(jax_two_input_graph())
    rng = np.random.RandomState(4)
    a, b = rng.randn(16, 4).astype(np.float32), rng.randn(16, 5).astype(
        np.float32)
    y = np.eye(3, dtype=np.float32)[(a[:, 0] > 0).astype(int)
                                    + (b[:, 0] > 0).astype(int)]
    before = net.score(DataSet(features=[a, b], labels=[y]))
    net.fit([a, b], [y], epochs=30)
    assert net.iteration_count == 30 and net.epoch_count == 30
    assert net.score(DataSet(features=[a, b], labels=[y])) < 0.5 * before


def test_what_the_graph_does_not_carry_raises():
    conf = port_conv_graph()
    net = ComputationGraph(conf, device="cpu").init()
    x = np.zeros((2, 3, 8, 8), np.float32)
    with pytest.raises(NotImplementedError, match="rnn_time_step"):
        net.rnn_time_step(x)
    # the transforms are carried now, megastep too
    assert net.set_transforms(remat="full", scan_layers=True) is net
    assert net.set_transforms(megastep=2).megastep == 2
    with pytest.raises(NotImplementedError, match="evaluate"):
        net.evaluate([])
    # one minibatch is a partial block of 4: it runs per step
    net.fit(x, np.eye(10, dtype=np.float32)[[0, 1]], megastep=4)
    assert net.megastep == 4 and net.iteration_count == 1
    with pytest.raises(NotImplementedError, match="AOT"):
        net.aot_export_output((2, 3, 8, 8))
    with pytest.raises(NotImplementedError, match="ComputationGraph"):
        ModelServer(net, device="cpu")


def test_graph_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ComputationGraph(port_conv_graph())


# -- checkpoints --------------------------------------------------------------

def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jnet = JGraph(jax_conv_graph(bn=True)).init()
    rng = np.random.RandomState(2)
    x, y = _zero_free(rng, 6, 3, 8, 8), _onehot(rng, 6, 10)
    jnet.fit(JDataSet(x, y))  # moves BN's running statistics
    path = tmp_path / "jax.zip"
    jax_serializer.write_model(jnet, str(path))
    net = restore_computation_graph(str(path), device="cpu")
    assert isinstance(net, ComputationGraph)
    rtol, atol = kernel_tols()
    for ln, st in jnet.state.items():
        for k, ref in st.items():
            np.testing.assert_array_equal(_np(net.state[ln][k]),
                                          np.asarray(ref))
    xt = _zero_free(rng, 4, 3, 8, 8)
    np.testing.assert_allclose(_np(net.output(xt)[0]),
                               np.asarray(jnet.output(xt)[0]), rtol=rtol,
                               atol=atol)
    assert net.iteration_count == 1


def test_port_checkpoint_restores_into_jax(tmp_path):
    jnet, net = _pair(jax_conv_graph(bn=True))
    rng = np.random.RandomState(3)
    net.fit(DataSet(_zero_free(rng, 6, 3, 8, 8), _onehot(rng, 6, 10)))
    path = tmp_path / "port.zip"
    write_model(net, path)
    jres = jax_serializer.restore_computation_graph(str(path))
    for key, ref in params_to_numpy(net.params).items():
        ln, pn = key.rsplit("/", 1)
        np.testing.assert_array_equal(np.asarray(jres.params[ln][pn]), ref)
    for key, ref in params_to_numpy(net.state).items():
        ln, k = key.rsplit("/", 1)
        np.testing.assert_array_equal(np.asarray(jres.state[ln][k]), ref)
    rtol, atol = kernel_tols()
    xt = _zero_free(rng, 4, 3, 8, 8)
    np.testing.assert_allclose(np.asarray(jres.output(xt)[0]),
                               _np(net.output(xt)[0]), rtol=rtol, atol=atol)
    again = restore_model(path, device="cpu")
    assert isinstance(again, ComputationGraph)
    assert again.iteration_count == jres.iteration_count == 1
