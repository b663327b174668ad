"""Small models for the serving-slice tests
(``tests/test_torch_{engine_api,fleet,reload,compile}.py``):
each built by the JAX package from a seed, trained one step where it
has BatchNormalization (so the running statistics are not the initial
ones), saved as a checkpoint zip and restored into the port on the CPU.
The JAX model, the zip path and the port model come back together."""

import numpy as np

from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import BatchNormalization as JBatchNorm
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu.zoo import models as jax_zoo
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

# the flat request width and the [c, h, w] input of each kind
WIDTHS = {"mlp": 6, "conv": 36, "vgg": 3 * 8 * 8, "resnet": 64}
IMAGE = {"vgg": (3, 8, 8), "resnet": (1, 8, 8)}
KINDS = tuple(WIDTHS)


def jax_mlp(seed=3):
    conf = (JNeuralNetConfiguration.Builder().seed(seed).updater("ADAM")
            .list()
            .layer(JDense(n_in=6, n_out=8, activation="relu"))
            .layer(JOutput(n_out=3, loss="MCXENT"))
            .set_input_type(JInputType.feed_forward(6)).build())
    return JMultiLayerNetwork(conf).init()


def jax_conv_mln(seed=4):
    conf = (JNeuralNetConfiguration.Builder().seed(seed).updater("ADAM")
            .list()
            .layer(JConv(n_out=4, kernel_size=(3, 3), activation="relu"))
            .layer(JPool(pooling_type="MAX"))
            .layer(JDense(n_out=8, activation="relu"))
            .layer(JOutput(n_out=3, loss="MCXENT"))
            .set_input_type(JInputType.convolutional_flat(6, 6, 1))
            .build())
    return JMultiLayerNetwork(conf).init()


def jax_vgg_graph(seed=5):
    """A VGG-shaped graph on [b, 3, 8, 8]: conv-pool, conv-BN(relu)-pool,
    dense, softmax."""
    conf = (JNeuralNetConfiguration.Builder().seed(seed).updater("NESTEROVS")
            .learning_rate(0.05).graph_builder().add_inputs("in")
            .add_layer("c0", JConv(n_out=4, kernel_size=(3, 3),
                                   padding=(1, 1), activation="relu"), "in")
            .add_layer("p0", JPool(pooling_type="MAX"), "c0")
            .add_layer("c1", JConv(n_out=6, kernel_size=(3, 3),
                                   padding=(1, 1), activation="identity"),
                       "p0")
            .add_layer("bn1", JBatchNorm(activation="relu"), "c1")
            .add_layer("p1", JPool(pooling_type="MAX"), "bn1")
            .add_layer("fc", JDense(n_out=16, activation="relu"), "p1")
            .add_layer("out", JOutput(n_out=10, loss="MCXENT"), "fc")
            .set_outputs("out")
            .set_input_types(JInputType.convolutional(8, 8, 3)).build())
    return _trained(JGraph(conf).init(), (3, 8, 8), 10, seed)


def jax_resnet_graph(seed=42):
    """The zoo's ResNet-50 cut to two one-block stages at width 4 on
    [b, 1, 8, 8] (the tests' CIFAR_TINY)."""
    conf = jax_zoo.resnet50(height=8, width=8, channels=1, n_classes=3,
                            cifar_stem=True, depths=(1, 1), base_width=4,
                            seed=seed)
    return _trained(JGraph(conf).init(), (1, 8, 8), 3, seed)


def _trained(jnet, image, n_out, seed):
    rng = np.random.RandomState(seed)
    x = (rng.rand(4, *image) * 0.9 + 0.05).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.randint(0, n_out, 4)]
    jnet.fit(JDataSet(x, y))  # moves BN's running statistics
    return jnet


BUILDERS = {"mlp": jax_mlp, "conv": jax_conv_mln, "vgg": jax_vgg_graph,
            "resnet": jax_resnet_graph}


def pair(kind, directory, seed=None):
    """(JAX model, zip path, port model on the CPU) of ``kind``."""
    jnet = BUILDERS[kind]() if seed is None else BUILDERS[kind](seed)
    path = str(directory / f"{kind}-{seed}.zip")
    jax_serializer.write_model(jnet, path)
    return jnet, path, restore_model(path, device="cpu")


def rows(kind, n, seed):
    """``n`` request rows of ``kind``'s flat width, no exact zeros."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, WIDTHS[kind]) * 0.9 + 0.05).astype(np.float32)


def jax_output(kind, jnet, x):
    """JAX's ``output`` on flat rows (reshaped for a graph's image)."""
    if kind in IMAGE:
        return np.asarray(jnet.output(x.reshape((-1,) + IMAGE[kind]))[0])
    return np.asarray(jnet.output(x))


def reshape_rows(feats):
    """The serving ``transform`` of a fleet of these kinds: flat rows of
    an image width become [n, c, h, w] (the widths are distinct)."""
    feats = np.asarray(feats)
    for kind, image in IMAGE.items():
        if feats.shape[-1] == WIDTHS[kind]:
            return feats.reshape((-1,) + image)
    return feats
