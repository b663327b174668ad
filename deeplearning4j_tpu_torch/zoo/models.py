"""Model zoo: builders for the configurations the port serves so far.

Counterpart of ``deeplearning4j_tpu/zoo/models.py`` for ``lenet``,
``alexnet``, ``vgg16``, ``resnet50``, ``googlenet``, ``transformer_lm``
and ``graves_lstm_char_rnn``, with the JAX package's defaults, so each
builder here gives the same ``configuration.json`` as its counterpart
there. Callers wrap the configuration in ``MultiLayerNetwork(conf,
device=...)`` (``vgg16``, ``resnet50``, ``googlenet``: in
``ComputationGraph(conf, device=...)``) and ``.init()`` it.
"""

from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseVertex,
    MergeVertex,
)
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    GravesLSTM,
    OutputLayer,
    PositionalEncoding,
    RnnOutputLayer,
    SubsamplingLayer,
    TransformerBlock,
)


def lenet(height=28, width=28, channels=1, n_classes=10, *,
          dense_width=512, updater="ADAM", learning_rate=0.01, seed=42,
          dtype="float32", compute_dtype=None):
    """LeNet-5: conv 5x5 -> 20 relu, maxpool 2x2, conv 5x5 -> 50 relu,
    maxpool, dense 512 relu, softmax output."""
    return (
        NeuralNetConfiguration.Builder()
        .seed(seed).learning_rate(learning_rate).updater(updater)
        .data_type(dtype).compute_data_type(compute_dtype)
        .list()
        .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                activation="relu"))
        .layer(SubsamplingLayer(pooling_type="MAX"))
        .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                activation="relu"))
        .layer(SubsamplingLayer(pooling_type="MAX"))
        .layer(DenseLayer(n_out=dense_width, activation="relu"))
        .layer(OutputLayer(n_out=n_classes, loss="MCXENT"))
        .set_input_type(
            InputType.convolutional_flat(height, width, channels)
        )
        .build()
    )


def alexnet(height=224, width=224, channels=3, n_classes=1000, *,
            updater="NESTEROVS", learning_rate=0.01, seed=42,
            dtype="float32", compute_dtype=None):
    """AlexNet (Krizhevsky et al. 2012, without the grouped convs)."""
    return (
        NeuralNetConfiguration.Builder()
        .seed(seed).learning_rate(learning_rate).updater(updater)
        .data_type(dtype).compute_data_type(compute_dtype)
        .list()
        .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                stride=(4, 4), padding=(2, 2),
                                activation="relu"))
        .layer(SubsamplingLayer(pooling_type="MAX", kernel_size=(3, 3),
                                stride=(2, 2)))
        .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                padding=(2, 2), activation="relu"))
        .layer(SubsamplingLayer(pooling_type="MAX", kernel_size=(3, 3),
                                stride=(2, 2)))
        .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                padding=(1, 1), activation="relu"))
        .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                padding=(1, 1), activation="relu"))
        .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                padding=(1, 1), activation="relu"))
        .layer(SubsamplingLayer(pooling_type="MAX", kernel_size=(3, 3),
                                stride=(2, 2)))
        .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
        .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
        .layer(OutputLayer(n_out=n_classes, loss="MCXENT"))
        .set_input_type(InputType.convolutional(height, width, channels))
        .build()
    )


def vgg16(height=32, width=32, channels=3, n_classes=10, *,
          dense_width=512, updater="NESTEROVS", learning_rate=0.01,
          seed=42, dtype="float32", compute_dtype=None):
    """VGG-16 as a ComputationGraph (BASELINE.md config #2): five blocks
    of 3x3 pad-1 relu convs (2 x 64, 2 x 128, 3 x 256, 3 x 512, 3 x
    512), each closed by a 2x2 max pool, then two dense relu layers of
    ``dense_width`` and a softmax output."""
    b = (
        NeuralNetConfiguration.Builder()
        .seed(seed).learning_rate(learning_rate).updater(updater)
        .data_type(dtype).compute_data_type(compute_dtype)
        .graph_builder()
        .add_inputs("in")
    )
    prev = "in"
    idx = 0
    for block, (n_layers, width_) in enumerate(
            [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]):
        for _ in range(n_layers):
            name = f"conv{idx}"
            b.add_layer(name, ConvolutionLayer(
                n_out=width_, kernel_size=(3, 3), padding=(1, 1),
                activation="relu"), prev)
            prev = name
            idx += 1
        pname = f"pool{block}"
        b.add_layer(pname, SubsamplingLayer(pooling_type="MAX"), prev)
        prev = pname
    b.add_layer("fc0", DenseLayer(n_out=dense_width, activation="relu"),
                prev)
    b.add_layer("fc1", DenseLayer(n_out=dense_width, activation="relu"),
                "fc0")
    b.add_layer("out", OutputLayer(n_out=n_classes, loss="MCXENT"), "fc1")
    b.set_outputs("out")
    b.set_input_types(InputType.convolutional(height, width, channels))
    return b.build()


def _resnet_bottleneck(b, name, in_name, width, *, stride=1,
                       project=False):
    """conv1x1 -> conv3x3 -> conv1x1 (4*width) + identity/projection
    shortcut, joined by an ElementWiseVertex Add and a ReLU."""
    b.add_layer(f"{name}_c1", ConvolutionLayer(
        n_out=width, kernel_size=(1, 1), activation="identity",
    ), in_name)
    b.add_layer(f"{name}_bn1", BatchNormalization(activation="relu"),
                f"{name}_c1")
    b.add_layer(f"{name}_c2", ConvolutionLayer(
        n_out=width, kernel_size=(3, 3), stride=(stride, stride),
        padding=(1, 1), activation="identity",
    ), f"{name}_bn1")
    b.add_layer(f"{name}_bn2", BatchNormalization(activation="relu"),
                f"{name}_c2")
    b.add_layer(f"{name}_c3", ConvolutionLayer(
        n_out=4 * width, kernel_size=(1, 1), activation="identity",
    ), f"{name}_bn2")
    b.add_layer(f"{name}_bn3", BatchNormalization(activation="identity"),
                f"{name}_c3")
    shortcut = in_name
    if project:
        b.add_layer(f"{name}_proj", ConvolutionLayer(
            n_out=4 * width, kernel_size=(1, 1),
            stride=(stride, stride), activation="identity",
        ), in_name)
        b.add_layer(f"{name}_projbn",
                    BatchNormalization(activation="identity"),
                    f"{name}_proj")
        shortcut = f"{name}_projbn"
    b.add_vertex(f"{name}_add", ElementWiseVertex(op="Add"),
                 f"{name}_bn3", shortcut)
    b.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_relu"


def resnet50(height=224, width=224, channels=3, n_classes=1000, *,
             updater="NESTEROVS", learning_rate=0.1, seed=42,
             dtype="float32", compute_dtype=None, cifar_stem=False,
             depths=(3, 4, 6, 3), base_width=64, remat="none",
             loss_scale=None):
    """ResNet-50 v1 as a ComputationGraph (BASELINE.md config #5, the
    data-parallel scaling model): a 7x7 stride-2 stem conv, BN, relu and
    a 3x3 stride-2 max pool (``cifar_stem=True``: one 3x3 stride-1 conv
    and BN instead, for 32x32 inputs), then bottleneck stacks of
    ``depths`` (default [3, 4, 6, 3]) at widths ``base_width * 2**i``,
    the first block of each stage with a projection shortcut (stride 2
    from the second stage on), a global average pool and a softmax
    output. ``remat`` (``none | dots_saveable | full``) recomputes each
    layer vertex's activations in the backward (``nn/core.py``);
    ``loss_scale`` arms dynamic loss scaling for
    ``compute_dtype="float16"``."""
    # total stride: stem (1 or 4, incl. maxpool) x 2 per later stage
    div = (1 if cifar_stem else 4) * (2 ** (len(depths) - 1))
    if height % div or width % div:
        raise ValueError(
            f"resnet50 input extent must be divisible by {div} "
            f"(total stride{' with cifar_stem' if cifar_stem else ''}); "
            f"got {height}x{width} — the global average pool would "
            "silently drop edge cells otherwise"
        )
    b = (
        NeuralNetConfiguration.Builder()
        .seed(seed).learning_rate(learning_rate).updater(updater)
        .data_type(dtype).compute_data_type(compute_dtype)
        .remat(remat).loss_scale(loss_scale)
        .graph_builder()
        .add_inputs("in")
    )
    if cifar_stem:
        b.add_layer("stem", ConvolutionLayer(
            n_out=base_width, kernel_size=(3, 3), padding=(1, 1),
            activation="identity",
        ), "in")
        b.add_layer("stem_bn", BatchNormalization(activation="relu"),
                    "stem")
        prev = "stem_bn"
    else:
        b.add_layer("stem", ConvolutionLayer(
            n_out=base_width, kernel_size=(7, 7), stride=(2, 2),
            padding=(3, 3), activation="identity",
        ), "in")
        b.add_layer("stem_bn", BatchNormalization(activation="relu"),
                    "stem")
        b.add_layer("stem_pool", SubsamplingLayer(
            pooling_type="MAX", kernel_size=(3, 3), stride=(2, 2),
            padding=(1, 1),
        ), "stem_bn")
        prev = "stem_pool"
    widths = [base_width * 2 ** i for i in range(len(depths))]
    for stage, (w, d) in enumerate(zip(widths, depths)):
        for block in range(d):
            stride = 2 if (block == 0 and stage > 0) else 1
            prev = _resnet_bottleneck(
                b, f"s{stage}b{block}", prev, w,
                stride=stride, project=(block == 0),
            )
    # global average pool: AVG-pool over the full remaining extent
    final_hw = (height // div, width // div)
    b.add_layer("gap", SubsamplingLayer(
        pooling_type="AVG", kernel_size=final_hw, stride=final_hw,
    ), prev)
    b.add_layer("out", OutputLayer(n_out=n_classes, loss="MCXENT"), "gap")
    b.set_outputs("out")
    b.set_input_types(InputType.convolutional(height, width, channels))
    return b.build()


def _inception_module(b, name, in_name, c1, c3r, c3, c5r, c5, pp):
    """GoogLeNet inception module: 1x1 / 1x1->3x3 / 1x1->5x5 /
    maxpool->1x1 branches concatenated over channels (MergeVertex)."""
    b.add_layer(f"{name}_b1", ConvolutionLayer(
        n_out=c1, kernel_size=(1, 1), activation="relu"), in_name)
    b.add_layer(f"{name}_b3r", ConvolutionLayer(
        n_out=c3r, kernel_size=(1, 1), activation="relu"), in_name)
    b.add_layer(f"{name}_b3", ConvolutionLayer(
        n_out=c3, kernel_size=(3, 3), padding=(1, 1),
        activation="relu"), f"{name}_b3r")
    b.add_layer(f"{name}_b5r", ConvolutionLayer(
        n_out=c5r, kernel_size=(1, 1), activation="relu"), in_name)
    b.add_layer(f"{name}_b5", ConvolutionLayer(
        n_out=c5, kernel_size=(5, 5), padding=(2, 2),
        activation="relu"), f"{name}_b5r")
    b.add_layer(f"{name}_pool", SubsamplingLayer(
        pooling_type="MAX", kernel_size=(3, 3), stride=(1, 1),
        padding=(1, 1)), in_name)
    b.add_layer(f"{name}_pp", ConvolutionLayer(
        n_out=pp, kernel_size=(1, 1), activation="relu"), f"{name}_pool")
    b.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_b1", f"{name}_b3",
                 f"{name}_b5", f"{name}_pp")
    return f"{name}_cat"


# the inception modules (name, 1x1, 3x3 reduce, 3x3, 5x5 reduce, 5x5,
# pool projection); "pool" rows are the stride-2 max pools between them
GOOGLENET_MODULES = (
    ("3a", 64, 96, 128, 16, 32, 32),
    ("3b", 128, 128, 192, 32, 96, 64),
    ("pool", 0, 0, 0, 0, 0, 0),
    ("4a", 192, 96, 208, 16, 48, 64),
    ("4b", 160, 112, 224, 24, 64, 64),
    ("4c", 128, 128, 256, 24, 64, 64),
    ("4d", 112, 144, 288, 32, 64, 64),
    ("4e", 256, 160, 320, 32, 128, 128),
    ("pool", 0, 0, 0, 0, 0, 0),
    ("5a", 256, 160, 320, 32, 128, 128),
    ("5b", 384, 192, 384, 48, 128, 128),
)


def googlenet(height=224, width=224, channels=3, n_classes=1000, *,
              updater="NESTEROVS", learning_rate=0.01, seed=42,
              dtype="float32", compute_dtype=None):
    """GoogLeNet / Inception v1 (Szegedy et al. 2014) as a
    ComputationGraph, without the auxiliary heads: a 7x7 stride-2 stem,
    max pools, a 1x1 -> 3x3 stem pair, nine inception modules
    (``GOOGLENET_MODULES``), a global average pool and a softmax output
    with dropout 0.4. ~6M parameters."""
    if height % 32 or width % 32:
        raise ValueError(
            "googlenet input extent must be divisible by 32; got "
            f"{height}x{width}")
    b = (
        NeuralNetConfiguration.Builder()
        .seed(seed).learning_rate(learning_rate).updater(updater)
        .data_type(dtype).compute_data_type(compute_dtype)
        .graph_builder()
        .add_inputs("in")
    )
    b.add_layer("stem1", ConvolutionLayer(
        n_out=64, kernel_size=(7, 7), stride=(2, 2), padding=(3, 3),
        activation="relu"), "in")
    b.add_layer("pool1", SubsamplingLayer(
        pooling_type="MAX", kernel_size=(3, 3), stride=(2, 2),
        padding=(1, 1)), "stem1")
    b.add_layer("stem2r", ConvolutionLayer(
        n_out=64, kernel_size=(1, 1), activation="relu"), "pool1")
    b.add_layer("stem2", ConvolutionLayer(
        n_out=192, kernel_size=(3, 3), padding=(1, 1),
        activation="relu"), "stem2r")
    b.add_layer("pool2", SubsamplingLayer(
        pooling_type="MAX", kernel_size=(3, 3), stride=(2, 2),
        padding=(1, 1)), "stem2")
    prev = "pool2"
    n_pools = 0
    for name, c1, c3r, c3, c5r, c5, pp in GOOGLENET_MODULES:
        if name == "pool":
            n_pools += 1
            pname = f"pool{2 + n_pools}"
            b.add_layer(pname, SubsamplingLayer(
                pooling_type="MAX", kernel_size=(3, 3), stride=(2, 2),
                padding=(1, 1)), prev)
            prev = pname
        else:
            prev = _inception_module(b, f"inc{name}", prev, c1, c3r, c3,
                                     c5r, c5, pp)
    gap = (height // 32, width // 32)
    b.add_layer("gap", SubsamplingLayer(
        pooling_type="AVG", kernel_size=gap, stride=gap), prev)
    b.add_layer("out", OutputLayer(n_out=n_classes, loss="MCXENT",
                                   dropout=0.4), "gap")
    b.set_outputs("out")
    b.set_input_types(InputType.convolutional(height, width, channels))
    return b.build()


def transformer_lm(vocab=77, d_model=256, n_layers=4, n_heads=8, *,
                   ffn_hidden=None, n_experts=0, updater="ADAM",
                   learning_rate=1e-3, seed=42, dtype="float32",
                   compute_dtype=None, scan_layers=False, remat="none",
                   loss_scale=None):
    """Decoder-only transformer language model: a dense input
    projection of the ``[b, vocab, t]`` one-hots, sinusoidal positional
    encoding, ``n_layers`` causal pre-norm TransformerBlocks (flash
    attention), a softmax head over the vocabulary. ``scan_layers``
    (trajectory-neutral; the JAX package's scan over the blocks),
    ``remat`` (``none | dots_saveable | full``) and ``loss_scale``
    (dynamic loss scaling for ``compute_dtype="float16"``) are the
    whole-net transform hints (``nn/core.py``); ``n_experts > 0`` swaps
    each block's dense FFN for a Switch mixture-of-experts FFN
    (``parallel/expert.py``)."""
    b = (
        NeuralNetConfiguration.Builder()
        .seed(seed).learning_rate(learning_rate).updater(updater)
        .data_type(dtype).compute_data_type(compute_dtype)
        .scan_layers(scan_layers).remat(remat).loss_scale(loss_scale)
        .list()
        .layer(DenseLayer(n_out=d_model, activation="identity"))
        .layer(PositionalEncoding())
    )
    for _ in range(n_layers):
        b.layer(TransformerBlock(
            n_heads=n_heads, causal=True,
            ffn_hidden=ffn_hidden or 4 * d_model,
            n_experts=n_experts,
        ))
    b.layer(RnnOutputLayer(n_out=vocab, loss="MCXENT"))
    b.set_input_type(InputType.recurrent(vocab))
    return b.build()


def graves_lstm_char_rnn(vocab=77, hidden=200, n_layers=2, *,
                         updater="RMSPROP", learning_rate=0.1, seed=42,
                         tbptt_length=None, dtype="float32",
                         compute_dtype=None):
    """Stacked GravesLSTM character model (BASELINE.md config #3;
    reference ``nn/layers/recurrent/LSTMHelpers.java``). The layers
    keep GravesLSTM's default peepholes."""
    b = (
        NeuralNetConfiguration.Builder()
        .seed(seed).learning_rate(learning_rate).updater(updater)
        .data_type(dtype).compute_data_type(compute_dtype)
        .list()
    )
    n_in = vocab
    for _ in range(n_layers):
        b.layer(GravesLSTM(n_in=n_in, n_out=hidden, activation="tanh"))
        n_in = hidden
    b.layer(RnnOutputLayer(n_out=vocab, loss="MCXENT"))
    if tbptt_length:
        b.backprop_type("TruncatedBPTT")
        b.t_bptt_forward_length(tbptt_length)
        b.t_bptt_backward_length(tbptt_length)
    return b.build()
