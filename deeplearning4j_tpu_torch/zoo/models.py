"""Model zoo: builders for the configurations the port serves so far.

Counterpart of ``deeplearning4j_tpu/zoo/models.py`` for ``lenet``,
``alexnet`` and ``graves_lstm_char_rnn``, with the JAX package's
defaults, so each builder here
gives the same ``configuration.json`` as its counterpart there. Callers
wrap the configuration in ``MultiLayerNetwork(conf, device=...)`` and
``.init()`` it.
"""

from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    GravesLSTM,
    OutputLayer,
    RnnOutputLayer,
    SubsamplingLayer,
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
