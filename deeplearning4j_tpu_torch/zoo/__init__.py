from deeplearning4j_tpu_torch.zoo.models import (
    alexnet,
    googlenet,
    graves_lstm_char_rnn,
    lenet,
    resnet50,
    transformer_lm,
    vgg16,
)

__all__ = ["alexnet", "googlenet", "graves_lstm_char_rnn", "lenet",
           "resnet50", "transformer_lm", "vgg16"]
