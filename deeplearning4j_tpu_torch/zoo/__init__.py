from deeplearning4j_tpu_torch.zoo.models import (
    alexnet,
    graves_lstm_char_rnn,
    lenet,
    transformer_lm,
)

__all__ = ["alexnet", "graves_lstm_char_rnn", "lenet", "transformer_lm"]
