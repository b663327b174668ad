from deeplearning4j_tpu_torch.zoo.models import alexnet, lenet

__all__ = ["alexnet", "lenet"]
