from deeplearning4j_tpu_torch.resilience.deadline import Deadline

__all__ = ["Deadline"]
