"""Dimensionality-reduction / plotting models (reference
``deeplearning4j-core/.../plot``).

Counterpart of ``deeplearning4j_tpu/plot``: exact t-SNE on the device
(``Tsne``) and Barnes-Hut t-SNE on the host (``BarnesHutTsne``)."""

from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne, Tsne

__all__ = ["BarnesHutTsne", "Tsne"]
