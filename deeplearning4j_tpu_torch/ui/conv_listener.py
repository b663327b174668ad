"""Convolutional activation visualization (reference
``ConvolutionalIterationListener`` + ``ConvolutionalListenerModule`` —
renders each conv layer's activation maps for one example as an image
grid in the training UI).

Counterpart of ``deeplearning4j_tpu/ui/conv_listener.py``. Every
``frequency`` iterations the listener re-runs the forward pass on the
model's device for the first example of the net's last minibatch (the
``_last_features`` snapshot the engines keep while a listener
``needs_last_features``), brings the [1, C, H, W] activations to the
host in one pass, tiles each layer's maps into one grayscale grid
(``_tile_grid``), PNG-encodes it with the standard library alone
(``png_gray``: no imaging package) and hands it to the UIServer, which
serves it at ``/train/activations``.
"""

from __future__ import annotations

import base64
import logging
import struct
import zlib
from typing import Dict

import numpy as np

from deeplearning4j_tpu_torch.observability.metrics import host_arrays
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener

logger = logging.getLogger(__name__)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _tile_grid(act: np.ndarray, pad: int = 1) -> np.ndarray:
    """[C, H, W] -> one [gh*H', gw*W'] uint8 grid, channels tiled
    near-square, each map min-max normalized."""
    c, h, w = act.shape
    gw = int(np.ceil(np.sqrt(c)))
    gh = int(np.ceil(c / gw))
    out = np.zeros((gh * (h + pad) + pad, gw * (w + pad) + pad),
                   np.uint8)
    for i in range(c):
        a = act[i]
        lo, hi = float(a.min()), float(a.max())
        norm = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
        r, col = divmod(i, gw)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        out[y:y + h, x:x + w] = (norm * 255).astype(np.uint8)
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    """One PNG chunk: length, type, data, CRC-32 of type and data."""
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_gray(grid: np.ndarray) -> bytes:
    """A [H, W] uint8 grid as an 8-bit grayscale PNG: the signature, an
    IHDR (colour type 0, no interlace), one zlib-compressed IDAT of
    filter-0 scanlines, and IEND."""
    grid = np.ascontiguousarray(grid, np.uint8)
    if grid.ndim != 2:
        raise ValueError(f"a grayscale grid is 2-d, got {grid.shape}")
    h, w = grid.shape
    rows = np.zeros((h, w + 1), np.uint8)  # a 0 filter byte a scanline
    rows[:, 1:] = grid
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _png_b64(grid: np.ndarray) -> str:
    return base64.b64encode(png_gray(grid)).decode()


class ConvolutionalIterationListener(IterationListener):
    """Every ``frequency`` iterations, publish conv activation grids
    for one example to the UI server (reference
    ``ConvolutionalIterationListener.java``)."""

    supports_batched_iterations = True  # grids are per-snapshot anyway
    needs_last_features = True  # nets snapshot the batch for us

    def __init__(self, ui_server=None, frequency: int = 10):
        self.ui_server = ui_server
        self.frequency = max(int(frequency), 1)
        self.last_grids: Dict[str, str] = {}

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency != 0:
            return
        x = getattr(model, "_last_features", None)
        if x is None:
            return
        try:
            acts = model.feed_forward(x[:1])
        except Exception:  # a listener must not stop the fit
            logger.warning("conv activation forward failed", exc_info=True)
            return
        names = getattr(model, "layer_names", [])
        # [1, C, H, W] conv activations, read back in one pass
        maps = {str(name): act[0] for name, act in zip(names, acts)
                if act.dim() == 4}
        grids: Dict[str, str] = {
            name: _png_b64(_tile_grid(a))
            for name, a in host_arrays({"": maps})[""].items()}
        if grids:
            self.last_grids = grids
            if self.ui_server is not None:
                self.ui_server.set_activations(grids)
