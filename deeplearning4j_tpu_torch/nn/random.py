"""A counter-based generator that draws the JAX package's bits.

Counterpart of the ``jax.random`` calls that the layers and engines of
the JAX package make (``PRNGKey``, ``fold_in``, ``split``,
``random_bits``, ``uniform``, ``bernoulli``, ``normal``) under JAX's
default threefry2x32 generator with ``jax_threefry_partitionable`` on.
Threefry-2x32 (20 rounds) runs in ``int64`` arithmetic masked to 32
bits, so the same seed, iteration and layer index give the JAX
package's masks and samples bit for bit (``normal`` to within its
``erfinv``: see there).

A key is two 32-bit words. It lives either in a 2-element ``int64``
tensor (``key(seed, device)``; every function below is then plain torch
on the key's device, with no host state, so a CUDA graph can capture
it) or in a ``(hi, lo)`` pair of Python ints (the host form: the eager
step derives its keys there, which costs no device launch). Both forms
give the same words, and ``bits`` takes either.

``bits`` hashes the flat index of each element, split into a high and a
low word, and returns ``x0 ^ x1`` of the output pair; ``offset`` is the
flat index of the first element, so a data-parallel rank that holds
rows ``[r0, r1)`` of a global shape draws exactly those rows of the
global draw (``row_window``).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import torch

Key = Union[torch.Tensor, Tuple[int, int]]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (JAX ``threefry2x32_p``) on words
    held as Python ints or ``int64`` tensors (broadcasting); returns the
    output pair."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def host_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` in the host form: a seed in the
    int32 range gives ``(0, seed mod 2**32)``, as JAX's 32-bit seeds."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & _MASK
    return hi, seed & _MASK


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a 2-element ``int64`` tensor on
    ``device`` (the CPU by default)."""
    return torch.tensor(host_key(seed), dtype=torch.int64, device=device)


def _words(k: Key):
    if torch.is_tensor(k):
        return k[0], k[1]
    return int(k[0]), int(k[1])


def fold_in(k: Key, data) -> Key:
    """``jax.random.fold_in(k, data)``: ``data`` (a Python int or a 0-d
    integer tensor) is taken mod 2**32. Host key and int data give a
    host key; anything on a device gives a 2-element tensor there."""
    k0, k1 = _words(k)
    if torch.is_tensor(data):
        data = data.to(torch.int64) & _MASK
    else:
        data = int(data) & _MASK
    y0, y1 = threefry2x32(k0, k1, 0, data)
    if torch.is_tensor(y0) or torch.is_tensor(y1):
        return torch.stack([torch.as_tensor(y0), torch.as_tensor(y1)]
                           ).reshape(2)
    return y0, y1


def split(k: Key, n: int) -> list:
    """``jax.random.split(k, n)`` as a list of ``n`` keys in ``k``'s
    form: under the partitionable threefry key ``i`` is the output pair
    of counter ``i``, which is ``fold_in(k, i)``."""
    return [fold_in(k, i) for i in range(int(n))]


def bits(k: Key, shape: Sequence[int], offset: int = 0,
         device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32 words, held in ``int64``)
    for the elements at flat indices ``offset ..`` of the draw, on the
    key's device (or ``device`` for a host key)."""
    if torch.is_tensor(k):
        device = k.device
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    k0, k1 = _words(k)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return (y0 ^ y1).reshape(tuple(int(d) for d in shape))


def uniform(k: Key, shape: Sequence[int], offset: int = 0,
            device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, minval=, maxval=)`` in f32: the
    top 23 bits as the mantissa of a float in ``[1, 2)``, minus one,
    then ``max(minval, u * (maxval - minval) + minval)`` (skipped for
    ``[0, 1)``, where it is the identity). XLA fuses that product and
    sum into one fused multiply-add; it is taken here in f64 (the
    product exact) and rounded once to f32, which is the fused result
    but for a double rounding of odds about 2**-29 an element."""
    b = bits(k, shape, offset, device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return f
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    fused = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


def bernoulli(k: Key, p, shape: Optional[Sequence[int]] = None,
              offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)``: a bool tensor, True where
    the f32 uniform is below ``p``. ``p`` is a float (taken in f32) or
    a tensor of probabilities (its shape the default ``shape``, its
    device the draw's), as the RBM samples its units."""
    if torch.is_tensor(p):
        shape = tuple(p.shape) if shape is None else shape
        return uniform(k, shape, offset, p.device) < p
    return uniform(k, shape, offset, device) < float(p)


# the lower end of JAX's normal draw: nextafter(-1, 0) in f32
_NORMAL_LO = -0.99999994039535522
_SQRT2_F32 = 1.4142135381698608


def normal(k: Key, shape: Sequence[int], offset: int = 0,
           device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` in f32: ``sqrt(2) *
    erfinv(uniform(k, shape, nextafter(-1, 0), 1))``. The uniform is JAX's
    bit for bit; ``torch.erfinv`` is not XLA's polynomial, so a sample
    may differ from JAX's in its last bits, most in the tails: within
    1e-5 absolute plus 1e-5 relative on the CPU
    (``tests/test_torch_pretrain.py``)."""
    u = uniform(k, shape, offset, device, minval=_NORMAL_LO, maxval=1.0)
    return torch.erfinv(u) * _SQRT2_F32


# --- the data-parallel row window -------------------------------------------

_window: Optional[Tuple[int, int]] = None


@contextlib.contextmanager
def row_window(row0: int, rows: int):
    """Within the block, a row-indexed draw (``row_offset``) is this
    process's rows ``[row0, row0 + rows)`` of the global batch: a
    data-parallel rank draws its rows of the global mask."""
    global _window
    prev, _window = _window, (int(row0), int(rows))
    try:
        yield
    finally:
        _window = prev


def row_offset(shape: Sequence[int]) -> int:
    """The flat offset of a batch-major activation of ``shape`` inside
    the global draw under ``row_window`` (0 outside one): the rows
    before this process's, times the elements a row (a preprocessor may
    have folded time into the rows; the batch stays outermost)."""
    if _window is None:
        return 0
    row0, rows = _window
    n = 1
    for d in shape:
        n *= int(d)
    return row0 * (n // rows)
