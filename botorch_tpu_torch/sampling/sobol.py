r"""Scrambled Sobol sequence (counterpart of
`botorch_tpu/sampling/sobol.py`), bit-exact with the JAX package.

The Joe & Kuo direction-number data come from scipy's bundled table
(`scipy/stats/_sobol_direction_numbers.npz`). The 32-bit direction matrix
and the scramble (linear matrix scramble + digital shift, drawn from a
numpy generator seeded with `seed`) are built once on the host with the
same numpy code as the reference, so both packages hold identical tables.
Point generation is Gray-code XOR folding on the device. PyTorch has no
`>>` for `uint32` on every backend, so the bits live in int64 and every
step is masked with `0xFFFFFFFF`.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from botorch_tpu_torch.settings import resolve_device

Tensor = torch.Tensor

MAXDIM = 21201
_NBITS = 32
_MASK32 = 0xFFFFFFFF


def _direction_data():
    import scipy.stats

    path = os.path.join(
        os.path.dirname(scipy.stats.__file__), "_sobol_direction_numbers.npz"
    )
    data = np.load(path)
    return data["poly"], data["vinit"]


@functools.lru_cache(maxsize=8)
def _direction_numbers(dimension: int) -> np.ndarray:
    """Full (dimension, 32) uint32 direction-number matrix `V[j, k] =
    v_{k+1} * 2^32` from the Joe & Kuo recurrence."""
    if not 1 <= dimension <= MAXDIM:
        raise ValueError(f"dimension must be in [1, {MAXDIM}], got {dimension}")
    poly, vinit = _direction_data()
    V = np.zeros((dimension, _NBITS), dtype=np.uint64)
    V[0] = 1  # first dimension: van der Corput (all m_k = 1)
    for j in range(1, dimension):
        p = int(poly[j])
        s = p.bit_length() - 1
        a = [(p >> (s - 1 - i)) & 1 for i in range(1, s)]
        m = [int(v) for v in vinit[j, :s]]
        for k in range(s, _NBITS):
            new = (m[k - s] << s) ^ m[k - s]
            for i in range(1, s):
                if a[i - 1]:
                    new ^= m[k - i] << i
            m.append(new)
        V[j] = np.asarray(m, dtype=np.uint64)
    shifts = (_NBITS - 1 - np.arange(_NBITS)).astype(np.uint64)
    return (V << shifts[None, :]).astype(np.uint32)


def _scramble_directions(
    V: np.ndarray, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Random lower-triangular GF(2) matrix scramble of the direction
    numbers and a random digital shift (host side, once)."""
    d = V.shape[0]
    digits = (V[:, :, None] >> (31 - np.arange(_NBITS))[None, None, :]) & 1
    L = np.tril(rng.integers(0, 2, size=(d, _NBITS, _NBITS), dtype=np.uint32), -1)
    L |= np.eye(_NBITS, dtype=np.uint32)[None]
    new_digits = np.einsum("jrc,jkc->jkr", L, digits) & 1
    place = (31 - np.arange(_NBITS, dtype=np.uint64))[None, None, :]
    sv = (new_digits.astype(np.uint64) << place).sum(axis=-1).astype(np.uint32)
    shift = rng.integers(0, 1 << 32, size=(d,), dtype=np.uint64).astype(np.uint32)
    return sv, shift


def sobol_table(
    dimension: int,
    scramble: bool = True,
    seed: Optional[int] = None,
    device=None,
) -> tuple[Tensor, Tensor]:
    """The (direction numbers (d, 32), digital shift (d,)) tables of a
    `dimension`-dim engine, as int64 tensors holding uint32 values."""
    V = _direction_numbers(dimension)
    if scramble:
        rng = np.random.default_rng(0 if seed is None else seed)
        sv, shift = _scramble_directions(V, rng)
    else:
        sv, shift = V, np.zeros((dimension,), np.uint32)
    return (
        torch.as_tensor(sv.astype(np.int64), device=device),
        torch.as_tensor(shift.astype(np.int64), device=device),
    )


def draw_sobol_bits(sv: Tensor, shift: Tensor, n: int, skip: int = 0) -> Tensor:
    """`n` Sobol points as 32-bit integers in int64, shape `(n, d)`,
    starting at index `skip` (taken modulo 2^32, as the reference's uint32
    arithmetic does)."""
    idx = (torch.arange(n, dtype=torch.int64, device=sv.device) + int(skip)) & _MASK32
    gray = idx ^ (idx >> 1)
    k = torch.arange(_NBITS, dtype=torch.int64, device=sv.device)
    bits = (gray[:, None] >> k[None, :]) & 1  # (n, 32)
    acc = (bits * _MASK32)[:, None, :] & sv[None, :, :]  # (n, d, 32)
    width = _NBITS
    while width > 1:
        width //= 2
        acc = acc[..., :width] ^ acc[..., width:]
    return acc[..., 0] ^ shift[None, :]


def bits_to_unit(bits: Tensor, dtype=torch.float32) -> Tensor:
    """Map 32-bit Sobol integers to floats strictly inside (0, 1)."""
    return ((bits >> 8).to(dtype) + 0.5) * (2.0**-24)


def draw_sobol(
    sv: Tensor, shift: Tensor, n: int, skip: int = 0, dtype=torch.float32
) -> Tensor:
    """`n` points of the scrambled Sobol sequence in `(0, 1)^d`."""
    return bits_to_unit(draw_sobol_bits(sv, shift, n, skip), dtype=dtype)


def draw_sobol_samples(
    bounds: Tensor, n: int, q: int, seed: Optional[int] = None
) -> Tensor:
    """`n x q x d` Sobol points scaled to the box `bounds` (2 x d); one
    scrambled engine over `q * d` dims, so q-batches are jointly
    low-discrepancy."""
    d = bounds.shape[-1]
    sv, shift = sobol_table(q * d, scramble=True, seed=seed, device=bounds.device)
    pts = draw_sobol(sv, shift, n, dtype=bounds.dtype).reshape(n, q, d)
    return bounds[0] + (bounds[1] - bounds[0]) * pts


def draw_sobol_normal_samples(
    d: int, n: int, seed: Optional[int] = None, dtype=torch.float32, device=None
) -> Tensor:
    """`n x d` standard-normal qMC samples on `device` (CUDA unless given):
    scrambled Sobol points through the inverse normal CDF."""
    sv, shift = sobol_table(d, scramble=True, seed=seed, device=resolve_device(device))
    return torch.special.ndtri(draw_sobol(sv, shift, n, dtype=dtype))
