r"""Numerics and device policy of the PyTorch port.

* float32 is the default dtype; float64 is opt-in through the `dtype`
  argument of the entry points.
* Every float32 contraction runs in full float32: TF32 is switched off for
  matrix products and cuDNN, and the float32 matmul precision is
  "highest". The JAX package pins `Precision.HIGHEST` in its kernel
  matrix, `Kinv` and posterior contractions for the same reason
  (`botorch_tpu/ops/pallas_linalg.py`, `botorch_tpu/models/gp.py`).
* The default device is CUDA. An entry point given no device runs on the
  card, and raises when there is none: nothing moves to the CPU quietly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DTYPE = torch.float32

DeviceLike = Union[str, torch.device, None]


def apply_precision_policy() -> None:
    """Full-float32 contractions on the card (no TF32 anywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises if CUDA is asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "botorch_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU."
        )
    return dev


def resolve_dtype(dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """float32 unless the caller opts into another floating dtype."""
    dtype = DEFAULT_DTYPE if dtype is None else dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    return dtype


def make_generator(seed: int, device: DeviceLike) -> torch.Generator:
    """A `torch.Generator` on `device`, seeded from an integer. The port
    draws every random number from such an explicit generator."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen
