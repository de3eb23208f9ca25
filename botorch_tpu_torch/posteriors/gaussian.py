r"""Gaussian posterior (counterpart of `botorch_tpu/posteriors/gaussian.py`).

Shapes follow BoTorch: `mean` is `batch x q x m`, `cov` is
`batch x m x q x q` (outputs independent, joint over q). Reparameterized
sampling comes with the Monte-Carlo acquisitions of a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from botorch_tpu_torch.utils.safe_math import maximum

Tensor = torch.Tensor


@dataclass(frozen=True)
class GaussianPosterior:
    """Joint Gaussian posterior over `q` points and `m` independent outputs."""

    mean: Tensor  # (..., q, m)
    cov: Tensor  # (..., m, q, q)

    @property
    def variance(self) -> Tensor:  # (..., q, m)
        v = torch.diagonal(self.cov, dim1=-2, dim2=-1)  # (..., m, q)
        return maximum(v.transpose(-1, -2), 0.0)

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.mean.shape[:-2])

    @property
    def q(self) -> int:
        return self.mean.shape[-2]

    @property
    def num_outputs(self) -> int:
        return self.mean.shape[-1]

    def affine(self, loc: Tensor, scale: Tensor) -> "GaussianPosterior":
        """Per-output affine map `y -> loc + scale * y` (outcome
        de-standardization)."""
        mean = self.mean * scale + loc
        cov = self.cov * torch.square(torch.atleast_1d(scale))[..., :, None, None]
        return GaussianPosterior(mean=mean, cov=cov)
