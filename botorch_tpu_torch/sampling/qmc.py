r"""Quasi-MC normal engines (counterpart of `botorch_tpu/sampling/qmc.py`):
scrambled-Sobol points mapped to (multivariate) Gaussians through the
inverse normal CDF, which keeps the points' stratification (Box-Muller
pairs dimensions and scrambles it).
"""

from __future__ import annotations

from typing import Optional

import torch

from botorch_tpu_torch.ops.chol import psd_safe_cholesky
from botorch_tpu_torch.sampling.sobol import draw_sobol, sobol_table
from botorch_tpu_torch.settings import resolve_device

Tensor = torch.Tensor


class NormalQMCEngine:
    """Draws qMC `N(0, I_d)` samples on `device` (CUDA unless given);
    successive draws continue one sequence."""

    def __init__(self, d: int, seed: Optional[int] = None, scramble: bool = True, device=None):
        self.d = d
        self._sv, self._shift = sobol_table(
            d, scramble=scramble, seed=seed, device=resolve_device(device)
        )
        self._skip = 0

    def draw(self, n: int) -> Tensor:
        u = draw_sobol(self._sv, self._shift, n, skip=self._skip)
        self._skip += n
        return torch.special.ndtri(u)


class MultivariateNormalQMCEngine(NormalQMCEngine):
    """qMC draws from `N(mean, cov)` through the Cholesky factor of `cov`."""

    def __init__(self, mean: Tensor, cov: Tensor, seed: Optional[int] = None,
                 scramble: bool = True):
        super().__init__(mean.shape[-1], seed=seed, scramble=scramble, device=mean.device)
        self._mean = mean
        self._L = psd_safe_cholesky(cov)

    def draw(self, n: int) -> Tensor:
        z = super().draw(n).to(self._L.dtype)
        return self._mean + z @ self._L.T
