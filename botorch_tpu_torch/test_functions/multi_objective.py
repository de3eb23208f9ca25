r"""Multi-objective test problems (counterpart of
`botorch_tpu/test_functions/multi_objective.py`): BraninCurrin.

Each objective is MINIMIZED, as in the reference; `negate=True` flips all
of them to maximization, and `ref_point` with them. `max_hv` is the
reference's table value. `__call__` takes `X (..., d)` and returns
`(..., m)`. ZDT, DTLZ and the other problems come with ROADMAP items 15b
(DTLZ2) and 19.
"""

from __future__ import annotations

import torch

from botorch_tpu_torch.test_functions.synthetic import Branin, SyntheticTestFunction

Tensor = torch.Tensor


class MultiObjectiveTestProblem(SyntheticTestFunction):
    num_objectives: int
    _ref_point: list[float]
    _max_hv: float | None = None

    @property
    def ref_point(self) -> Tensor:
        r = torch.tensor(self._ref_point, dtype=torch.float32)
        return -r if self.negate else r

    @property
    def max_hv(self) -> float:
        if self._max_hv is None:
            raise NotImplementedError
        return self._max_hv


class BraninCurrin(MultiObjectiveTestProblem):
    """Branin and Currin on [0, 1]^2."""

    dim = 2
    num_objectives = 2
    _bounds = [(0.0, 1.0), (0.0, 1.0)]
    _ref_point = [18.0, 6.0]
    _max_hv = 59.36011874867746
    _optimal_value = float("nan")

    def evaluate_true(self, X: Tensor) -> Tensor:
        x0, x1 = X[..., 0], X[..., 1]
        # Branin on the rescaled inputs
        branin = Branin().evaluate_true(torch.stack([15.0 * x0 - 5.0, 15.0 * x1], dim=-1))
        num = 2300 * x0**3 + 1900 * x0**2 + 2092 * x0 + 60
        den = 100 * x0**3 + 500 * x0**2 + 4 * x0 + 20
        # Currin's factor tends to 1 as x1 -> 0; the guard keeps x1 = 0 finite
        safe_x1 = torch.where(x1 > 0, x1, torch.ones_like(x1))
        currin = torch.where(
            x1 > 0, (1.0 - torch.exp(-1.0 / (2.0 * safe_x1))) * num / den, num / den
        )
        return torch.stack([branin, currin], dim=-1)
