r"""Multi-objective utilities for two objectives: Pareto masks, reference
points, hypervolume and the 2-d box decompositions (counterpart of the m = 2
part of `botorch_tpu/utils/multi_objective.py`).

All quantities assume MAXIMIZATION, as the reference does. Everything is
batched over leading dims with fixed shapes: the staircase of a front is
padded with the reference point instead of shrinking, so the per-MC-sample
cell decompositions of qNEHVI are one batched tensor computation.

The m >= 3 decompositions (the Lacour local-upper-bound scans and their
native engine) are ROADMAP item 15b: `hypervolume` raises for them.
"""

from __future__ import annotations

import torch

from botorch_tpu_torch.utils.safe_math import maximum

Tensor = torch.Tensor


# --------------------------------------------------------------------------- #
# Pareto
# --------------------------------------------------------------------------- #
def is_non_dominated(Y: Tensor, deduplicate: bool = True) -> Tensor:
    """Boolean mask of the non-dominated points of `Y (..., n, m)`,
    maximization: `(..., n)`. With `deduplicate`, only the first of exact
    duplicates is kept."""
    n = Y.shape[-2]
    if n == 0:
        return torch.zeros(Y.shape[:-1], dtype=torch.bool, device=Y.device)
    Y1 = Y[..., :, None, :]
    Y2 = Y[..., None, :, :]
    dominates = torch.all(Y2 >= Y1, dim=-1) & torch.any(Y2 > Y1, dim=-1)
    dominated = torch.any(dominates, dim=-1)
    if deduplicate:
        dup = torch.all(Y1 == Y2, dim=-1)
        earlier = torch.ones((n, n), dtype=torch.bool, device=Y.device).tril(diagonal=-1)
        dominated = dominated | torch.any(dup & earlier, dim=-1)
    return ~dominated


def infer_reference_point(
    pareto_Y: Tensor,
    max_ref_point: Tensor | None = None,
    scale: float = 0.1,
    scale_max_ref_point: bool = False,
) -> Tensor:
    """Heuristic reference point of a front `(..., n, m)`: the nadir minus
    `scale` times the front's range. `max_ref_point` caps it where finite
    and better."""
    if pareto_Y.shape[-2] == 0:
        if max_ref_point is None:
            raise ValueError("empty front and no max_ref_point")
        return max_ref_point - scale * torch.abs(max_ref_point)
    ideal = torch.amax(pareto_Y, dim=-2)
    nadir = torch.amin(pareto_Y, dim=-2)
    rng = torch.where(ideal - nadir > 0, ideal - nadir, torch.abs(ideal) + 1e-8)
    ref = nadir - scale * rng
    if max_ref_point is not None:
        max_ref_point = torch.as_tensor(max_ref_point, dtype=ref.dtype, device=ref.device)
        better = max_ref_point < ref
        offset = scale * rng if scale_max_ref_point else 0.0
        ref = torch.where(torch.isfinite(max_ref_point) & better, max_ref_point - offset, ref)
    return ref


# --------------------------------------------------------------------------- #
# 2-d staircase machinery (batched, padded fixed shapes)
# --------------------------------------------------------------------------- #
def _pareto_staircase_2d(Y: Tensor, ref: Tensor) -> Tensor:
    """Sorted, padded 2-d Pareto staircase `(..., n, 2)`: Y with the
    dominated and not-above-`ref` points replaced by `ref`, sorted
    ascending (stably) in objective 0. Padding entries equal `ref` and have
    zero measure in every formula."""
    mask = is_non_dominated(Y) & torch.all(Y > ref, dim=-1)
    ys = torch.where(mask[..., None], Y, ref)
    order = torch.argsort(ys[..., 0], dim=-1, stable=True)
    return torch.take_along_dim(ys, order[..., None], dim=-2)


def hypervolume_2d(Y: Tensor, ref: Tensor) -> Tensor:
    """Exact 2-d hypervolume dominated by `Y (..., n, 2)` above `ref`:
    `(...)`."""
    ys = _pareto_staircase_2d(Y, ref)
    # ascending in f0, so f1 strictly descends along the true front;
    # padding at ref has zero width or zero height
    y0, y1 = ys[..., 0], ys[..., 1]
    prev0 = torch.cat([torch.broadcast_to(ref[..., :1], y0[..., :1].shape), y0[..., :-1]], dim=-1)
    width = maximum(y0 - prev0, 0.0)
    height = maximum(y1 - ref[..., 1:2], 0.0)
    return torch.sum(width * height, dim=-1)


def nondominated_hypercell_bounds_2d(Y: Tensor, ref: Tensor, clip_max: float = 1e10):
    """Partition of the region above `ref` that `Y (..., n, 2)` does NOT
    dominate into `n + 1` axis-aligned cells, batched with fixed shapes.

    With the staircase ascending in f0, cell k spans f0 from point k's f0
    (`ref` for k = 0) to `clip_max`, and f1 from point k + 1's f1 (`ref` for
    the last) to point k's f1 (`clip_max` for k = 0). Returns
    `(lower, upper): (..., n + 1, 2)`; empty cells have `upper = lower`."""
    ys = _pareto_staircase_2d(Y, ref)
    y0, y1 = ys[..., 0], ys[..., 1]
    ref0 = torch.broadcast_to(ref[..., 0], y0[..., 0].shape)
    ref1 = torch.broadcast_to(ref[..., 1], y0[..., 0].shape)
    left = torch.cat([ref0[..., None], y0], dim=-1)  # (..., n + 1)
    top = torch.cat([torch.full_like(ref1[..., None], clip_max), y1], dim=-1)
    bot = torch.cat([y1, ref1[..., None]], dim=-1)
    lower = torch.stack([left, bot], dim=-1)
    upper = torch.stack([torch.full_like(left, clip_max), top], dim=-1)
    return lower, torch.maximum(upper, lower)


def dominated_hypercell_bounds_2d(Y: Tensor, ref: Tensor):
    """Cells covering the region above `ref` that `Y (..., n, 2)` dominates:
    `(lower, upper): (..., n, 2)`."""
    ys = _pareto_staircase_2d(Y, ref)
    y0, y1 = ys[..., 0], ys[..., 1]
    ref0 = torch.broadcast_to(ref[..., 0, None], y0.shape)
    ref1 = torch.broadcast_to(ref[..., 1, None], y0.shape)
    prev0 = torch.cat([ref0[..., :1], y0[..., :-1]], dim=-1)
    lower = torch.stack([prev0, ref1], dim=-1)
    upper = torch.stack([y0, y1], dim=-1)
    return lower, torch.maximum(upper, lower)


def hypervolume(pareto_Y, ref_point) -> float:
    """Exact hypervolume (maximization) of a point set above `ref_point`,
    for two objectives. Dominated and not-above-`ref` points add nothing."""
    Y = torch.as_tensor(pareto_Y)
    if Y.shape[-1] != 2:
        raise NotImplementedError(
            f"hypervolume of {Y.shape[-1]} objectives needs the m >= 3 box "
            "decompositions, which come with ROADMAP item 15b"
        )
    ref = torch.as_tensor(ref_point, dtype=Y.dtype, device=Y.device)
    return float(hypervolume_2d(Y, ref))
