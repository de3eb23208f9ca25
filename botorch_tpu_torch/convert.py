r"""Carry GP hyperparameters between the JAX package and the port.

Parameters cross as a dict of numpy arrays keyed by the `GPParams` field
names, so neither package imports the other (an ensemble's leading `(S,)`
dim crosses with them). NUTS state crosses the same way: the adaptation
(step size, `chol_cov`) and the thinned unconstrained draws. The
flat-vector helpers keep `jax.flatten_util.ravel_pytree`'s order of the
JAX `GPParams` fields (mean, raw_lengthscale, raw_outputscale,
raw_noise), with any leading batch dims kept in front of the flat axis.
An SVGP crosses as `{field: numpy array}` of its tensor fields, and a
TuRBO state as the arrays of its five tensor fields.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from botorch_tpu_torch.models.gp import GPParams

Tensor = torch.Tensor


def gp_params_from_numpy(arrays: dict, dtype=torch.float32, device="cpu") -> GPParams:
    """`GPParams` from `{field: numpy array}`. A `raw_kernel_weights` entry
    must be absent or None: composite kernels are not ported yet."""
    if arrays.get("raw_kernel_weights") is not None:
        raise NotImplementedError("kernel weights are not part of the port yet")
    return GPParams(
        *(torch.as_tensor(np.asarray(arrays[f]), dtype=dtype, device=device)
          for f in GPParams.FIELDS)
    )


def gp_params_to_numpy(params: GPParams) -> dict:
    """`{field: numpy array}` of a `GPParams`."""
    return {f: getattr(params, f).detach().cpu().numpy() for f in GPParams.FIELDS}


def flatten_params(params: GPParams, batch_dims: int = 0) -> Tensor:
    """Concatenate the fields into `(*batch, k)` in ravel order; the first
    `batch_dims` dims of every field are batch dims."""
    parts = []
    for f in GPParams.FIELDS:
        t = getattr(params, f)
        parts.append(t.reshape(*t.shape[:batch_dims], -1))
    return torch.cat(parts, dim=-1)


def unflatten_params(flat: Tensor, like: GPParams) -> GPParams:
    """Inverse of `flatten_params` for unbatched `like`: `flat (..., k)`
    becomes fields of shape `(..., *field_shape)`."""
    lead = flat.shape[:-1]
    fields, off = [], 0
    for f in GPParams.FIELDS:
        shape = getattr(like, f).shape
        size = math.prod(shape)
        fields.append(flat[..., off:off + size].reshape(*lead, *shape))
        off += size
    if off != flat.shape[-1]:
        raise ValueError(f"flat vector has {flat.shape[-1]} entries, params need {off}")
    return GPParams(*fields)


def nuts_adaptation_from_numpy(step_size, chol_cov, dtype=torch.float32, device="cpu") -> dict:
    """`{"step_size": 0-d, "chol_cov": (k, k)}` tensors of a NUTS
    adaptation (the JAX `run_nuts`'s `step_size` and dense mass factor)."""
    kw = dict(dtype=dtype, device=device)
    return {"step_size": torch.as_tensor(np.asarray(step_size), **kw).reshape(()),
            "chol_cov": torch.as_tensor(np.asarray(chol_cov), **kw)}


def saas_draws_from_numpy(z_samples, dtype=torch.float32, device="cpu") -> Tensor:
    """Thinned unconstrained SAAS draws `(S, k)`, chain-major, for
    `models.fully_bayesian.load_saas_samples`."""
    z = torch.as_tensor(np.asarray(z_samples), dtype=dtype, device=device)
    if z.ndim != 2:
        raise ValueError(f"SAAS draws are (S, k), got shape {tuple(z.shape)}")
    return z


def svgp_from_numpy(arrays: dict, kernel: str = "matern52", learn_inducing: bool = True,
                    dtype=torch.float32, device="cpu"):
    """`SVGP` from `{field: numpy array}` of its tensor fields
    (`SVGP.FIELDS`, the JAX `SVGP`'s field names)."""
    from botorch_tpu_torch.models.approximate_gp import SVGP

    return SVGP(
        **{f: torch.as_tensor(np.array(arrays[f]), dtype=dtype, device=device)
           for f in SVGP.FIELDS},
        kernel=kernel, learn_inducing=learn_inducing,
    )


def svgp_to_numpy(model) -> dict:
    """`{field: numpy array}` of an `SVGP`'s tensor fields."""
    return {f: getattr(model, f).detach().cpu().numpy() for f in type(model).FIELDS}


TURBO_STATE_FIELDS = ("length", "success_counter", "failure_counter", "best_value",
                      "restart_triggered")


def turbo_state_from_numpy(arrays: dict, dtype=torch.float32, device="cpu", **kwargs):
    """`TurboState` from `{field: numpy array}` of its five tensor fields;
    `kwargs` sets its static fields (`length_min`, `success_streak`, ...)."""
    from botorch_tpu_torch.optim.turbo import TurboState

    dtypes = {"success_counter": torch.int32, "failure_counter": torch.int32,
              "restart_triggered": torch.bool}
    return TurboState(
        **{f: torch.as_tensor(np.array(arrays[f]), dtype=dtypes.get(f, dtype),
                              device=device).reshape(())
           for f in TURBO_STATE_FIELDS},
        **kwargs,
    )
