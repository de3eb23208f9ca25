r"""Kernel K1: batched MVN quadratic form and log-determinant.

Counterpart of `botorch_tpu/ops/pallas_linalg.py`, whose Pallas TPU kernel
`_qd_pallas` this replaces. The CUDA source is `csrc/mvn_quad_logdet.cu`
(its header says what bounds it on an H100 and how its design answers
that).

Public op: `mvn_quad_logdet(K, r) -> (quad, logdet)` with
`quad = r^T K^-1 r` and `logdet = log|K|` for `K: (..., n, n)` PSD
(pre-jittered) and `r: (..., n)`. Differentiable through a closed-form
backward (`dK = g_ld K^-1 - g_quad a a^T`, `dr = 2 g_quad a`, `a = K^-1 r`):
no factorization in the backward pass.

* n <= 64: leading dims are flattened into one batch and the batch goes to
  K1, which returns `(quad, logdet, alpha, Kinv)`: the kernel forms
  `Kinv = L^-T L^-1` itself, as `_qd_pallas` returns it. `qd_cuda` launches
  the kernel (`qd_cuda.launches` counts launches) with the launch shape of
  `k1_launch`; `qd_plain` is its plain PyTorch version, the CPU path and the
  reference the kernel is held to. A CUDA tensor launches the kernel or
  raises.
* n > 64: `_QdLarge`, one library factorization in the forward and the same
  closed-form backward (the JAX package runs this path in XLA, not Pallas).
"""

from __future__ import annotations

import ctypes

import torch

from botorch_tpu_torch.ops import cuda_build
from botorch_tpu_torch.ops.chol import cholesky_nan

Tensor = torch.Tensor

MAX_N = 64  # the kernel holds one matrix per block of 32 or 64 threads in shared memory
CHUNK = 16  # columns per chunk of the kernel's inner loops (`kChunk` in the source)
_FNS: dict = {}


def k1_launch(B: int, n: int, dtype: torch.dtype) -> dict:
    """K1's launch shape for `B` matrices of size `n` in `dtype`.

    One block of 32 threads (n <= 32) or 64 threads (n > 32) per matrix,
    thread t owning row t; an SM runs up to 32 such blocks at once, so a
    large batch needs no packing of matrices into one block. A matrix holds
    2 (n + 1) + 6 rows of `ld` elements in shared memory (L, X^T = L^-T,
    and six vectors). `ld` is at least n + 15, so the kernel's chunks of 16
    columns stay inside a row, and `ld` times the element size is 16 bytes
    times an odd number, so 16-byte loads of the threads' own rows fall in
    distinct banks. Above 48 KB a block the kernel opts into more shared
    memory (89,216 bytes for a float64 matrix of n = 64)."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"K1 takes 1 <= n <= {MAX_N}, got n = {n}")
    per_vec = 16 // dtype.itemsize  # elements in 16 bytes
    ld = n + CHUNK - 1
    while ld % (2 * per_vec) != per_vec:
        ld += 1
    return {
        "threads_per_matrix": 32 if n <= 32 else 64,
        "blocks": B,
        "ld": ld,
        "smem_bytes": (2 * (n + 1) + 6) * ld * dtype.itemsize,
    }


def tril_inverse(L: Tensor) -> Tensor:
    """`L^-1` for lower-triangular `L (..., n, n)`: a triangular solve
    against the identity (the JAX package's `_blocked_tril_inverse` works
    around an XLA-on-TPU memory limit that PyTorch does not have)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def qd_plain(K: Tensor, r: Tensor):
    """Plain PyTorch version of K1. `K (B, n, n)`, `r (B, n)` ->
    `(quad (B,), logdet (B,), alpha (B, n), Kinv (B, n, n))`; a matrix that
    does not factor gives NaN, as the kernel's rsqrt of a bad pivot does."""
    L = cholesky_nan(K)
    w = torch.linalg.solve_triangular(L, r[..., None], upper=False)
    alpha = torch.linalg.solve_triangular(L.transpose(-1, -2), w, upper=True)[..., 0]
    w = w[..., 0]
    quad = torch.sum(w * w, dim=-1)
    ld = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    Linv = tril_inverse(L)
    return quad, ld, alpha, torch.matmul(Linv.transpose(-1, -2), Linv)


def _functions():
    if not _FNS:
        lib = cuda_build.load("mvn_quad_logdet")
        for dtype, fn in (
            (torch.float32, lib.bt_mvn_qd_f32),
            (torch.float64, lib.bt_mvn_qd_f64),
        ):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _FNS[dtype] = fn
    return _FNS


def qd_cuda(K: Tensor, r: Tensor):
    """Launch K1 on CUDA tensors `K (B, n, n)`, `r (B, n)`, n <= 64; the
    same outputs as `qd_plain`."""
    if K.device.type != "cuda" or r.device != K.device:
        raise ValueError("K1 needs K and r on one CUDA device")
    if K.dtype not in (torch.float32, torch.float64) or r.dtype != K.dtype:
        raise TypeError(f"K1 takes float32 or float64 K and r, got {K.dtype}, {r.dtype}")
    if K.ndim != 3 or K.shape[-1] != K.shape[-2] or r.shape != K.shape[:2]:
        raise ValueError(f"K1 needs K (B, n, n) and r (B, n), got {K.shape}, {r.shape}")
    B, n = r.shape
    shape = k1_launch(B, n, K.dtype)
    K = K.contiguous()
    r = r.contiguous()
    quad = torch.empty((B,), dtype=K.dtype, device=K.device)
    logdet = torch.empty_like(quad)
    alpha = torch.empty((B, n), dtype=K.dtype, device=K.device)
    kinv = torch.empty((B, n, n), dtype=K.dtype, device=K.device)
    if B == 0:
        return quad, logdet, alpha, kinv
    fn = _functions()[K.dtype]
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        status = fn(
            K.data_ptr(), r.data_ptr(), quad.data_ptr(), logdet.data_ptr(),
            alpha.data_ptr(), kinv.data_ptr(), B, n, shape["threads_per_matrix"],
            shape["ld"], stream,
        )
    cuda_build.check(status, "mvn_quad_logdet")
    qd_cuda.launches += 1
    return quad, logdet, alpha, kinv


qd_cuda.launches = 0


def _qd_core(K: Tensor, r: Tensor):
    """`(quad, logdet, alpha, Kinv)` for `K (B, n, n)`, `r (B, n)`."""
    if K.device.type == "cpu":
        return qd_plain(K, r)
    if K.device.type == "cuda":
        return qd_cuda(K, r)
    raise ValueError(f"K1 runs on CPU or CUDA tensors, got {K.device}")


def _closed_form_grads(alpha, kinv, g_quad, g_ld):
    outer = alpha[..., :, None] * alpha[..., None, :]
    dK = g_ld[..., None, None] * kinv - g_quad[..., None, None] * outer
    dr = 2.0 * g_quad[..., None] * alpha
    return dK, dr


class _MvnQuadLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, r):
        quad, ld, alpha, kinv = _qd_core(K, r)
        ctx.save_for_backward(alpha, kinv)
        return quad, ld

    @staticmethod
    def backward(ctx, g_quad, g_ld):
        alpha, kinv = ctx.saved_tensors
        return _closed_form_grads(alpha, kinv, g_quad, g_ld)


class _QdLarge(torch.autograd.Function):
    """n > 64: one factorization forward; `K^-1` from the saved factor in
    the backward only."""

    @staticmethod
    def forward(ctx, K, r):
        L = cholesky_nan(K)
        w = torch.linalg.solve_triangular(L, r[..., None], upper=False)
        quad = torch.sum(w[..., 0] * w[..., 0], dim=-1)
        ld = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        alpha = torch.linalg.solve_triangular(L.transpose(-1, -2), w, upper=True)[..., 0]
        ctx.save_for_backward(L, alpha)
        return quad, ld

    @staticmethod
    def backward(ctx, g_quad, g_ld):
        L, alpha = ctx.saved_tensors
        Linv = tril_inverse(L)
        kinv = torch.matmul(Linv.transpose(-1, -2), Linv)
        return _closed_form_grads(alpha, kinv, g_quad, g_ld)


def mvn_quad_logdet_parts(K: Tensor, r: Tensor):
    """`(quad, logdet, alpha, Kinv)` of `K (..., n, n)`, `r (..., n)`, with
    no autograd: K1's four outputs for n <= 64 (the plain version above),
    for callers that form the gradient themselves (`dquad/dK = -alpha
    alpha^T`, `dlogdet/dK = Kinv`, `dquad/dr = 2 alpha`)."""
    batch = K.shape[:-2]
    n = K.shape[-1]
    Kb = K.reshape(-1, n, n)
    rb = r.expand(*batch, n).reshape(-1, n)
    outs = qd_plain(Kb, rb) if n > MAX_N else _qd_core(Kb, rb)
    return tuple(o.reshape(*batch, *o.shape[1:]) for o in outs)


def mvn_quad_logdet(K: Tensor, r: Tensor) -> tuple[Tensor, Tensor]:
    r"""`(r^T K^-1 r, log|K|)` for PSD `K: (..., n, n)` and `r: (..., n)`.

    `K` must already include noise and jitter on its diagonal. This is the
    primitive under every exact-GP marginal likelihood
    (`SingleTaskGP.mll`)."""
    batch = K.shape[:-2]
    n = K.shape[-1]
    rb = r.expand(*batch, n)
    if n > MAX_N:
        return _QdLarge.apply(K, rb)
    quad, ld = _MvnQuadLogdet.apply(K.reshape(-1, n, n), rb.reshape(-1, n))
    return quad.reshape(batch), ld.reshape(batch)
