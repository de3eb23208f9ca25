r"""Kernel K2: the fused ARD kernel matrix on the card.

Counterpart of `botorch_tpu/ops/pallas_kernels.py`, whose Pallas TPU
kernel `_pallas_kernel_matrix` this replaces. The CUDA source is
`csrc/kernel_matrix.cu` (its header says what bounds it on an H100 and how
its design answers that).

* `kernel_matrix_cuda` launches the CUDA kernel on the path and launch
  shape that `k2_plan` picks (narrow: one thread per output, for the
  acquisition's m = 1 shapes; tiled: register micro-tiles, for large
  n * m); `kernel_matrix_cuda.launches` counts its launches.
* `kernel_matrix_plain` is the plain PyTorch version (the raw kernels of
  `ops/kernels.py`): the CPU path, and the reference the kernel is held to.
* `kernel_matrix` is the differentiable op the models call. A CPU tensor
  takes the plain version; a CUDA tensor launches the kernel, or raises.
  The backward pass is autograd through the plain version, as the Pallas
  op's VJP is autodiff of the raw JAX formula.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from botorch_tpu_torch.ops import cuda_build
from botorch_tpu_torch.ops.kernels import KERNELS

Tensor = torch.Tensor

_KIND = {"rbf": 0, "matern52": 1, "matern32": 2, "matern12": 3}
_KIND_DTYPES = (torch.float32, torch.float64)
_FNS: dict = {}

NARROW_MAX_OUTPUTS = 4096  # n * m per problem up to which one thread takes one output
NARROW_MAX_THREADS = 128
TILE_ROWS_PER_THREAD = (4, 2, 1)  # tiled path: a 16 * rm x 32 output tile per block
TILE_COLS = 32
MAX_GRID_YZ = 65535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k2_plan(B: int, n: int, m: int, d: int, dtype: torch.dtype, num_sms: int) -> dict:
    """K2's path and launch shape for B problems of n x m outputs over d
    features in `dtype`, on a card of `num_sms` streaming multiprocessors.

    `narrow` (n * m <= 4096): one thread per output, a block of at most 128
    threads and as few as 32, grid (outputs / block, batch); the feature
    loop is unrolled for d <= 2, <= 8 or <= 32 (`d_bucket`; chunks of 32
    above). `tiled`: 128 threads per 16 * rm x 32 tile, with the largest rm
    in (4, 2, 1) whose grid still covers the SMs; each thread stores its
    four columns with 16-byte stores when every row starts 16-byte aligned.
    """
    nm = n * m
    batch_blocks = min(B, MAX_GRID_YZ)
    if nm <= NARROW_MAX_OUTPUTS:
        threads = min(NARROW_MAX_THREADS, 32 * max(1, _cdiv(nm, 32)))
        return {
            "path": "narrow", "threads": threads,
            "d_bucket": 2 if d <= 2 else 8 if d <= 8 else 32,
            "grid": (_cdiv(nm, threads), batch_blocks, 1),
        }
    for rm in TILE_ROWS_PER_THREAD:
        grid = (_cdiv(m, TILE_COLS), _cdiv(n, 16 * rm), batch_blocks)
        if math.prod(grid) >= num_sms:
            break
    return {
        "path": "tiled", "threads": 128, "rows_per_thread": rm, "grid": grid,
        "vector_stores": m % (16 // dtype.itemsize) == 0,
    }


def kernel_matrix_plain(x: Tensor, z: Tensor, lengthscale: Tensor, kind: str) -> Tensor:
    """Plain PyTorch version of K2."""
    return KERNELS[kind](x, z, lengthscale)


def _functions():
    """`{(path, dtype): C entry point}`; each takes x, z, ls, out, B, n, m,
    d, the three batch strides, the kind, two path parameters and the
    stream."""
    if not _FNS:
        lib = cuda_build.load("kernel_matrix")
        for path in ("narrow", "tiled"):
            for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
                fn = getattr(lib, f"bt_kernel_matrix_{path}_{suffix}")
                fn.argtypes = (
                    [ctypes.c_void_p] * 4
                    + [ctypes.c_int] * 4
                    + [ctypes.c_longlong] * 3
                    + [ctypes.c_int] * 3
                    + [ctypes.c_void_p]
                )
                fn.restype = ctypes.c_int
                _FNS[path, dtype] = fn
    return _FNS


@functools.cache
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _batched(t: Tensor, batch: tuple, inner: tuple) -> tuple[Tensor, int]:
    """`t` as a contiguous `(B, *inner)` buffer and its batch stride; a
    tensor without batch extent is shared by every problem (stride 0)."""
    lead = t.shape[: t.ndim - len(inner)]
    if math.prod(lead) == 1:
        return t.reshape(inner).contiguous(), 0
    return t.expand(*batch, *inner).contiguous(), math.prod(inner)


def kernel_matrix_cuda(x: Tensor, z: Tensor, lengthscale: Tensor, kind: str) -> Tensor:
    """Launch K2 on CUDA tensors `x (..., n, d)`, `z (..., m, d)`,
    `lengthscale (..., d)`; returns `(..., n, m)`."""
    if kind not in _KIND:
        raise ValueError(f"K2 has no kernel {kind!r}")
    tensors = (x, z, lengthscale)
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("K2 needs x, z and lengthscale on one CUDA device")
    if any(t.dtype != x.dtype for t in tensors) or x.dtype not in _KIND_DTYPES:
        raise TypeError(f"K2 takes float32 or float64 tensors of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if x.ndim < 2 or z.ndim < 2 or lengthscale.ndim < 1:
        raise ValueError("K2 needs x (..., n, d), z (..., m, d), ls (..., d)")
    n, d = x.shape[-2:]
    m = z.shape[-2]
    if z.shape[-1] != d or lengthscale.shape[-1] != d or d < 1:
        raise ValueError(f"K2 feature dims differ: {x.shape}, {z.shape}, {lengthscale.shape}")
    batch = torch.broadcast_shapes(x.shape[:-2], z.shape[:-2], lengthscale.shape[:-1])
    B = math.prod(batch)
    xb, sx = _batched(x, batch, (n, d))
    zb, sz = _batched(z, batch, (m, d))
    lb, sl = _batched(lengthscale, batch, (d,))
    out = torch.empty((*batch, n, m), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = k2_plan(B, n, m, d, x.dtype, _num_sms(x.device))
    if plan["path"] == "narrow":
        params = (plan["d_bucket"], plan["threads"])
    else:
        params = (plan["rows_per_thread"], int(plan["vector_stores"]))
    fn = _functions()[plan["path"], x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(
            xb.data_ptr(), zb.data_ptr(), lb.data_ptr(), out.data_ptr(),
            B, n, m, d, sx, sz, sl, _KIND[kind], *params, stream,
        )
    cuda_build.check(status, "kernel_matrix")
    kernel_matrix_cuda.launches += 1
    return out


kernel_matrix_cuda.launches = 0


class _KernelMatrix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, z, lengthscale, kind):
        ctx.save_for_backward(x, z, lengthscale)
        ctx.kind = kind
        return kernel_matrix_cuda(x, z, lengthscale, kind)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(w) for t, w in zip(saved, need)]
            out = kernel_matrix_plain(*inputs, ctx.kind)
            wrt = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g)) if wrt else iter(())
        return (*(next(grads) if w else None for w in need), None)


def kernel_matrix(x: Tensor, z: Tensor, lengthscale: Tensor, kind: str) -> Tensor:
    """Differentiable kernel matrix: the plain version for CPU tensors, the
    CUDA kernel K2 for CUDA tensors."""
    if x.device.type == "cpu":
        return kernel_matrix_plain(x, z, lengthscale, kind)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on CPU or CUDA tensors, got {x.device}")
    return _KernelMatrix.apply(x, z, lengthscale, kind)
