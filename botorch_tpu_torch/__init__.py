"""botorch_tpu_torch: the PyTorch and CUDA port of `botorch_tpu`.

The package mirrors the JAX package's module layout, so that each module
has a counterpart of the same name and place. Plain tensor code is
PyTorch; the two Pallas TPU kernels of the JAX package are hand-written
CUDA kernels for Hopper (`csrc/`), each with its plain PyTorch version
beside it. The entry points run on CUDA unless they are given another
device.

Importing the package sets the precision policy of `settings.py`
(float32 matrix products in full float32, TF32 off).
"""

__version__ = "0.1.0"

from botorch_tpu_torch.settings import apply_precision_policy

apply_precision_policy()

from botorch_tpu_torch.fit import fit_gp  # noqa: E402
from botorch_tpu_torch.loop import bo_step, run_bo_loop  # noqa: E402
from botorch_tpu_torch.models.gp import SingleTaskGP, make_gp  # noqa: E402
from botorch_tpu_torch.optim.optimize import optimize_acqf  # noqa: E402

__all__ = [
    "SingleTaskGP",
    "bo_step",
    "fit_gp",
    "make_gp",
    "optimize_acqf",
    "run_bo_loop",
]
