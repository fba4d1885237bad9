"""ldso_tpu_torch: the PyTorch/CUDA port of the ``ldso_tpu`` odometry engine.

The JAX package ``ldso_tpu`` stays the reference; this package mirrors its
module layout and names so each module here has an obvious counterpart
there. It imports ``torch`` and never ``jax`` (nor any ``ldso_tpu``
module, whose package import pulls in jax).

Numerics are float32 on the device, as in the reference, with the
marginalization prior in float64 numpy on the host. The reference pins
``Precision.HIGHEST`` on its einsums; the counterpart here is set once,
on import: full-precision float32 matmuls and convolutions (no TF32).

Hand-written CUDA kernels (``csrc/``) are built and loaded at first use,
never at import, so the package imports on a machine without a GPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
