"""ace_tpu_torch: the PyTorch/CUDA port of ``ace_tpu``.

The port runs the same emulators as the JAX package on an NVIDIA GPU:
SFNO-family networks stepped autoregressively on the sphere, with the
physics correctors and prescribed ocean around them. Its modules mirror
``ace_tpu``'s layout (``ops/``, ``models/``, ``core/``, ``stepper/``) so
that a config dict or a checkpoint written by one package builds the
other. The TPU kernels of the JAX package are hand-written CUDA kernels
here (``csrc/``), each with a plain PyTorch version beside it.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :func:`ace_tpu_torch.device.get_device`).
"""

__version__ = "0.1.0"

from ace_tpu_torch.device import get_device  # noqa: F401
