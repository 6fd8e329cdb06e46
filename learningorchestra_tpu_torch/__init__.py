"""learningorchestra_tpu_torch — the PyTorch/CUDA port of learningorchestra_tpu.

Mirrors the JAX package's module paths (``ops/attention.py`` ports
``learningorchestra_tpu/ops/attention.py`` and so on) and imports nothing
from it: the JAX package stays the reference each module is tested
against.  Every Pallas kernel on a ported path is a hand-written CUDA C++
kernel for Hopper (``csrc/``), built with nvcc at first use
(``kernels/build.py``).

Entry points take an explicit ``device`` that defaults to ``"cuda"``;
without a card that default raises instead of dropping to the CPU.
"""

from learningorchestra_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
