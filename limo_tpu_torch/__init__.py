"""limo_tpu_torch — the PyTorch/CUDA port of ``limo_tpu``.

The windowed trimmed bundle adjustment of ``limo_tpu`` in PyTorch, for one
NVIDIA H100: plain tensor code is PyTorch, and the two fused assembly
kernels are CUDA C++ written for Hopper (``csrc/assemble.cu``). Entry points
run on the card unless the caller passes ``device="cpu"``; on CPU tensors
each kernel's plain PyTorch version runs instead.
"""

from . import geometry

__version__ = "0.1.0"
