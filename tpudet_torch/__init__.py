"""tpudet_torch: the PyTorch/CUDA port of tpudet for NVIDIA Hopper.

The package mirrors ``tpudet/`` module for module (``ops``, ``nn``, ``heads``,
``models``, ``runtime``). It imports ``torch`` and ``numpy`` and nothing of JAX,
flax or ``tpudet``. Model entry points run on the GPU unless the caller passes
``device="cpu"`` (see :mod:`tpudet_torch.device`). Every TPU kernel of tpudet has
a hand-written CUDA counterpart under ``tpudet_torch/ops/cuda`` with a plain
PyTorch version beside it; a kernel wrapper takes the plain version only for a
tensor that lies on the CPU.
"""

__version__ = "0.1.0"
