"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain version.

Sources live in ``csrc/``; :mod:`tpudet_torch.ops.cuda.build` compiles them with
``nvcc`` at first use into ``build/kernels/`` and loads them with ``ctypes``.
Nothing here touches the GPU or the compiler when it is imported.
"""
