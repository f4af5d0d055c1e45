"""Hand-written Hopper kernels that replace the JAX package's Pallas
kernels. Each kernel package holds ``ops.py`` (the wrapper: checks,
dispatch, launch count) and ``ref.py`` (the plain PyTorch version the
wrapper takes for CPU tensors); CUDA sources live in ``repro_torch/csrc``.
"""
