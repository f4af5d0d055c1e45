"""PyTorch/CUDA port of the RT-Gang reproduction (the JAX package ``repro``
is the reference it is tested against).

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``: the scheduling core it needs (``core/``, ``obs/metrics``,
``configs/``) is copied here. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; see ``repro_torch.device``.
"""
