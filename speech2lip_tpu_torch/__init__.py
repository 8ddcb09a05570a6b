"""PyTorch/CUDA port of speech2lip_tpu, held against the JAX package.

First slice: the inference renderer (``infer.renderer``), whose lip MLP,
windowed warp and post-fusion U-Net blocks run through hand-written CUDA
kernels for Hopper (``ops/kernels``, sources in ``csrc``).  The package
imports no JAX; its only imports from ``speech2lip_tpu`` are the numpy-only
``data.synthetic`` and ``data.windows`` modules.
"""
