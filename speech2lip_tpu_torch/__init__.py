"""PyTorch/CUDA port of speech2lip_tpu, held against the JAX package.

The inference renderer (``infer.renderer``), the static-scene serving
renderer (``infer.static_scene``), the U-Net's inference entry points and
the training step (``train``), whose TPU kernels run as hand-written CUDA
kernels for Hopper (``ops/kernels``, sources in ``csrc``).  The package
imports neither JAX nor anything of ``speech2lip_tpu``: what it needs of
the JAX package's numpy-only modules it keeps as its own copy (``data``).
"""
