"""pint_tpu_torch: the PyTorch/CUDA port of pint_tpu for one NVIDIA H100.

The JAX package ``pint_tpu`` is the reference; this package imports
``torch`` and ``numpy`` only, never ``jax`` and nothing of ``pint_tpu``.
Layout mirrors the reference (``ops/``, ``models/``, ``toas/``,
``fitting/``).  Hand-written CUDA kernels live in ``csrc/`` and are built
with nvcc at first use into ``_build/``.

Entry points take ``device=None``, meaning the CUDA card; with no card
and no device given they raise (``device.py``).
"""

__version__ = "0.1.0"
