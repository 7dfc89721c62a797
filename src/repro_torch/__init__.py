"""PyTorch + CUDA port of ``repro`` (FastSample) for NVIDIA Hopper.

A package of its own beside the JAX package ``repro``: it imports
``torch`` and ``numpy`` and nothing of ``jax`` or ``repro``.  Module paths
mirror ``repro``'s, so ``repro_torch/core/sampler.py`` is the counterpart of
``repro/core/sampler.py``.  See README.md ("The PyTorch port").
"""
