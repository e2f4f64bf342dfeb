"""PyTorch port of the HI serving system, for NVIDIA Hopper (H100).

The layout mirrors the JAX reference package ``repro`` module for module
(``configs/``, ``core/``, ``kernels/``, ``models/``, ``serving/``,
``launch/``), so the counterpart of each reference module sits at the same
relative path.  The port imports ``torch`` and never ``jax``, and nothing of
``repro``: it keeps its own copies of what it needs.

Kernels are chosen by device: on a CUDA tensor the wrappers in
``kernels/ops.py`` launch hand-written ``sm_90a`` kernels (``csrc/``); on a
CPU tensor they run the plain PyTorch version of the same function.
"""
