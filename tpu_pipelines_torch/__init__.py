"""tpu_pipelines_torch: the PyTorch and CUDA port of ``tpu_pipelines``.

A package of its own beside the JAX reference, for NVIDIA Hopper (H100).
It imports nothing of ``tpu_pipelines`` and never imports JAX; where it
needs a jax-free helper of the reference it keeps its own copy.  Module
paths mirror the reference (``ops/flash_attention.py``,
``models/bert.py``, ``trainer/export.py``, ``serving/server.py``, ...).
Entry points run on the card unless the caller asks for the CPU.
Every TPU kernel of a ported path is a CUDA kernel under ``csrc/``, built
at first use by ``ops/_build.py``.
"""
