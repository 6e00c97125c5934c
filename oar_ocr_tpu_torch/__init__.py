"""oar_ocr_tpu_torch — the PyTorch/CUDA port of oar_ocr_tpu.

The JAX package (``oar_ocr_tpu``) stays the reference: every module here
has a counterpart of the same path there, and the tests hold each one
against it on the same weights and inputs. This package imports ``torch``
and never ``jax``; it reuses only the JAX package's jax-free host modules
(postprocess, geometry, sorting, result types, the native C++ candidates
extension).

Entry point, as for the JAX package::

    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder

Hand-written CUDA kernels live under ``csrc/`` and are built with ``nvcc``
for sm_90a at first use (``ops/cuda_build.py``); each has a plain PyTorch
version beside it that CPU tensors take.
"""

__version__ = "0.1.0"
