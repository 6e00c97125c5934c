"""oar_ocr_tpu_torch — the PyTorch/CUDA port of oar_ocr_tpu.

The JAX package (``oar_ocr_tpu``) stays the reference: every module here
has a counterpart of the same path there, and the tests hold each one
against it on the same weights and inputs. This package imports ``torch``
and never ``jax``, nor anything of ``oar_ocr_tpu``: the host modules it
needs (errors, constants, result types, DB postprocess, geometry,
sorting, tracing, the structure domain and markdown rules, layout
sorting, stitching, the native C++ candidates extension) are its own
copies, each naming the module it was copied from.

Entry points, as for the JAX package::

    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
    from oar_ocr_tpu_torch.pipelines.structure import OARStructureBuilder
    from oar_ocr_tpu_torch.vl import PaddleOCRVL
    from oar_ocr_tpu_torch.vl.hunyuan import HunyuanOCRModel

They run on the CUDA card unless given ``Runtime(device="cpu")``.
Hand-written CUDA kernels live under ``csrc/`` and are built with ``nvcc``
for sm_90a at first use (``ops/cuda_build.py``); each has a plain PyTorch
version beside it that CPU tensors take.
"""

__version__ = "0.1.0"
