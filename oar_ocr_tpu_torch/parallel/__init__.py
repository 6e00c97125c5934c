"""Mesh parallelism (counterpart of ``oar_ocr_tpu/parallel/``):
data-parallel batch sharding over a list of devices (``mesh.py``, wired
into the OCR pipeline through ``Runtime``), the fused det+rec step on a
mesh (``dp.py``) and Megatron-style tensor parallelism of the VLM
decoders (``tp.py``, wired through ``Runtime.put_params_vl``)."""

from .mesh import build_mesh
from .tp import param_shardings, partition_params, tp_spec

__all__ = ["build_mesh", "param_shardings", "partition_params", "tp_spec"]
