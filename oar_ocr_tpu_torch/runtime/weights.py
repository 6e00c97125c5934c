"""Checkpoint reading and JAX→PyTorch parameter conversion.

Counterpart of ``oar_ocr_tpu/runtime/weights.py``. Checkpoints are the
JAX package's flat safetensors files: flax variables flattened with
``'/'``-joined keys (``weights.flatten_params``), e.g.
``params/backbone/blocks3.0/dw_conv/reparam_conv/kernel`` or
``batch_stats/backbone/conv1/bn/mean``.

:func:`read_safetensors` and :func:`write_safetensors` need only numpy
(the format is an 8-byte little-endian header length, a JSON header,
then raw little-endian tensor bytes), so no ``safetensors`` package is
required. :func:`load_weight_source` takes a path, a
:class:`ModelSource` or a registry name (``registry/models.py``); the
artifacts in the registry's cache come from
``tools/port_convert_weights.py`` (``runtime/ppocr_maps.py``).

:func:`params_from_jax` renames each flax key to the port's module path,
which is the official PaddleOCR deploy name (``runtime/ppocr_maps.py``
``ppocr_name``) with PyTorch's BatchNorm buffer names, and converts
layouts: HWIO→OIHW convolutions (depthwise included), flax
ConvTranspose (kH, kW, in, out, spatially flipped) → PyTorch
(in, out, kH, kW), dense (in, out) → (out, in).

Under tensor parallelism (``Runtime.put_params_vl``) the VL families'
state_dicts, ``params_from_jax`` of the JAX trees, are split by
``parallel/tp.py``'s rules on these names: a flax key's last two path
components (the layer and ``kernel``/``bias``) become the port name's
(the layer and ``weight``/``bias``), so the rule that shards a JAX
kernel's output axis shards the port weight's dim 0, and both packages
compute from the same weights (``tests/test_torch_parallel.py`` holds the
specs leaf by leaf).

:func:`params_from_jax` also converts the layout models
(``models/detection/rtdetr.py``, ``picodet_exact.py``) with no case of
their own: flax names with dots (``stages.0.blocks.1``,
``input_proj.0.conv``, ``decoder.layers.5``) are the port's
``nn.ModuleList`` / ``nn.Sequential`` paths; ``FusedMHA``'s
``in_proj_weight`` is a raw (d, 3d) parameter in Paddle's layout, not a
``kernel``, and is kept as it is (the port multiplies by it as the JAX
module does); the raw parameter ``denoising_class_embed.weight`` becomes
the port's ``nn.Embedding`` ``denoising_class_embed``. Loading with
``strict=True`` checks that every JAX parameter maps and none is left
(``tests/test_torch_layout.py``).

The table models convert the same way (``tests/test_torch_tables.py``):
SLANet_plus and SLANeXt under their official Paddle names (``head.
structure_attention_cell.rnn.weight_ih``, ``backbone.vision_tower_high.
blocks.0.attn.rel_pos_h``; raw parameters such as ``pos_embed`` and the
rel-pos tables keep their layout), SLANet under its flax names, its
``nn.Embed`` table becoming ``token_emb.weight`` and its flax
``GRUCell`` fused into Paddle's layout (:func:`_fuse_gru`).

The formula models convert with no case of their own either
(``tests/test_torch_formula.py``, ``test_torch_formulanet.py``): the
default recognizer under its flax names (``FormulaEncoder_0/ConvBNAct_0``,
``mem_k0``, ``decoder/ln_a0``, the raw ``decoder/pos_emb``), and the
exact models under dotted flax names that are the port's module paths
(``head.decoder.model.decoder/layers.0/fc1``,
``encoder.layers.0.blocks.1/attention.self.query``,
``backbone/vision_tower_high/net_3``); Swin's patch embedding is a Dense
over flattened patches, as in the JAX module, and its raw
``relative_position_bias_table`` keeps its layout.

The exact VLM stacks (``vl/exact_models.ExactVLMNet``, the towers of
``vl/vision_towers.py``, the decoders of ``vl/llm_decoders.py``) convert
with no case of their own either: their state_dict keys are the HF
checkpoint names, which are the flax names joined by dots
(``visual.blocks.0.attn.qkv.weight``, the raw
``model.language_model.layers.0.linear_attn.conv1d.weight``), and HPD's
flax root ``hpd_vision`` is dropped (:func:`torch_name`).

The VL families (``vl/families.FamilyModule``: the tower's
``VisionBlock_{i}``, the decoder's ``layer{i}`` attention and
gated-delta layers, ``vp1``/``vp2``, the MTP layer) and the DFlash
draft (``vl/dflash.DFlashDraft``, its own tree, as the JAX package
keeps ``dflash_params`` apart) convert with no case of their own
either: their modules carry the flax names, ``layers.0.self_attn.
q_proj`` included, and ``nn.Embed`` tables become ``weight``
(``tests/test_torch_vl_families.py``, ``test_torch_dflash.py``).

:func:`vl_params_from_jax` does the same for PaddleOCR-VL, whose port
state_dict keys are the HF checkpoint's tensor names
(``runtime/ppocr_maps.py:122-154``); :func:`load_hf_vl_checkpoint`
reads a published checkpoint into that same state_dict.
:func:`hunyuan_params_from_jax` converts the JAX HunyuanOCR parameters
the same way (``ppocr_maps.py:173-191``).
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Union

import numpy as np

from ..errors import ModelLoadError

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}

# deconvolution sites (flax ConvTranspose kernels), by official name
_DECONV_NAMES = {
    "head.binarize.conv2.weight",
    "head.binarize.conv3.weight",
}


def read_safetensors(source: Union[str, bytes]) -> Dict[str, np.ndarray]:
    """Read a safetensors file (path or bytes) into numpy arrays. BF16
    tensors are widened to float32."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        try:
            with open(source, "rb") as f:
                data = f.read()
        except OSError as e:
            raise ModelLoadError("failed to read checkpoint",
                                 path=str(source)) from e
    if len(data) < 8:
        raise ModelLoadError("truncated safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    try:
        header = json.loads(data[8:8 + n])
    except ValueError as e:
        raise ModelLoadError("bad safetensors header") from e
    body = memoryview(data)[8 + n:]
    out: Dict[str, np.ndarray] = {}
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = body[start:end]
        dt = meta["dtype"]
        if dt == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif dt in _ST_DTYPES:
            arr = np.frombuffer(raw, np.dtype(_ST_DTYPES[dt]).newbyteorder("<"))
        else:
            raise ModelLoadError("unsupported safetensors dtype",
                                 key=key, dtype=dt)
        out[key] = arr.reshape(meta["shape"]).copy()
    return out


def torch_name(flat_key: str) -> str:
    """Flax flat key → the port's state_dict key.

    ``params/backbone/blocks3.0/dw_conv/reparam_conv/kernel``
        → ``backbone.blocks3.0.dw_conv.reparam_conv.weight``;
    ``batch_stats/backbone/conv1/bn/mean`` → ``backbone.conv1.bn.running_mean``;
    LearnableAffineBlock scalars keep ``scale``; BatchNorm and LayerNorm
    ``scale`` and ``nn.Embed``'s ``embedding`` become ``weight``. The
    exact HPD stack's flax root ``hpd_vision``, which its checkpoint does
    not have, is dropped (``vl/exact_models.py``).
    """
    parts = flat_key.split("/")
    if parts[0] in ("params", "batch_stats"):
        parts = parts[1:]
    if parts[0] == "hpd_vision":
        parts = parts[1:]
    leaf, parent = parts[-1], (parts[-2] if len(parts) >= 2 else "")
    if leaf in ("kernel", "embedding"):
        leaf = "weight"
    elif leaf == "scale":
        leaf = "scale" if parent == "lab" else "weight"
    elif leaf == "mean":
        leaf = "running_mean"
    elif leaf == "var":
        leaf = "running_var"
    return ".".join(parts[:-1] + [leaf])


def _fuse_gru(sd: Dict[str, np.ndarray]) -> None:
    """A flax ``nn.GRUCell`` (``…gru.{ir,iz,in}`` with bias,
    ``…gru.{hr,hz}`` without, ``…gru.hn`` with bias; Linear layout after
    the transpose) → the fused ``…gru.weight_ih`` [ir; iz; in],
    ``weight_hh`` [hr; hz; hn], ``bias_ih``, ``bias_hh`` [0; 0; hn] of
    ``models/recognition/slanet.GRUWeights``, in place."""
    prefixes = {k[:-len(".ir.weight")] for k in sd
                if k.endswith(".gru.ir.weight")}
    for pre in prefixes:
        g = {gate: (sd.pop(f"{pre}.{gate}.weight"),
                    sd.pop(f"{pre}.{gate}.bias", None))
             for gate in ("ir", "iz", "in", "hr", "hz", "hn")}
        zero = np.zeros_like(g["hn"][1])
        sd[f"{pre}.weight_ih"] = np.concatenate([g[k][0] for k in
                                                 ("ir", "iz", "in")])
        sd[f"{pre}.bias_ih"] = np.concatenate([g[k][1] for k in
                                               ("ir", "iz", "in")])
        sd[f"{pre}.weight_hh"] = np.concatenate([g[k][0] for k in
                                                 ("hr", "hz", "hn")])
        sd[f"{pre}.bias_hh"] = np.concatenate([zero, zero, g["hn"][1]])


def params_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, "torch.Tensor"]:
    """JAX parameters in flat ``'/'``-joined form → the port's state_dict
    (float32 tensors; load with ``module.load_state_dict(sd, strict=True)``).
    A flax GRU cell (SLANet's decoder) is fused (:func:`_fuse_gru`)."""
    import torch

    sd: Dict[str, np.ndarray] = {}
    for key, value in flat.items():
        name = torch_name(key)
        v = np.asarray(value, np.float32)
        if key.endswith("/kernel") and v.ndim == 4:
            if name in _DECONV_NAMES:
                v = np.transpose(v[::-1, ::-1], (2, 3, 0, 1))
            else:
                v = np.transpose(v, (3, 2, 0, 1))
        elif key.endswith("/kernel") and v.ndim == 2:
            v = v.T
        sd[name] = v
    _fuse_gru(sd)
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


def load_jax_checkpoint(source: Union[str, bytes]) -> Dict[str, "torch.Tensor"]:
    """Read a JAX-package flat safetensors checkpoint as a port state_dict."""
    return params_from_jax(read_safetensors(source))


@dataclass(frozen=True)
class ModelSource:
    """A checkpoint as a path or as bytes in memory (``weights.py:28-48``)."""

    path: Optional[str] = None
    data: Optional[bytes] = None

    @staticmethod
    def from_path(path: str) -> "ModelSource":
        return ModelSource(path=path)

    @staticmethod
    def from_bytes(data: bytes) -> "ModelSource":
        return ModelSource(data=data)

    def read(self) -> bytes:
        if self.data is not None:
            return self.data
        if self.path is None:
            raise ModelLoadError("empty ModelSource")
        with open(self.path, "rb") as f:
            return f.read()


def load_params(source: Union[str, ModelSource]
                ) -> Dict[str, "torch.Tensor"]:
    """A flat safetensors checkpoint (a path or a :class:`ModelSource`) as
    a port state_dict: :func:`read_safetensors`, then
    :func:`params_from_jax` (the JAX ``load_params``, ``weights.py:89-103``,
    gives the nested flax tree instead). A file that cannot be read or
    parsed raises ``ModelLoadError``."""
    if isinstance(source, str):
        source = ModelSource.from_path(source)
    try:
        return params_from_jax(read_safetensors(source.read()))
    except ModelLoadError:
        raise
    except Exception as e:
        raise ModelLoadError("failed to read checkpoint",
                             path=source.path) from e


def load_weight_source(source) -> Dict[str, "torch.Tensor"]:
    """A path, a registry name or a :class:`ModelSource` → a port
    state_dict (the JAX builder's ``_load_weight_source``,
    ``pipelines/ocr.py:503-511``). A name resolves through
    ``registry/models.resolve_model_path`` to the converted artifact in
    ``$OAR_TPU_HOME/models``: a name whose artifact is not cached raises
    ``DownloadError`` with the hint to convert it
    (``tools/port_fetch_and_verify.py``), a string that is neither a path
    nor a registry name ``ModelLoadError``."""
    from ..registry.models import resolve_model_path

    if isinstance(source, ModelSource):
        return load_params(source)
    return load_params(resolve_model_path(str(source)))


def write_safetensors(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write float32/int arrays as a safetensors file (the inverse of
    :func:`read_safetensors`; keys in sorted order, data 8-byte aligned),
    readable by ``safetensors.numpy.load_file``."""
    names = {np.dtype(v): k for k, v in _ST_DTYPES.items()}
    header: Dict[str, dict] = {}
    blobs = []
    offset = 0
    for key in sorted(tensors):
        a = np.ascontiguousarray(tensors[key])
        raw = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        header[key] = {"dtype": names[a.dtype.newbyteorder("=")],
                       "shape": list(a.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    os.replace(tmp, path)


# ---------------------- PaddleOCR-VL (HF checkpoint) ----------------------

_PATCH_CONV = "visual.vision_model.embeddings.patch_embedding.weight"


def hf_vl_name(flat_key: str) -> str:
    """Flax flat key → HF tensor name (``ppocr_maps.py:122-138``):
    ``params/model/layers.0/self_attn.q_proj/kernel`` →
    ``model.layers.0.self_attn.q_proj.weight``; ``kernel``,
    ``embedding`` and ``scale`` leaves become ``weight``."""
    parts = flat_key.split("/")
    if parts[0] in ("params", "batch_stats"):
        parts = parts[1:]
    leaf = parts[-1]
    if leaf in ("kernel", "embedding", "scale"):
        leaf = "weight"
    return ".".join(parts[:-1] + [leaf])


def vl_params_from_jax(flat: Mapping[str, np.ndarray]
                       ) -> Dict[str, "torch.Tensor"]:
    """The JAX ``PaddleOCRVL.params``, flattened (``'/'``-joined keys) →
    the port's state_dict under the HF names, float32. Undoes the JAX
    converter's transforms (``ppocr_maps.py:141-154``): a dense kernel
    (in, out) → Linear (out, in); the patch embedding's dense kernel over
    HWC-flattened patches (p·p·3, D) → Conv2d (D, 3, p, p)."""
    import torch

    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        name = hf_vl_name(key)
        v = np.asarray(value, np.float32)
        if name == _PATCH_CONV:
            p = int(round((v.shape[0] / 3) ** 0.5))
            v = v.reshape(p, p, 3, v.shape[1]).transpose(3, 2, 0, 1)
        elif key.endswith("/kernel") and v.ndim == 2:
            v = v.T
        sd[name] = torch.from_numpy(np.array(v, np.float32, order="C"))
    return sd


def hunyuan_params_from_jax(flat: Mapping[str, np.ndarray]
                            ) -> Dict[str, "torch.Tensor"]:
    """The JAX ``HunyuanOCRModel.params``, flattened (``'/'``-joined keys)
    → the port's ``HunyuanOCRNet`` state_dict under the HF names
    (``vit.…``, ``model.…``), float32. Undoes ``build_hunyuan_map``'s
    transforms (``ppocr_maps.py:173-191``): a dense kernel (in, out) →
    Linear (out, in); the perceive convolutions HWIO → OIHW; the patch
    embedding's dense kernel over HWC-flattened patches (p·p·3, D) →
    Conv2d (D, 3, p, p)."""
    import torch

    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        name = hf_vl_name(key)
        v = np.asarray(value, np.float32)
        if name.endswith("patch_embedding.weight"):
            p = int(round((v.shape[0] / 3) ** 0.5))
            v = v.reshape(p, p, 3, v.shape[1]).transpose(3, 2, 0, 1)
        elif key.endswith("/kernel") and v.ndim == 4:
            v = np.transpose(v, (3, 2, 0, 1))
        elif key.endswith("/kernel") and v.ndim == 2:
            v = v.T
        sd[name] = torch.from_numpy(np.array(v, np.float32, order="C"))
    return sd


def load_hf_vl_checkpoint(source: Union[str, bytes]
                          ) -> Dict[str, "torch.Tensor"]:
    """Read a PaddleOCR-VL HF safetensors checkpoint as the port's
    state_dict: its tensor names are the port's keys, its layouts the
    port's (Linear (out, in), patch embedding Conv2d (D, 3, p, p))."""
    import torch

    return {name: torch.from_numpy(np.array(v, np.float32, order="C"))
            for name, v in read_safetensors(source).items()}
