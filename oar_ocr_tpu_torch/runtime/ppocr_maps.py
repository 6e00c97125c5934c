"""Official-name maps: upstream deploy tensors → the port's state_dict,
and the port's state_dict → the JAX package's flat checkpoint format.

Counterpart of ``oar_ocr_tpu/runtime/ppocr_maps.py`` (``build_ppocr_map``,
``export_ppocr_format``, :85-120), ``runtime/convert_maps.py`` and the
per-family maps ``build_slanet_map`` (``models/recognition/
slanet_exact.py:383``), ``build_slanext_map`` (``slanext_exact.py:290``),
``build_pplcnet_cls_map`` (``models/classification/pp_lcnet_exact.py:50``)
and ``build_formulanet_map`` (``pp_formulanet_exact.py:289``), with a
numpy-only :class:`ConversionMap` (the JAX one, ``runtime/weights.py:
130-175``, imports jax).

The port's module paths already are the official Paddle deploy names
(``runtime/weights.py``), so the map from an official tensor to a port
key is a rule on the leaf and on the module that holds it, enumerated by
walking the port module's ``state_dict`` as the JAX maps walk the flax
tree:

- BatchNorm ``_mean`` / ``_variance`` → ``running_mean`` / ``running_var``;
- a Paddle Linear stores (in, out), torch (out, in): transposed; inside
  PP-FormulaNet's MBart decoder (``head.decoder.``) the deploy export
  keeps the HF layout (out, in), so nothing is transposed there;
- Conv and Conv2DTranspose weights stay as they are: Paddle's
  deconvolution layout (in, out, kH, kW) is torch's;
- everything else (LAB scalars, raw parameters such as ``in_proj_weight``,
  ``pos_embed``, the GRU's ``rnn.weight_ih``) keeps its name and layout.

SLANet's exact model stores its GRU as Paddle does (``rnn.weight_ih`` …),
so it needs no case here; only the generic ``SLANet``
(``models/recognition/slanet.py``) fuses a flax ``GRUCell``, and it has
no official export.

:func:`jax_flat_params` turns a port state_dict into the JAX package's
artifact format (flax variables flattened with ``'/'``-joined keys, the
file ``tools/convert_weights.py`` writes and ``weights.load_params``
reads): the inverse of ``weights.torch_name`` and of
``weights.params_from_jax``'s layouts. A flax module name may hold dots
(``blocks3.0``, ``head.decoder.model.decoder``) where the port nests
modules, so the inverse groups the port key's parts by the dotted flax
names of the families the registry converts (:data:`_FLAX_DOTTED`).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
from torch import nn

from ..errors import ModelLoadError
from .weights import hf_vl_name  # noqa: F401  (the VL renamer)


class ConversionMap:
    """Declarative source → target tensor mapping for one model family
    (the JAX ``ConversionMap``, ``runtime/weights.py:130-175``, flat:
    :meth:`convert` gives ``{port key: array}``, not a nested tree)."""

    def __init__(self, name: str):
        self.name = name
        self.rules: List[Tuple[str, str, Optional[Callable]]] = []

    def map(self, target: str, source: str,
            transform: Optional[Callable] = None) -> "ConversionMap":
        self.rules.append((target, source, transform))
        return self

    def convert(self, source_tensors: Mapping[str, np.ndarray],
                *, strict: bool = True) -> Dict[str, np.ndarray]:
        flat: Dict[str, np.ndarray] = {}
        missing = []
        for target, source, transform in self.rules:
            if source not in source_tensors:
                missing.append(source)
                continue
            t = np.asarray(source_tensors[source])
            flat[target] = transform(t) if transform else t
        if strict and missing:
            raise ModelLoadError("missing source tensors during conversion",
                                 model=self.name, missing=missing[:10],
                                 missing_count=len(missing))
        return flat

    def unused_sources(self, source_tensors: Mapping[str, np.ndarray]):
        used = {s for _, s, _ in self.rules}
        return sorted(set(source_tensors) - used)


def official_name(key: str) -> str:
    """Port state_dict key → official Paddle deploy name."""
    head, _, leaf = key.rpartition(".")
    leaf = {"running_mean": "_mean", "running_var": "_variance"}.get(leaf,
                                                                     leaf)
    return f"{head}.{leaf}" if head else leaf


def _transpose(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _linear_weights(model: nn.Module, hf_prefix: Optional[str]) -> set:
    """Keys of the Linear weights stored (in, out) by the deploy export."""
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, nn.Linear)
            and not (hf_prefix and name.startswith(hf_prefix))}


def build_ppocr_map(model: nn.Module, *, name: str,
                    hf_prefix: Optional[str] = None) -> ConversionMap:
    """Walk ``model``'s state_dict and emit the official-name rules
    (``ppocr_maps.py:85-99``). ``model`` may live on the ``meta``
    device: only its keys and module types are read."""
    linear = _linear_weights(model, hf_prefix)
    cm = ConversionMap(name)
    for key in model.state_dict():
        cm.map(key, official_name(key),
               _transpose if key in linear else None)
    return cm


def build_slanet_map(model: nn.Module, *, name: str = "slanet"
                     ) -> ConversionMap:
    """SLANet / SLANet_plus (``slanet_exact.py:383-387``)."""
    return build_ppocr_map(model, name=name)


def build_slanext_map(model: nn.Module, *, name: str = "slanext"
                      ) -> ConversionMap:
    """SLANeXt wired / wireless (``slanext_exact.py:290-294``)."""
    return build_ppocr_map(model, name=name)


def build_pplcnet_cls_map(model: nn.Module, *, name: str = "pplcnet-cls"
                          ) -> ConversionMap:
    """The PULC PP-LCNet classifiers (``pp_lcnet_exact.py:50-53``)."""
    return build_ppocr_map(model, name=name)


def build_formulanet_map(model: nn.Module, *, name: str = "pp-formulanet"
                         ) -> ConversionMap:
    """PP-FormulaNet: Paddle names throughout, the MBart decoder in HF
    layout (``pp_formulanet_exact.py:289-311``)."""
    return build_ppocr_map(model, name=name, hf_prefix="head.decoder.")


def convert_official(model: nn.Module, cm: ConversionMap,
                     source_tensors: Mapping[str, np.ndarray], *,
                     strict: bool = True) -> Dict[str, np.ndarray]:
    """Official tensors → the port's state_dict (float32 numpy), through
    ``cm``; with ``strict`` a missing tensor raises ``ModelLoadError``
    naming it, as does a tensor whose shape is not the model's."""
    sd = cm.convert(source_tensors, strict=strict)
    expect = model.state_dict()
    for key, v in sd.items():
        if tuple(v.shape) != tuple(expect[key].shape):
            raise ModelLoadError("source tensor has the wrong shape",
                                 model=cm.name, tensor=official_name(key),
                                 shape=tuple(v.shape),
                                 expected=tuple(expect[key].shape))
        sd[key] = np.asarray(v, np.float32)
    return sd


def export_ppocr_format(model: nn.Module, state_dict=None, *,
                        hf_prefix: Optional[str] = None
                        ) -> Dict[str, np.ndarray]:
    """The port's weights → official-name deploy tensors (the inverse
    direction, ``ppocr_maps.py:102-117``), float32 numpy."""
    sd = model.state_dict() if state_dict is None else state_dict
    linear = _linear_weights(model, hf_prefix)
    out: Dict[str, np.ndarray] = {}
    for key, v in sd.items():
        a = np.asarray(v.detach().float().cpu() if hasattr(v, "detach")
                       else v, np.float32)
        out[official_name(key)] = _transpose(a) if key in linear else a
    return out


# ---------------------------- the VL checkpoints ----------------------------

# The VL models' state_dict keys are the HF checkpoint's tensor names and
# their layouts the HF layouts (Linear (out, in), the PaddleOCR-VL and
# HunyuanOCR patch embeddings and the perceive convolutions as torch
# stores them), so an HF tensor maps onto its own name with no transform
# but one: the exact towers' patch embedding, a Linear over flattened
# patches (as the JAX towers' Dense), which the checkpoint stores as a
# convolution.
_PATCH_LINEARS = ("patch_embed.proj", "patch_embedding",
                  "patch_embed.patchifier.proj")


def _hf_patch_conv(w: np.ndarray) -> np.ndarray:
    """An HF patch-embedding convolution → the exact towers' Linear over
    patches flattened as (p, p, 3), tiled over time: (D, 3, p, p) →
    (D, p·p·3), (D, 3, t, p, p) → (D, t·p·p·3). An export that already
    stores the flattened 2-D (D, p·p·3) form (``export_vl_format``, the
    JAX converter's fixtures) is kept as it is."""
    if w.ndim == 2:
        return w
    if w.ndim == 4:
        return np.ascontiguousarray(np.transpose(w, (0, 2, 3, 1))
                                    .reshape(w.shape[0], -1))
    return np.ascontiguousarray(np.transpose(w, (0, 2, 3, 4, 1))
                                .reshape(w.shape[0], -1))


def _patch_linears(model: nn.Module) -> set:
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, nn.Linear) and name.endswith(_PATCH_LINEARS)}


def build_vl_map(model: nn.Module, *, name: str = "paddleocr-vl"
                 ) -> ConversionMap:
    """The HF-name map of a VL model (``ppocr_maps.py:157-170``): each
    state_dict key from the tensor of its own name; the exact towers'
    patch Linear through :func:`_hf_patch_conv`. ``model`` may live on
    the ``meta`` device."""
    patch = _patch_linears(model)
    cm = ConversionMap(name)
    for key in model.state_dict():
        cm.map(key, key, _hf_patch_conv if key in patch else None)
    return cm


def build_hunyuan_map(model: nn.Module, *, name: str = "hunyuanocr"
                      ) -> ConversionMap:
    """HunyuanOCR's map (``ppocr_maps.py:173-191``): the perceive
    convolutions are torch's layout already, so it is
    :func:`build_vl_map`'s."""
    return build_vl_map(model, name=name)


def export_vl_format(model: nn.Module, state_dict=None
                     ) -> Dict[str, np.ndarray]:
    """A VL model's weights → HF-name tensors (``ppocr_maps.py:194-206``),
    float32 numpy; the exact towers' patch embedding in the flattened 2-D
    form."""
    sd = model.state_dict() if state_dict is None else state_dict
    return {k: np.asarray(v.detach().float().cpu() if hasattr(v, "detach")
                          else v, np.float32) for k, v in sd.items()}


# ------------------- the JAX package's artifact format -------------------

# Flax module names that hold dots, as regular expressions over the port
# key's dot-joined parts (every family of ``tools/port_convert_weights.py``;
# ``tests/test_torch_convert.py`` checks the inverse on each). A part
# that is a number always joins the name before it (``blocks3.0``,
# ``svtr_block.1``): flax names list items ``name.N``.
_FLAX_DOTTED = [re.compile(p) for p in (
    r"ctc_encoder\.encoder",                       # SVTR's MultiHeadCTC
    r"downsample\.(bn|conv)",                      # UVDoc
    r"resnet_down\.layer\d+\.\d+",
    r"conv_t\.convs\.\d+",                         # CSP-PAN
    r"patch_embed\.proj",                          # ViT towers
    r"head\.decoder\.model\.decoder",              # PP-FormulaNet
    r"head\.enc_to_dec_proj",
    r"stages\.\d+\.(blocks\.\d+|downsample)",      # HGNetV2
    r"decoder\.layers\.\d+",                       # RT-DETR
    r"encoder\.\d+\.layers\.\d+",
    r"input_proj\.\d+\.(\d+|conv|norm)",
)]

# leaves whose flax name holds a dot: a raw parameter in the flax module
# where the port has a submodule
_FLAX_DOTTED_LEAF = re.compile(
    r"rnn\.(weight|bias)_(ih|hh)|denoising_class_embed\.weight")

_KERNEL_MODULES = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _flax_path(parts: List[str]) -> List[str]:
    """Group the port key's module parts into flax module names: the
    longest run that is a name of :data:`_FLAX_DOTTED`, else a part with
    the numbers after it."""
    out: List[str] = []
    i = 0
    while i < len(parts):
        best = i + 1
        for j in range(len(parts), i + 1, -1):
            joined = ".".join(parts[i:j])
            if any(p.fullmatch(joined) for p in _FLAX_DOTTED):
                best = j
                break
        while best < len(parts) and parts[best].isdigit():
            best += 1
        out.append(".".join(parts[i:best]))
        i = best
    return out


def jax_flat_key(key: str, module: Optional[nn.Module]) -> str:
    """Port state_dict key → flax flat key (the inverse of
    ``weights.torch_name``). ``module`` is the module that holds the
    tensor: Conv/Linear ``weight`` → ``kernel``; Embedding ``weight`` →
    ``embedding``; any other ``weight`` → ``scale`` (the norms);
    BatchNorm statistics go to the ``batch_stats`` collection."""
    parts = key.split(".")
    if len(parts) >= 2 and _FLAX_DOTTED_LEAF.fullmatch(".".join(parts[-2:])):
        return "/".join(["params", *_flax_path(parts[:-2]),
                         ".".join(parts[-2:])])
    leaf, parts = parts[-1], parts[:-1]
    collection = "params"
    if leaf in ("running_mean", "running_var"):
        collection, leaf = "batch_stats", leaf[len("running_"):]
    elif leaf == "weight":
        if isinstance(module, _KERNEL_MODULES):
            leaf = "kernel"
        elif isinstance(module, nn.Embedding):
            leaf = "embedding"
        else:
            leaf = "scale"
    return "/".join([collection, *_flax_path(parts), leaf])


def _joined_flax_key(key: str, modules: Mapping[str, nn.Module],
                     prefixes: Mapping[str, str]) -> str:
    """A port key of an exact VLM stack (``vl/exact_models.ExactVLMNet``)
    → its flax key: a part joins the one before it with a dot where that
    one's module carries ``flax_join`` (``vl/vision_towers.Group``:
    ``attn.qkv``, the raw ``conv1d.weight``) or is a list (``blocks.0``,
    ``merger.mlp.0``); ``prefixes`` gives a root the flax tree nests the
    key under (HPD's ``hpd_vision``)."""
    parts = key.split(".")
    groups, cur = [], parts[0]
    for i in range(1, len(parts)):
        m = modules.get(".".join(parts[:i]))
        if getattr(m, "flax_join", False) or isinstance(
                m, (nn.ModuleList, nn.Sequential)):
            cur += "." + parts[i]
        else:
            groups.append(cur)
            cur = parts[i]
    if cur == "weight":
        owner = modules.get(key.rpartition(".")[0])
        cur = ("kernel" if isinstance(owner, _KERNEL_MODULES) else
               "embedding" if isinstance(owner, nn.Embedding) else "scale")
    root = prefixes.get(parts[0])
    return "/".join(["params"] + ([root] if root else []) + groups + [cur])


def jax_flat_params(model: nn.Module, state_dict=None
                    ) -> Dict[str, np.ndarray]:
    """The port's weights → the JAX package's flat checkpoint dict
    (``'/'``-joined flax keys, flax layouts, float32): convolutions OIHW →
    HWIO, deconvolutions (in, out, kH, kW) → flax ConvTranspose (kH, kW,
    in, out) flipped in space, Linear (out, in) → (in, out); the inverse
    of ``weights.params_from_jax``. The exact VLM stacks, which carry
    ``flax_prefixes``, name their flax keys by :func:`_joined_flax_key`."""
    sd = model.state_dict() if state_dict is None else state_dict
    modules = dict(model.named_modules())
    prefixes = getattr(model, "flax_prefixes", None)
    out: Dict[str, np.ndarray] = {}
    for key, v in sd.items():
        owner = modules.get(key.rpartition(".")[0])
        a = np.asarray(v.detach().float().cpu() if hasattr(v, "detach")
                       else v, np.float32)
        if key.endswith(".weight"):
            if isinstance(owner, nn.ConvTranspose2d):
                a = np.transpose(a, (2, 3, 0, 1))[::-1, ::-1]
            elif isinstance(owner, nn.Conv2d):
                a = np.transpose(a, (2, 3, 1, 0))
            elif isinstance(owner, nn.Linear):
                a = a.T
        fk = (jax_flat_key(key, owner) if prefixes is None
              else _joined_flax_key(key, modules, prefixes))
        if fk in out:
            raise ModelLoadError("two tensors map to one flax key", key=fk)
        out[fk] = np.ascontiguousarray(a)
    return out
