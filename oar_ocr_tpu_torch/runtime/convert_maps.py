"""Per-model weight conversion: deploy-format tensors → flax trees.

The port's copy of ``oar_ocr_tpu/runtime/convert_maps.py``: the same
renamer and transforms over a parameter tree in the JAX package's form
(a nested dict, or its flat ``'/'``-joined keys), with numpy only. The
map is the port's :class:`~.ppocr_maps.ConversionMap`, whose ``convert``
gives the flat ``{flax key: array}`` dict where the JAX one nests it;
``roundtrip_check`` compares flat dicts.

The concrete half of the conversion toolchain (runtime/weights.py): walks
a model's flax parameter structure and derives, for every leaf, the
deploy-format source tensor name and layout transform (OIHW conv → HWIO,
[out,in] dense → [in,out], BatchNorm stat passthrough). Per-model naming
conventions plug in as a renamer callable; ``roundtrip_check`` proves a
map correct by exporting our own params to deploy layout and converting
back — the tensor-level parity gate SURVEY §7 calls for, runnable without
real checkpoints.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from .ppocr_maps import ConversionMap


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict tree → flat {'a/b/c': array} dict, keys in the sorted
    order of a JAX tree flatten (a flat dict's keys stay as they are)."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in sorted(tree.items()):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def conv_oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    """Paddle/ONNX conv kernel (O, I, kH, kW) → flax (kH, kW, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def dense_oi_to_io(w: np.ndarray) -> np.ndarray:
    """Dense (out, in) → flax (in, out)."""
    return np.transpose(w, (1, 0))


def _default_renamer(flat_key: str) -> str:
    """Our param path → a deploy-style dotted name.

    'params/PPLCNetV3_0/ConvBNAct_0/Conv_0/kernel' →
    'pplcnetv3_0.convbnact_0.conv_0.weight'
    """

    parts = flat_key.split("/")
    if parts and parts[0] == "params":
        parts = parts[1:]
    leaf = parts[-1]
    leaf_map = {"kernel": "weight", "bias": "bias", "scale": "gamma",
                "mean": "running_mean", "var": "running_var",
                "embedding": "weight"}
    parts[-1] = leaf_map.get(leaf, leaf)
    return ".".join(p.lower() for p in parts)


def _transform_for(flat_key: str, value: np.ndarray
                   ) -> Tuple[Optional[Callable], Optional[Callable]]:
    """(deploy→flax, flax→deploy) transforms for one leaf."""

    leaf = flat_key.split("/")[-1]
    if leaf == "kernel" and value.ndim == 4:
        return conv_oihw_to_hwio, lambda w: np.transpose(w, (3, 2, 0, 1))
    if leaf == "kernel" and value.ndim == 2:
        return dense_oi_to_io, lambda w: np.transpose(w, (1, 0))
    return None, None


def build_model_map(params: Any, *, name: str,
                    renamer: Callable[[str], str] = _default_renamer
                    ) -> ConversionMap:
    """Derive the full ConversionMap for a model from its param tree."""

    cm = ConversionMap(name)
    for key, value in flatten_params(params).items():
        fwd, _ = _transform_for(key, value)
        cm.map(key, renamer(key), fwd)
    return cm


def export_deploy_format(params: Any,
                         renamer: Callable[[str], str] = _default_renamer
                         ) -> Dict[str, np.ndarray]:
    """Our params → deploy-layout tensor dict (for tests and for shipping
    converted artifacts back out)."""

    out: Dict[str, np.ndarray] = {}
    for key, value in flatten_params(params).items():
        _, inv = _transform_for(key, value)
        out[renamer(key)] = inv(value) if inv else np.asarray(value)
    return out


def roundtrip_check(params: Any, *, name: str = "model",
                    atol: float = 0.0) -> bool:
    """Export → convert-back → bitwise tree equality."""

    cm = build_model_map(params, name=name)
    deploy = export_deploy_format(params)
    back = cm.convert(deploy)
    a = flatten_params(params)
    b = flatten_params(back)
    if set(a) != set(b):
        return False
    for k in a:
        if not np.allclose(np.asarray(a[k]), np.asarray(b[k]), atol=atol):
            return False
    return True
