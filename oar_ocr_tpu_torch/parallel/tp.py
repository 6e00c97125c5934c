"""Tensor-parallel parameter partitioning for the VLM decoders, and the
all-reduce that joins the shards.

Counterpart of ``oar_ocr_tpu/parallel/tp.py``: Megatron-style sharding of
the attention heads and the FFN columns over the mesh's ``model`` axis,
by the same path rules (:data:`_COL_PARALLEL`, :data:`_ROW_PARALLEL`,
``tp.py:45-102``) matched on the last name component of a parameter's
parent, so the same parameters are sharded in both packages. A torch
``Linear`` weight is (out, in), so a column-parallel weight splits dim 0
(the JAX kernel's dim 1) and a row-parallel one dim 1.

Where GSPMD inserts an all-reduce after each row-parallel product, the
port calls :func:`all_reduce` on the shards' partial products:
``torch.cuda.nccl.all_reduce`` across cards (one host process, one
tensor a card, as the JAX single controller), a plain sum for shards
that share a device (the CPU tests' virtual devices, two shards on one
card). A column-parallel LM head's logits are gathered along the vocab
(:func:`gather_columns`) before the argmax.

:func:`partition_params` splits a state_dict evenly by the rules, one
dict a ``model`` shard on its device; :func:`partition_module` builds
each shard's module from it. A module may override the even split of
some of its parameters (``tp_splits``): the decoder's attention layer
gives each shard the k/v rows of the kv heads its q heads read, so a
decoder whose kv heads do not divide over the shards (GLM-OCR's 2 kv
heads at ``n_model`` = 4) replicates them (GSPMD splits inside a head
there and stays exact).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..errors import ConfigError, UnsupportedError

# Column-parallel: weight (out, in) → shard OUT over ``model``; the bias
# (if any) is sharded the same way.
_COL_PARALLEL = frozenset({
    "q", "k", "v", "q_proj", "k_proj", "v_proj",
    "gate_proj", "up_proj", "gate_up_proj",
    "lm_head", "in_proj_qkv", "in_proj_z",
})

# Row-parallel: weight (out, in) → shard IN over ``model``. Each shard's
# product is a partial sum; :func:`all_reduce` adds them.
_ROW_PARALLEL = frozenset({"o", "o_proj", "down_proj", "out_proj"})

# a spec names the mesh axis each dimension is split over (None: whole);
# () is replicated, the JAX ``P()``
Spec = Tuple[Optional[str], ...]
Rules = Callable[[Tuple[str, ...], object], Spec]


def path_names(name: str) -> Tuple[str, ...]:
    """A state_dict name as its path, ``lm.layer0.q.weight`` →
    ("lm", "layer0", "q", "weight")."""
    return tuple(name.split("."))


def tp_spec(path: Tuple[str, ...], leaf) -> Spec:
    """The spec of one parameter by its path (``tp.py:64-84``).

    Everything not matched (norm scales, embeddings, biases of
    row-parallel layers, per-head norms, the attention of the vision
    towers) stays replicated."""
    if len(path) < 2:
        return ()
    leaf_name = path[-1]
    parent = path[-2].rsplit(".", 1)[-1]
    ndim = getattr(leaf, "ndim", 0)
    if leaf_name == "weight" and ndim == 2:
        if parent in _COL_PARALLEL:
            return ("model", None)
        if parent in _ROW_PARALLEL:
            return (None, "model")
    if leaf_name == "bias" and ndim == 1 and parent in _COL_PARALLEL:
        return ("model",)
    return ()


def param_shardings(params: Dict[str, torch.Tensor],
                    rules: Rules = tp_spec) -> Dict[str, Spec]:
    """The spec of every parameter of a state_dict (``tp.py:87-92``)."""
    return {name: rules(path_names(name), t) for name, t in params.items()}


def _split_dim(spec: Spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def even_slices(size: int, n: int, what: str) -> List[slice]:
    """``n`` equal slices of ``size``."""
    if size % n:
        raise ConfigError("a tensor-parallel dimension must divide over "
                          "the model shards", tensor=what, size=size,
                          n_model=n)
    per = size // n
    return [slice(i * per, (i + 1) * per) for i in range(n)]


def partition_params(params: Dict[str, torch.Tensor], mesh,
                     rules: Rules = tp_spec,
                     splits: Optional[Dict[str, List[slice]]] = None
                     ) -> List[Dict[str, torch.Tensor]]:
    """One state_dict a ``model`` shard, on its device (``tp.py:95-102``):
    a sharded tensor's slice along its split dimension (evenly, or by
    ``splits[name]``, one slice a shard), a replicated tensor whole. A
    tensor already on a shard's device is shared, not copied."""
    devs = mesh.model_devices
    n = len(devs)
    out: List[Dict[str, torch.Tensor]] = [{} for _ in devs]
    for name, t in params.items():
        dim = _split_dim(rules(path_names(name), t))
        pieces = [t] * n
        if dim is not None:
            sl = (splits or {}).get(name) or even_slices(t.shape[dim], n,
                                                         name)
            pieces = [t[(slice(None),) * dim + (s,)].contiguous()
                      for s in sl]
        for shard, piece, dev in zip(out, pieces, devs):
            shard[name] = piece.to(dev)
    return out


def module_splits(module: torch.nn.Module, n: int
                  ) -> Dict[str, List[slice]]:
    """The split overrides of ``module``'s submodules that define
    ``tp_splits(n)`` (local name → one slice a shard), by full name."""
    out = {}
    for prefix, sub in module.named_modules():
        hook = getattr(sub, "tp_splits", None)
        if hook is not None:
            for local, sl in hook(n).items():
                out[f"{prefix}.{local}" if prefix else local] = sl
    return out


def partition_module(module: torch.nn.Module, mesh,
                     rules: Rules = tp_spec) -> List[torch.nn.Module]:
    """One module a ``model`` shard: ``module``'s structure holding
    :func:`partition_params`' slices on the shard's device. A
    ``Linear`` whose weight is split reads its local width from the
    weight; modules that need it (the decoder's attention) derive their
    local head counts the same way."""
    n = len(mesh.model_devices)
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    shards = partition_params(tensors, mesh, rules,
                              splits=module_splits(module, n))
    memo = {id(t): torch.empty_like(t, device="meta")
            for t in tensors.values()}
    out = []
    for shard in shards:
        rep = copy.deepcopy(module, dict(memo))
        for name, t in shard.items():
            owner, leaf = _owner(rep, name)
            if leaf in owner._parameters:
                owner._parameters[leaf] = torch.nn.Parameter(
                    t, requires_grad=False)
            else:
                owner._buffers[leaf] = t
            if isinstance(owner, torch.nn.Linear) and leaf == "weight":
                owner.out_features, owner.in_features = t.shape
        out.append(rep)
    return out


def _owner(module: torch.nn.Module, name: str):
    *path, leaf = name.split(".")
    for p in path:
        module = getattr(module, p)
    return module, leaf


def all_reduce(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the ``model`` shards' partial products, on every
    shard's device: a plain sum among the shards of one device, then one
    ``torch.cuda.nccl.all_reduce`` across the cards (in place, on each
    card's current stream). The shards of one device share the result."""
    sums: Dict[torch.device, torch.Tensor] = {}
    for p in parts:
        d = p.device
        sums[d] = p if d not in sums else sums[d] + p
    if len(sums) > 1:
        if any(d.type != "cuda" for d in sums):
            raise UnsupportedError("an all-reduce across devices runs on "
                                   "CUDA cards",
                                   devices=[str(d) for d in sums])
        from torch.cuda import nccl

        nccl.all_reduce(list(sums.values()))
    return [sums[p.device] for p in parts]


def gather_columns(parts: Sequence[torch.Tensor],
                   device: torch.device) -> torch.Tensor:
    """The shards of a column-parallel output joined along the last
    axis on ``device``."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], -1)


def broadcast(x, devices: Sequence[torch.device]) -> list:
    """``x`` on every device of ``devices`` (one entry each; ``x`` itself
    where it lies there already, and anything not a tensor as is)."""
    if not isinstance(x, torch.Tensor):
        return [x] * len(devices)
    copies = {x.device: x}
    for d in devices:
        if d not in copies:
            copies[d] = x.to(d, non_blocking=True)
    return [copies[d] for d in devices]
