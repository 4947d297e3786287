"""Carrying the JAX package's model parameters and caches across as numpy,
in both directions, for every block kind (``moe``'s ``router``, ``gate``,
``up`` and ``down`` leaves among them) and the modality frontends'
(C, V, d) embedding and (C, d, V) head.

The reference stacks each repeated unit of the block pattern along a leading
repeat dim: ``params["stack"][si][bi][name][r]`` is layer
``offset(si) + r·len(unit) + bi`` here (``transformer.layer_slots``), and the
caches (``init_cache``) have the same nesting.  The training state holds
one parameter dict per client stacked along a leading clients dim
(``stacked_params_from_reference`` / ``stacked_params_to_numpy``).  This
module takes and gives numpy only.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.interop import to_tensor
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model, init_params, skeleton


def _assign(dst: torch.Tensor, src, what: str) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: reference shape {src.shape}, port shape "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(to_tensor(src, dst.device).to(dst.dtype))


def params_from_reference(params_np: Dict[str, Any], cfg: ModelConfig, *,
                          device="cuda", dtype=torch.float32) -> Model:
    """The reference's ``init_params`` pytree (leaves as numpy) -> a port
    ``Model`` on ``device`` in ``dtype`` holding the same values.  Every
    port parameter is assigned exactly once, or this raises."""
    model = init_params(cfg, device=device, dtype=dtype)
    done = set()

    def put(name, dst, src):
        _assign(dst, src, name)
        done.add(id(dst))

    put("embed", model.embed, params_np["embed"])
    put("final_norm", model.final_norm, params_np["final_norm"])
    if model.head is not None:
        put("head", model.head, params_np["head"])
    for layer, (si, r, bi, _) in zip(model.layers, tf.layer_slots(cfg)):
        ref_block = params_np["stack"][si][bi]
        for name, sub in ref_block.items():
            if isinstance(sub, dict):
                for leaf, arr in sub.items():
                    put(f"{name}.{leaf}", getattr(layer, name)[leaf],
                        np.asarray(arr)[r])
            else:
                put(name, getattr(layer, name), np.asarray(sub)[r])
    missing = [n for n, p in model.named_parameters() if id(p) not in done]
    if missing:
        raise ValueError(f"parameters the reference does not give: {missing}")
    return model


def _by_slot(cfg: ModelConfig, items):
    """One list per (segment, unit slot) of ``items`` (one per layer, in
    layer order), in repeat order: the reference's nesting."""
    slots = tf.layer_slots(cfg)
    return [[[items[i] for i, (s, _, b, _) in enumerate(slots)
              if s == si and b == bi] for bi in range(len(unit))]
            for si, (unit, _) in enumerate(tf.segments(cfg))]


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def params_to_numpy(model: Model) -> Dict[str, Any]:
    """A port ``Model`` -> the reference's ``init_params`` pytree (f32
    numpy leaves, each block's tensors stacked over its repeats): the
    inverse of ``params_from_reference``."""
    out = {"embed": _np32(model.embed), "final_norm": _np32(model.final_norm)}
    if model.head is not None:
        out["head"] = _np32(model.head)
    stack = []
    for unit in _by_slot(model.cfg, list(model.layers)):
        blocks = []
        for layers in unit:
            block: Dict[str, Any] = {}
            for name, _ in layers[0].named_parameters():
                arr = np.stack([_np32(layer.get_parameter(name))
                                for layer in layers])
                head, _, leaf = name.partition(".")
                if leaf:
                    block.setdefault(head, {})[leaf] = arr
                else:
                    block[head] = arr
            blocks.append(block)
        stack.append(tuple(blocks))
    out["stack"] = tuple(stack)
    return out


def stacked_params_from_reference(params_np: List[Dict[str, Any]],
                                  cfg: ModelConfig, *, device="cuda",
                                  dtype=torch.float32
                                  ) -> Dict[str, torch.Tensor]:
    """One reference ``init_params`` pytree per client -> the training
    state's client-stacked parameter dict {name: (n, …)}
    (``torch.func.stack_module_state`` over the clients' ``Model``s)."""
    models = [params_from_reference(p, cfg, device=device, dtype=dtype)
              for p in params_np]
    params, _ = torch.func.stack_module_state(models)
    return {name: t.detach() for name, t in params.items()}


def stacked_params_to_numpy(x: Dict[str, torch.Tensor],
                            cfg: ModelConfig) -> List[Dict[str, Any]]:
    """The inverse of :func:`stacked_params_from_reference`: one reference
    pytree (f32 numpy leaves) per client."""
    n = next(iter(x.values())).shape[0]
    out = []
    for i in range(n):
        model = skeleton(cfg).to_empty(device="cpu")
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(x[name][i].detach().to("cpu", torch.float32))
        out.append(params_to_numpy(model))
    return out


def caches_from_reference(caches_np, cfg: ModelConfig, *,
                          device="cuda") -> List[Dict[str, torch.Tensor]]:
    """The reference's cache pytree (numpy leaves, bf16 included) -> one
    dict per layer, dtypes kept."""
    return [{name: to_tensor(np.asarray(arr)[r], device)
             for name, arr in caches_np[si][bi].items()}
            for si, r, bi, _ in tf.layer_slots(cfg)]


def caches_to_numpy(caches, cfg: ModelConfig):
    """One dict per layer -> the reference's nesting (tuple of segments,
    tuple of unit slots, dict of arrays stacked over repeats), as f32
    numpy."""
    return tuple(
        tuple({name: np.stack([_np32(c[name]) for c in layers])
               for name in layers[0]} for layers in unit)
        for unit in _by_slot(cfg, caches))
