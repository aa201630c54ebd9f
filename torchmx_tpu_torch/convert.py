"""Weight bridge from the JAX package's Llama parameters.

``from_flat_params`` takes the JAX model's parameters as a flat
``{dotted path: numpy array}`` dict (paths as ``nnx`` flattens the model
state, e.g. ``model.layers.0.self_attn.q_proj.weight``; bf16 arrays as
``ml_dtypes.bfloat16``) and returns this package's bf16
``LlamaForCausalLM`` computing the same function.  Quantize it afterwards
with ``quant_api.quantize_llm_``, from the same bf16 weights."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.llama import LlamaConfig, LlamaForCausalLM
from .ops.backend import DeviceLike, resolve_device


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_flat_params(
    params: Dict[str, np.ndarray], config: LlamaConfig, device: DeviceLike = None
) -> LlamaForCausalLM:
    device = resolve_device(device)
    model = LlamaForCausalLM(config, device=device)
    targets = dict(model.named_parameters())
    targets["model.embed_tokens.weight"] = targets.pop("model.embed_tokens")
    targets["model.inv_freq"] = model.model.inv_freq
    missing = set(targets) - set(params)
    if missing:
        raise KeyError(f"parameters missing from the JAX state: {sorted(missing)}")
    with torch.no_grad():
        for name, dst in targets.items():
            src = _to_torch(params[name])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: JAX {tuple(src.shape)} vs port {tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))
    return model
