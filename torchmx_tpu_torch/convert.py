"""Bridge from the JAX package: model parameters, MX weights and MX KV caches.

``from_flat_params`` takes the JAX model's parameters as a flat
``{dotted path: numpy array}`` dict (paths as ``nnx`` flattens the model
state, e.g. ``model.layers.0.self_attn.q_proj.weight``; bf16 arrays as
``ml_dtypes.bfloat16``) and returns this package's bf16 causal LM of the
config's family (Llama, Qwen2, Mistral, Mixtral or DeepSeek-V3) computing
the same function; Qwen2's q/k/v biases come across, and a bias the port's
model does not have (an ``o_proj.bias`` of a Qwen2) is an error.  A
Mixtral's stacked expert weights ``mlp.w1`` / ``w3`` ``(E, H, I)`` and
``mlp.w2`` ``(E, I, H)`` and its router ``mlp.gate.weight`` ``(E, H)`` keep
their names and layouts, and so do DeepSeek-V3's MLA projections
and latent norms, its router's ``mlp.gate.e_score_correction_bias`` (f32)
and its ``mlp.shared_experts``.  Quantize the model afterwards with
``quant_api.quantize_llm_``, from the same bf16 weights.

``grouped_moe_from_buffers`` takes a JAX grouped MX MoE block's stacked
codes and scales (numpy) and returns the port's grouped block over the same
bytes; with ``gate_bias`` and ``shared_experts`` (a DeepSeek-V3 block's
correction bias and the port's MX shared experts) the DeepSeek grouped
block.

``cache_from_buffers`` takes the four buffers of a JAX ``MXLayerKVCache`` (as
numpy arrays) and returns this package's cache over the same bytes, in the
same or the other storage layout.

``mx_tensor_from_buffers`` takes a JAX ``MXArray``'s payload and scale (as
numpy arrays: a quantized linear's weight in any of its layouts) and its
metadata, and returns the :class:`MXTensor` over the same bytes."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import QLinearConfig
from .layers.mx_deepseek_attention import MXInferenceDeepseekV3MoEGrouped
from .layers.mx_mixtral_moe import MXInferenceMixtralMoeBlockGrouped
from .models.deepseek import DeepseekV3Config, DeepseekV3ForCausalLM
from .models.llama import LlamaConfig, LlamaForCausalLM, MXLayerKVCache
from .models.mistral import MistralConfig, MistralForCausalLM
from .models.mixtral import MixtralConfig, MixtralForCausalLM
from .models.qwen2 import Qwen2Config, Qwen2ForCausalLM
from .mx_array import MXTensor
from .ops.backend import DeviceLike, resolve_device


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def causal_lm_class(config: LlamaConfig):
    """The causal-LM class of the config's family."""
    if isinstance(config, DeepseekV3Config):
        return DeepseekV3ForCausalLM
    if isinstance(config, MixtralConfig):
        return MixtralForCausalLM
    if isinstance(config, Qwen2Config):
        return Qwen2ForCausalLM
    return MistralForCausalLM if isinstance(config, MistralConfig) else LlamaForCausalLM


def from_flat_params(
    params: Dict[str, np.ndarray], config: LlamaConfig, device: DeviceLike = None
) -> LlamaForCausalLM:
    device = resolve_device(device)
    model = causal_lm_class(config)(config, device=device)
    targets = dict(model.named_parameters())
    targets["model.embed_tokens.weight"] = targets.pop("model.embed_tokens")
    targets["model.inv_freq"] = model.model.inv_freq
    missing = set(targets) - set(params)
    if missing:
        raise KeyError(f"parameters missing from the JAX state: {sorted(missing)}")
    extra = sorted(n for n in params if n.endswith(".bias") and n not in targets)
    if extra:
        raise KeyError(f"biases the port's {type(model).__name__} does not have: {extra}")
    with torch.no_grad():
        for name, dst in targets.items():
            src = _to_torch(params[name])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: JAX {tuple(src.shape)} vs port {tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))
    return model


def cache_from_buffers(
    k_data: np.ndarray, k_scale: np.ndarray, v_data: np.ndarray, v_scale: np.ndarray,
    elem_dtype_name: str, layout: str, to_layout: Optional[str] = None, block_size: int = 32,
    device: DeviceLike = None,
) -> MXLayerKVCache:
    """The port's cache holding a JAX ``MXLayerKVCache``'s buffers, given in
    ``layout`` (``"seq"`` or ``"dmajor"``), stored in ``to_layout`` (default:
    as given).  The two layouts differ by a swap of the last two axes; fp4
    bytes pack d-halves in both."""
    to_layout = layout if to_layout is None else to_layout
    device = resolve_device(device)
    buffers = [_to_torch(a) for a in (k_data, k_scale, v_data, v_scale)]
    if to_layout != layout:
        buffers = [t.transpose(2, 3).contiguous() for t in buffers]
    return MXLayerKVCache(*(t.to(device) for t in buffers), elem_dtype_name, block_size, to_layout)


def mx_tensor_from_buffers(
    data: np.ndarray, scale: np.ndarray, elem_dtype_name: str, fp4_pack: str = "pair",
    block_size: int = 32, block_dim: Optional[int] = None, padding: int = 0,
    device: DeviceLike = None,
) -> MXTensor:
    """The port's ``MXTensor`` over a JAX ``MXArray``'s bytes (``data``:
    uint8, int8 or, for fp8 halves, uint16; ``scale``: uint8), with the same
    element format, layout (``fp4_pack``), block dim and padding."""
    device = resolve_device(device)
    return MXTensor(_to_torch(scale).to(device), _to_torch(data).to(device), elem_dtype_name, block_size,
                    padding=padding, block_dim=block_dim, fp4_pack=fp4_pack)


def grouped_moe_from_buffers(
    config: MixtralConfig, gate_weight: np.ndarray, codes: Dict[str, np.ndarray], scales: Dict[str, np.ndarray],
    qconfig: QLinearConfig, kernel_elem: str, device: DeviceLike = None, gate_bias: Optional[np.ndarray] = None,
    shared_experts=None,
) -> MXInferenceMixtralMoeBlockGrouped:
    """The port's grouped MX MoE block over a JAX grouped block's bytes:
    the router weight ``(E, H)`` bf16, and ``codes`` / ``scales`` keyed
    ``"w1"``, ``"w3"``, ``"w2"`` (the JAX block's ``w*_codes`` ``(E, K, N)``
    and ``w*_scale`` ``(E, K/32, N)``), decoded as ``kernel_elem``."""
    device = resolve_device(device)

    def on(d):
        return {k: _to_torch(v).to(device) for k, v in d.items()}

    block = MXInferenceMixtralMoeBlockGrouped(config, _to_torch(gate_weight).to(device), on(codes), on(scales),
                                              qconfig, kernel_elem)
    if gate_bias is None:
        return block
    block.__class__ = MXInferenceDeepseekV3MoEGrouped
    block.e_score_bias = _to_torch(gate_bias).to(device=device, dtype=torch.float32)
    block.shared_experts = shared_experts
    return block
