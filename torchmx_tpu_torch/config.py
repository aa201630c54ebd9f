"""Quantization configuration dataclasses (the fields this port reads from
``torchmx_tpu/config.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import dtypes


@dataclass(frozen=True)
class MXConfig:
    """One MX format: element dtype name + block size (default 32, OCP MX v1.0)."""

    elem_dtype_name: str
    block_size: int = 32

    def __post_init__(self):
        if self.elem_dtype_name not in dtypes.STR_TO_SUPPORTED_ELEM_DTYPE:
            raise ValueError(
                f"Unsupported element dtype name: {self.elem_dtype_name}. "
                f"Supported names are: {tuple(dtypes.STR_TO_SUPPORTED_ELEM_DTYPE)}"
            )
        if self.block_size < 1:
            raise ValueError(f"Block size must be at least 1, got {self.block_size}")

    @property
    def elem_dtype(self) -> dtypes.DType:
        return dtypes.STR_TO_SUPPORTED_ELEM_DTYPE[self.elem_dtype_name]


@dataclass(frozen=True)
class QLinearConfig:
    """Weights + (dynamically quantized) activations formats of a linear."""

    weights_config: MXConfig
    activations_config: MXConfig


@dataclass(frozen=True)
class QAttentionConfig:
    """Attention quantization config.  This slice serves projections only:
    Q/K/V/attention-weights quantization is not ported yet, so those configs
    must stay None."""

    projection_config: QLinearConfig
    query_config: Optional[MXConfig] = None
    key_config: Optional[MXConfig] = None
    value_config: Optional[MXConfig] = None
    attention_weights_config: Optional[MXConfig] = None

    def __post_init__(self):
        if any((self.query_config, self.key_config, self.value_config,
                self.attention_weights_config)):
            raise NotImplementedError(
                "Q/K/V/attention-weights quantization is not ported yet"
            )
