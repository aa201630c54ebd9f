"""The PyTorch port stands alone: ``torchmx_tpu_torch/`` and ``chip_smoke.py``
import neither JAX, Flax nor the JAX package, and the entry points run on
``cuda`` unless the caller asks for the CPU."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "torchmx_tpu")
PORT_FILES = sorted((ROOT / "torchmx_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_default_to_cuda(monkeypatch):
    """With no card, building without ``device="cpu"`` raises instead of
    running on the CPU."""
    from torchmx_tpu_torch.convert import from_flat_params
    from torchmx_tpu_torch.config import MXConfig
    from torchmx_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from torchmx_tpu_torch.models.serve import DecodeEngine
    from torchmx_tpu_torch.ops.backend import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=1, num_attention_heads=1, num_key_value_heads=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_flat_params({}, cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    assert model.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(model, 1, 128, kv_cache_config=MXConfig("int8"))
    assert DecodeEngine(model, 1, 128, kv_cache_config=MXConfig("int8"), device="cpu").device.type == "cpu"
