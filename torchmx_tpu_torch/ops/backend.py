"""Device selection, the counterpart of ``use_pallas``/``interpret`` in
``torchmx_tpu/ops/backend.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Kernel-backed ops choose by the device of the tensors they are given: a CUDA
tensor launches the hand-written kernel, a CPU tensor runs the plain PyTorch
version.  Nothing switches silently from one to the other.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_state = threading.local()


@contextlib.contextmanager
def plain_path() -> Iterator[None]:
    """Within this block every kernel-backed op runs its plain PyTorch
    version, on CUDA tensors too: the reference that ``chip_smoke.py`` holds
    the kernels against on the card.  Never entered by the package itself."""
    old = getattr(_state, "plain", False)
    _state.plain = True
    try:
        yield
    finally:
        _state.plain = old


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, and an error
    (not a silent CPU run) when no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True when the tensors lie on a CUDA device, False on the CPU; mixed or
    other devices raise."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return not getattr(_state, "plain", False)
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on cuda or all on cpu, got {sorted(kinds)}")
