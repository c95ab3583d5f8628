"""The port's decoder registry.

Same shape as ``huffmandecoderongpus_tpu.models``: every decoder is called
as ``decoder(hf, param=None) -> np.ndarray`` (decoded bytes on the host).
The device is chosen explicitly when a decoder is looked up, e.g.
``get_decoder("lane_wide", device="cuda")``; nothing picks a device by what
is available.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

_REGISTRY: dict[str, "Decoder"] = {}


@dataclasses.dataclass(frozen=True)
class Decoder:
    """A named decoder bound to a device."""

    name: str
    fn: Callable[..., np.ndarray]  # (hf, param, *, device) -> decoded bytes
    backend: str
    device: str | None = None

    def __call__(self, hf, param: Any = None) -> np.ndarray:
        if self.device is None:
            raise ValueError(f"decoder {self.name!r} has no device: use "
                             "get_decoder(name, device=...)")
        return self.fn(hf, param, device=self.device)


def register(name: str, backend: str):
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"decoder {name!r} already registered")
        _REGISTRY[name] = Decoder(name, fn, backend)
        return fn

    return deco


def get_decoder(name: str, *, device: str) -> Decoder:
    _ensure_loaded()
    return dataclasses.replace(_REGISTRY[name], device=str(device))


def all_decoders(*, device: str) -> dict[str, Decoder]:
    _ensure_loaded()
    return {n: dataclasses.replace(d, device=str(device))
            for n, d in _REGISTRY.items()}


def _ensure_loaded() -> None:
    # importing the submodules runs their @register decorators
    from huffmandecoderongpus_tpu_torch.models import lanedfa  # noqa: F401
