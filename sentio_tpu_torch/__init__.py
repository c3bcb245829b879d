"""sentio_tpu_torch — the PyTorch/CUDA port of ``sentio_tpu`` for one
NVIDIA H100.

Module paths mirror the JAX package (``models/llama.py`` here is the
counterpart of ``sentio_tpu/models/llama.py``). The package imports torch,
numpy and the standard library only; every Pallas kernel on its path is a
hand-written CUDA kernel under ``csrc/``, built with ``nvcc`` into
``build/`` at first use. Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA on a host without it raises
    instead of silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path"
        )
    return dev
