"""PyTorch/CUDA port of homan_tpu: joint hand-object fitting on an NVIDIA GPU.

Each module mirrors the module of the same name in the JAX package
(`homan_tpu/`), which stays the reference the port is tested against. The
port imports torch and numpy only, never jax and nothing of `homan_tpu`.

Device rule: entry points take `device=`. Omitted, they run on `cuda`; when
CUDA is absent they raise instead of falling back to the CPU. Tests pass
`device="cpu"` explicitly, and on CPU tensors every kernel wrapper runs its
plain PyTorch version.

Precision: TF32 is switched off for matmuls and cuDNN when this package is
imported. The JAX package pins Precision.HIGHEST on the gradient-path matmuls
(render/pallas_shade.py, rasterizer.py, interactions/contact.py there);
TF32's ~3 decimal digits fail the 3e-3 gradient parity the same way the
TPU's single-pass bf16 did.
"""
from __future__ import annotations

import torch


def set_precision() -> None:
    """Keep float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


set_precision()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names one.

    Raises when no device was named and CUDA is absent: the port never
    falls back to the CPU silently.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU with the kernels' plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)
