"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``, raising if it names a card
    that is not there, and pin float32 matrix products to full precision.

    TF32 keeps about three decimal digits. The reference measured that a
    single-pass reduced-precision matmul shifts the flagship ensemble's
    surface energies by up to 0.69 eV (surface_sampling_tpu/models/
    painn.py, ``painn_apply`` docstring), so neither cuBLAS nor cuDNN may
    use it anywhere in the port.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
