"""Device choice shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device and raises when there is none;
    anything else is taken as the caller wrote it (the tests pass
    ``"cpu"``). Nothing ever drops to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "x265_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' explicitly to run the "
                "plain PyTorch path on the host")
        return torch.device("cuda")
    return torch.device(device)
