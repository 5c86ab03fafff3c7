"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Without a GPU
and without an explicit CPU request they raise: they never carry on quietly
on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None -> "cuda" (raises when CUDA is missing); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
