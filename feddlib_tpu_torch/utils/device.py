"""Device resolution shared by every constructor and entry point.

The port runs on the card unless the caller asks for the CPU: every
`device=` argument defaults to "cuda", and a CUDA device on a machine
without one raises instead of quietly falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises RuntimeError for a CUDA device
    when no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    return dev
