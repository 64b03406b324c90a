"""Device policy of the port.

The device is explicit: ``cuda`` unless the caller passes ``cpu``.  Asking
for CUDA where there is none raises; nothing falls back to the CPU.  On the
CPU every kernel's plain PyTorch version runs instead of the kernel.
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["card_power", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; raises if it is CUDA and there is none,
    or if it is neither CUDA nor the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def card_power(index: int | None = None) -> str | None:
    """``nvidia-smi``'s name and power limit of card ``index`` (every card
    where None), as ``--query-gpu=name,power.limit --format=csv,noheader``
    prints them, or None where they cannot be read."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    if index is not None:
        cmd.insert(1, f"--id={index}")
    try:
        return subprocess.run(cmd, capture_output=True, text=True, check=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
