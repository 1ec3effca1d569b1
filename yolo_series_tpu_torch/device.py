"""Device selection for the port's entry points.

JAX counterpart: none as a module — the JAX package places arrays with
`jax.devices()` / `jax.default_device`. Here every entry point takes an
explicit `device` and runs on CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    `None` means the card: CUDA device 0 of this process. Raises when no
    CUDA device is visible, so a missing card is never silently replaced
    by the CPU; pass `"cpu"` to run on the CPU on purpose.
    """
    d = torch.device("cuda" if name is None else name)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    return d
