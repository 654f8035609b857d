"""One device policy and one launch counter for every kernel wrapper.

Device policy (`resolve_device`): every entry point of the package takes a
``device=`` argument. ``None`` means the card, ``torch.device("cuda")``; on a
host without CUDA that raises a `RuntimeError` naming the fix
(``device="cpu"``). Nothing falls back to the CPU on its own.

Kernel dispatch (`is_cpu`): a wrapper in ``kernels/*/ops.py`` runs its
kernel's plain PyTorch version only for tensors that lie on the CPU — the
part the JAX package's Pallas interpret mode plays — and launches the
hand-written CUDA kernel for tensors on the card. A tensor on any other
device is refused.

Launch counts (`count_launch`, `launch_counts`, `reset_launch_counts`): each
wrapper adds one to its kernel's count where it launches the kernel, and
nowhere else, so a run can show that its main path went through the
kernels. The counts are process-wide plain integers.
"""

from __future__ import annotations

import collections
import threading

import torch

__all__ = ["resolve_device", "is_cpu", "count_launch", "launch_counts",
           "reset_launch_counts"]

_LAUNCHES: collections.Counter = collections.Counter()
_LAUNCH_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. ``cuda`` without an index resolves to the current card."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and this host "
                "has none; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; expected cuda or cpu")
    return device


def is_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version), False when
    every one lies on one CUDA device (kernel); anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel for tensors on {device}")


def count_launch(name: str) -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES.clear()
