"""Small shared helpers: rounding, device resolution and a non-blocking
copy of device results to the host."""

from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` is the default and
    the serving target; without a visible GPU it raises instead of
    quietly running on the CPU (pass ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def settle(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream, so that
    shared device state built there is complete before another stream
    (a pipeline executor's) reads it; nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class HostCopy:
    """Device tensors' copy to the host, enqueued without waiting.

    On a CUDA device the copy goes into pinned host buffers with
    ``non_blocking=True`` on the current stream, followed by an event
    recorded there; :meth:`wait` waits for that event alone. A ``.cpu()``
    would wait for everything queued on the stream, the kernels that
    younger batches launched after this one included. On the CPU the
    tensors are the host copy. Either way :meth:`wait` returns numpy
    copies with the tensors' bits."""

    def __init__(self, *tensors: torch.Tensor):
        dev = tensors[0].device
        self.event = None
        if dev.type == "cuda":
            self.host = tuple(
                torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=True).copy_(t, non_blocking=True)
                for t in tensors)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))
        else:
            self.host = tensors

    def wait(self) -> tuple:
        if self.event is not None:
            self.event.synchronize()
        return tuple(h.numpy().copy() for h in self.host)
