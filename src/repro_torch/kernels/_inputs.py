"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain-version path),
    False when all lie on one CUDA device; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def as_u8(x: torch.Tensor) -> torch.Tensor:
    """A bool or uint8 mask as contiguous uint8 (0/1)."""
    if x.dtype == torch.bool:
        return x.contiguous().view(torch.uint8)
    if x.dtype != torch.uint8:
        raise TypeError(f"mask must be bool or uint8, got {x.dtype}")
    return x.contiguous()


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned (the kernels read it with
    16- and 8-byte copies): a view at an odd offset is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def tile_inputs(q, packed, cids, doc_valid, q_valid, centroids,
                bucket_weights, nbits: int):
    """Validate the batched tile arguments for a CUDA launch and return
    them contiguous, in the kernel's dtypes."""
    if nbits not in (2, 4):
        raise ValueError(f"nbits must be 2 or 4, got {nbits}")
    if q.dtype != torch.float32 or centroids.dtype != torch.float32 \
            or bucket_weights.dtype != torch.float32:
        raise TypeError("q, centroids and bucket_weights must be float32")
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8, got {packed.dtype}")
    if cids.dtype != torch.int32:
        raise TypeError(f"cids must be int32, got {cids.dtype}")
    B, Lq, d = q.shape
    if packed.dim() != 4 or packed.shape[0] != B:
        raise ValueError(f"packed shape {tuple(packed.shape)} does not "
                         f"match q {tuple(q.shape)}")
    _, C, Ld, pd = packed.shape
    if pd * 8 != d * nbits:
        raise ValueError(f"packed width {pd} != d·nbits/8 = "
                         f"{d * nbits // 8}")
    if tuple(cids.shape) != (B, C, Ld) or tuple(doc_valid.shape) != (B, C, Ld):
        raise ValueError("cids and doc_valid must be (B, C, Ld)")
    if tuple(q_valid.shape) != (B, Lq):
        raise ValueError("q_valid must be (B, Lq)")
    if d % 32 or d > 1024:
        raise ValueError(f"kernel needs d a multiple of 32, at most "
                         f"1024; got {d}")
    if Lq > 128:
        raise ValueError(f"kernel takes at most 128 query tokens, got {Lq}")
    if centroids.dim() != 2 or centroids.shape[1] != d:
        raise ValueError("centroids must be (K, d)")
    if bucket_weights.numel() != 1 << nbits:
        raise ValueError(f"bucket_weights must hold 2^nbits = {1 << nbits}")
    return (aligned(q), aligned(packed), cids.contiguous(),
            as_u8(doc_valid), as_u8(q_valid), aligned(centroids),
            bucket_weights.contiguous())
