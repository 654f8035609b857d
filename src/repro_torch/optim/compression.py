"""Error-feedback int8 gradient compression for the cross-group all-reduce.

The port of the JAX package's ``optim/compression.py``: each gradient plus
its residual is quantized to int8 with one scale, the int8 payload is summed
across the mesh's ranks as int32 (``all_reduce`` on the mesh's process
group), the scales are averaged, and the sum is divided by the mesh size;
the quantization error is carried to the next step (error feedback). On a
mesh of one rank no collective is issued; the gradients are still quantized,
as JAX's are.
"""

from __future__ import annotations

import torch

__all__ = ["compressed_psum", "init_residual"]


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(grads: dict, residual: dict, mesh) -> tuple[dict, dict]:
    """All-reduce mean of ``grads`` over the ``mesh`` (a
    `repro_torch.launch.mesh.DataMesh`) in int8 with error feedback.

    Returns (reduced grads, new residual), each keyed as ``grads``."""
    import torch.distributed as dist

    size = mesh.size
    red, res = {}, {}
    for name, g in grads.items():
        r = residual[name]
        gf = g.float() + r.float()
        q, scale = _quantize(gf)
        err = gf - q.float() * scale
        qsum = q.to(torch.int32)
        ssum = scale.reshape(1)
        if size > 1:  # int8 payload summed as int32; scales averaged
            dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=mesh.group)
            dist.all_reduce(ssum, op=dist.ReduceOp.SUM, group=mesh.group)
            ssum = ssum / size
        out = qsum.float() * ssum[0] / size
        red[name] = out.to(g.dtype)
        res[name] = err.to(r.dtype)
    return red, res


def init_residual(grads: dict, dtype=torch.float32) -> dict:
    """Zeros shaped like each of ``grads``, in ``dtype``, on its device."""
    return {name: torch.zeros(g.shape, dtype=dtype, device=g.device)
            for name, g in grads.items()}
