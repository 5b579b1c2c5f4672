"""SP-SEDT patch crops on the device: crop and bilinear resize inside the step.

Counterpart of the JAX package's ``ops/patches.py``.  The patch boxes ride
along as the batch's dense targets, and the crops are gathered from the
features on the device, so no second [B, P, 128, 64] tensor crosses from the
host every step.  Plain tensor indexing (two row gathers and a lerp): the
JAX package does this outside any Pallas kernel.

It reproduces the host crop (``data.transforms.extract_patches``): the host
min/max-normalises each crop before the bilinear resample and undoes it
after; bilinear interpolation is affine-equivariant, so that round trip
cancels and is left out here.
"""
from __future__ import annotations

import torch


def extract_patches_device(
    feats: torch.Tensor,  # [B, T, F, 1]
    boxes: torch.Tensor,  # [B, P, 2] (center, length) normalized to T
    out_t: int = 128,
    out_f: int = 64,
) -> torch.Tensor:
    """[B, P, out_t, out_f, 1] crops of ``feats`` at ``boxes``.

    * frames ``s = floor((c - l/2) * T)`` to ``e = floor((c + l/2) * T)``;
    * an empty crop (``s >= e``) grows to ``(max(0, s - 1), min(T, e + 1))``;
    * bilinear resize with half-pixel centres (``align_corners=False``)
      along T, and along F when ``F != out_f``.
    """
    b, t, f, _ = feats.shape
    x = feats[..., 0]  # [B, T, F]
    c, length = boxes[..., 0], boxes[..., 1]
    s = torch.floor((c - length / 2.0) * t).long()  # [B, P]
    e = torch.floor((c + length / 2.0) * t).long()
    empty = s >= e
    s = torch.where(empty, (s - 1).clamp(min=0), s)
    e = torch.where(empty, (e + 1).clamp(max=t), e)
    tp = (e - s).to(feats.dtype)  # [B, P] crop lengths

    j = torch.arange(out_t, dtype=feats.dtype, device=feats.device)
    yi = (j[None, None, :] + 0.5) * tp[..., None] / out_t - 0.5  # [B, P, out_t]
    tmax = tp[..., None] - 1.0
    y0 = torch.minimum(torch.floor(yi).clamp(min=0.0), tmax)
    wy = (yi - y0).clamp(0.0, 1.0)[..., None]  # [B, P, out_t, 1]
    y0i = y0.long()
    y1i = torch.minimum(y0i + 1, tmax.long()).clamp(min=0)
    rows = torch.arange(b, device=feats.device)[:, None, None]
    # a box past the clip's end reads its last frame, as JAX's gather clamps
    r0 = x[rows, (y0i + s[..., None]).clamp(0, t - 1)]  # [B, P, out_t, F]
    r1 = x[rows, (y1i + s[..., None]).clamp(0, t - 1)]
    out = r0 * (1.0 - wy) + r1 * wy

    if f != out_f:
        xi = (torch.arange(out_f, dtype=feats.dtype, device=feats.device) + 0.5) * f / out_f - 0.5
        x0 = torch.floor(xi).long().clamp(0, f - 1)
        x1 = (x0 + 1).clamp(0, f - 1)
        wx = (xi - x0.to(feats.dtype)).clamp(0.0, 1.0)
        out = out[..., x0] * (1.0 - wx) + out[..., x1] * wx
    return out[..., None]
