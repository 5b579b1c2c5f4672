"""Post-processing: audio-tag fusion (strategies 1, 2, 3) and box scaling,
as in the JAX package's ``models/postprocess.py``."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops import box_ops


class PostProcessResult(NamedTuple):
    scores: torch.Tensor  # [B, Q]
    labels: torch.Tensor  # [B, Q] int32
    boxes: torch.Tensor  # [B, Q, 2] (start, end) seconds, or (c, l) if is_semi


def postprocess(
    outputs: Dict[str, torch.Tensor],
    target_sizes: torch.Tensor,  # [B] seconds
    audio_tags: Optional[torch.Tensor] = None,  # [B, C] 0/1
    at_m: int = 2,
    is_semi: bool = False,
    threshold: Optional[float] = 0.5,
) -> PostProcessResult:
    logits, out_bbox = outputs["pred_logits"], outputs["pred_boxes"]
    q = logits.shape[1]
    cls_prob = torch.softmax(logits, dim=-1)[..., :-1]  # [B, Q, C]

    if audio_tags is not None:
        tags = audio_tags.to(cls_prob.dtype)[:, None, :]
        thr = 0.5 if threshold is None else threshold
        # best query per class
        is_best = F.one_hot(cls_prob.argmax(dim=1), q).transpose(1, 2).bool()  # [B, Q, C]
        if at_m == 1:
            cls_prob = cls_prob * tags
        elif at_m == 2:
            # clamp each class's best-query prob up to thr, then gate by the tag
            cls_prob = torch.where(is_best & (cls_prob < thr), thr, cls_prob) * tags
        elif at_m == 3:
            # clamp only where the tag is active; no multiply
            cls_prob = torch.where(is_best & (cls_prob < thr) & (tags > 0.5), thr, cls_prob)

    scores, labels = cls_prob.max(-1)
    if not is_semi:
        boxes = box_ops.box_cl_to_se(out_bbox) * target_sizes[:, None, None]
    else:
        boxes = out_bbox
    return PostProcessResult(scores=scores, labels=labels.int(), boxes=boxes)
