"""Device-side data augmentation: mixup, time/freq masks, freq shift, noise.

Counterpart of the JAX package's ``ops/augment.py``, with its deliberate
deviations from the upstream host transforms (each sample keeps its slot in
the batch and its strong/weak flag may flip; the frequency shift is clipped,
not redrawn).  Each function is a **draw** from a ``torch.Generator`` (on
the batch's device) followed by an **apply** that takes the draws, so that
the apply can be held against the JAX package on JAX's own draws: uniforms
in [0, 1) and standard normals, turned into ranges inside the apply as
``jax.random.uniform(minval, maxval)`` turns its uniforms.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.criterion import DenseTargets
from . import box_ops


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B, ...] -> broadcastable against an ``ndim``-dim tensor."""
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


# ------------------------------------------------------------------ noise


class NoiseDraws(NamedTuple):
    apply: torch.Tensor  # [B] uniform
    noise: torch.Tensor  # feats.shape standard normal


def noise_draws(feats: torch.Tensor, generator: Optional[torch.Generator]) -> NoiseDraws:
    dev = feats.device
    return NoiseDraws(torch.rand(feats.shape[:1], generator=generator, device=dev),
                      torch.randn(feats.shape, generator=generator, device=dev))


def gaussian_noise_pair_apply(feats: torch.Tensor, d: NoiseDraws, snr: float = 30.0,
                              p: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(clean, noisy): noise of std sqrt(mean_t(x^2) * 10^(-snr/10)) per
    frequency bin, added to the clips whose draw is below ``p``."""
    std = torch.sqrt(torch.mean(feats**2, dim=1, keepdim=True) * 10.0 ** (-snr / 10.0))
    apply = _expand(d.apply < p, feats.dim())
    return feats, torch.where(apply, feats + d.noise * std, feats)


def gaussian_noise_pair(feats: torch.Tensor, generator: Optional[torch.Generator],
                        snr: float = 30.0, p: float = 0.5):
    return gaussian_noise_pair_apply(feats, noise_draws(feats, generator), snr, p)


# ------------------------------------------------------------------ masks


class BandDraws(NamedTuple):
    apply: torch.Tensor  # [B] uniform
    length: torch.Tensor  # [B] uniform, scaled to the band's fraction
    start: torch.Tensor  # [B] uniform, scaled to the band's start


def band_draws(batch: int, generator: Optional[torch.Generator],
               device: torch.device) -> BandDraws:
    return BandDraws(*(torch.rand(batch, generator=generator, device=device) for _ in range(3)))


def _band(d: BandDraws, n: int, p: float, lo: float, hi: float) -> torch.Tensor:
    """[B, n] bool: the contiguous band to fill on the clips that apply."""
    frac = torch.clamp(d.length * (hi - lo) + lo, min=lo)
    start = d.start * (1.0 - frac)
    size = (frac * n).to(torch.int32)
    first = (start * n).to(torch.int32)
    idx = torch.arange(n, device=d.apply.device)[None, :]
    in_band = (idx >= first[:, None]) & (idx < (first + size)[:, None])
    return in_band & (d.apply < p)[:, None]


def time_mask_apply(feats: torch.Tensor, d: BandDraws, p: float = 0.2,
                    min_band_part: float = 0.0, max_band_part: float = 0.1) -> torch.Tensor:
    """A random contiguous time span zeroed."""
    kill = _band(d, feats.shape[1], p, min_band_part, max_band_part)
    return torch.where(_expand(kill, feats.dim()), 0.0, feats)


def time_mask(feats: torch.Tensor, generator: Optional[torch.Generator], p: float = 0.2,
              min_band_part: float = 0.0, max_band_part: float = 0.1) -> torch.Tensor:
    d = band_draws(feats.shape[0], generator, feats.device)
    return time_mask_apply(feats, d, p, min_band_part, max_band_part)


def freq_mask_apply(feats: torch.Tensor, d: BandDraws, p: float = 0.5,
                    min_mask_fraction: float = 0.03, max_mask_fraction: float = 0.4,
                    fill_constant: float = 0.0) -> torch.Tensor:
    """A random contiguous mel band filled with ``fill_constant``."""
    kill = _band(d, feats.shape[2], p, min_mask_fraction, max_mask_fraction)
    return torch.where(_expand(kill[:, None, :], feats.dim()), fill_constant, feats)


def freq_mask(feats: torch.Tensor, generator: Optional[torch.Generator], p: float = 0.5,
              min_mask_fraction: float = 0.03, max_mask_fraction: float = 0.4,
              fill_constant: float = 0.0) -> torch.Tensor:
    d = band_draws(feats.shape[0], generator, feats.device)
    return freq_mask_apply(feats, d, p, min_mask_fraction, max_mask_fraction, fill_constant)


class ShiftDraws(NamedTuple):
    apply: torch.Tensor  # [B] uniform
    shift: torch.Tensor  # [B] standard normal


def shift_draws(batch: int, generator: Optional[torch.Generator],
                device: torch.device) -> ShiftDraws:
    return ShiftDraws(torch.rand(batch, generator=generator, device=device),
                      torch.randn(batch, generator=generator, device=device))


def freq_shift_apply(feats: torch.Tensor, d: ShiftDraws, p: float = 0.5, max_band: int = 4,
                     std: float = 2.0) -> torch.Tensor:
    """Roll along the mel axis by round(N(0, std)) clipped to +-max_band,
    zero-filled, on the clips that apply."""
    f = feats.shape[2]
    shift = torch.clamp(torch.round(d.shift * std), -max_band, max_band).to(torch.long)
    shift = torch.where(d.apply < p, shift, 0)
    src = torch.arange(f, device=feats.device)[None, :] - shift[:, None]  # [B, F]
    valid = (src >= 0) & (src < f)
    idx = _expand(src.clamp(0, f - 1)[:, None, :], feats.dim()).expand(
        (-1, feats.shape[1], -1) + feats.shape[3:])
    gathered = feats.gather(2, idx)
    return torch.where(_expand(valid[:, None, :], feats.dim()), gathered, 0.0)


def freq_shift(feats: torch.Tensor, generator: Optional[torch.Generator], p: float = 0.5,
               max_band: int = 4, std: float = 2.0) -> torch.Tensor:
    d = shift_draws(feats.shape[0], generator, feats.device)
    return freq_shift_apply(feats, d, p, max_band, std)


# ------------------------------------------------------------------ mixup


def _has_same_class_overlap(labels: torch.Tensor, boxes: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """[B] bool: two valid same-class events of a clip overlap or touch
    (i != j, s_i <= s_j and e_i >= s_j)."""
    se = box_ops.box_cl_to_se(boxes)
    s, e = se[..., 0], se[..., 1]
    same = ((labels[:, :, None] == labels[:, None, :])
            & valid[:, :, None] & valid[:, None, :])
    m = labels.shape[1]
    not_self = ~torch.eye(m, dtype=torch.bool, device=labels.device)
    pair = (s[:, :, None] <= s[:, None, :]) & (e[:, :, None] >= s[:, None, :])
    return (same & not_self & pair).flatten(1).any(dim=1)


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, M, ...] gathered along dim 1 by idx [B, M]."""
    idx = _expand(idx, arr.dim()).expand(idx.shape + arr.shape[2:])
    return arr.gather(1, idx)


def _compact(t: DenseTargets) -> DenseTargets:
    """Stable-sort each sample's rows so that label-valid rows come first."""
    order = torch.argsort((~t.label_valid).to(torch.uint8), dim=1, stable=True)
    return DenseTargets(*(_take(x, order) for x in t[:5]), t.orig_size)


def concat_targets(t1: DenseTargets, t2: DenseTargets, lam: torch.Tensor) -> DenseTargets:
    """Dense label-set union: t1's rows first (ratio *= lam), then t2's
    (ratio *= 1 - lam), cut at the capacity M."""
    t1c, t2c = _compact(t1), _compact(t2)
    m = t1.labels.shape[1]
    n1 = t1c.label_valid.sum(-1)  # [B]
    d = torch.arange(m, device=n1.device)[None, :]
    from_t1 = d < n1[:, None]
    j2 = (d - n1[:, None]).clamp(0, m - 1)

    def pick(a1, a2):
        return torch.where(_expand(from_t1, a1.dim()), a1, a2)

    after = d >= n1[:, None]
    labels = pick(t1c.labels, _take(t2c.labels, j2))
    boxes = pick(t1c.boxes, _take(t2c.boxes, j2))
    box_valid = pick(t1c.box_valid, _take(t2c.box_valid, j2) & after)
    label_valid = pick(t1c.label_valid, _take(t2c.label_valid, j2) & after)
    ratio = pick(lam * t1c.ratio, (1 - lam) * _take(t2c.ratio, j2))
    ratio = torch.where(label_valid, ratio, 1.0)
    labels = torch.where(label_valid, labels, 0)
    boxes = torch.where(label_valid[..., None], boxes, 0.0)
    return DenseTargets(labels, boxes, box_valid & label_valid, label_valid, ratio,
                        t1.orig_size)


def _select_targets(mask: torch.Tensor, a: DenseTargets, b: DenseTargets) -> DenseTargets:
    """Per-sample select: a where mask else b (orig_size kept from b)."""
    return DenseTargets(*(torch.where(_expand(mask, x.dim()), x, y)
                          for x, y in zip(a[:5], b[:5])), b.orig_size)


class MixupDraws(NamedTuple):
    lam: torch.Tensor  # [] mixing weight, Beta(alpha, alpha)
    perm: Optional[torch.Tensor] = None  # [B] partner of each clip (mixup only)


def mixup_draws(batch: int, generator: Optional[torch.Generator], device: torch.device,
                alpha: float = 1.0, permute: bool = True) -> MixupDraws:
    """lam ~ Beta(alpha, alpha) as G1 / (G1 + G2) of two Gamma(alpha) draws
    (1 when alpha <= 0), and a random permutation of the batch."""
    if alpha > 0:
        g = torch._standard_gamma(torch.full((2,), float(alpha), device=device),
                                  generator=generator)
        lam = g[0] / (g[0] + g[1])
    else:
        lam = torch.ones((), device=device)
    perm = torch.randperm(batch, generator=generator, device=device) if permute else None
    return MixupDraws(lam, perm)


def mixup_apply(feats: torch.Tensor, targets: DenseTargets, strong_flag: torch.Tensor,
                weak_flag: torch.Tensor, d: MixupDraws, mix_up_ratio: float = 0.5,
                max_events: int = 20):
    """Pairwise spectrogram mixup with label-set union.

    The first ``int(B * mix_up_ratio)`` clips mix with their partner
    ``perm``; a candidate falls back to the unmixed donor when the union
    holds more than ``max_events`` events or two same-class events overlap.
    Returns (feats, targets, strong_flag, weak_flag).
    """
    b = feats.shape[0]
    mix_num = int(b * mix_up_ratio)
    if mix_num == 0:
        return feats, targets, strong_flag, weak_flag
    lam = d.lam
    f2 = feats[d.perm]
    t2 = DenseTargets(*(x[d.perm] for x in targets))

    n1 = targets.box_valid.sum(-1)
    n2 = t2.box_valid.sum(-1)
    mixed = lam * feats + (1 - lam) * f2
    union = concat_targets(targets, t2, lam)
    overlap = _has_same_class_overlap(union.labels, union.boxes, union.box_valid)
    too_many = (n1 + n2) > max_events
    one_empty = (n1 == 0) | (n2 == 0)
    both_empty = (n1 == 0) & (n2 == 0)
    in_mix = torch.arange(b, device=feats.device) < mix_num

    keep_t2 = one_empty & (n1 == 0) & (n2 > 0)
    reject = ~one_empty & (too_many | overlap)
    accept = in_mix & ~reject & (both_empty | ~one_empty)
    use_t2 = in_mix & keep_t2 & ~accept

    out_feats = torch.where(_expand(accept, feats.dim()), mixed, feats)
    out_feats = torch.where(_expand(use_t2, feats.dim()), f2, out_feats)
    out_t = _select_targets(accept, union, _select_targets(use_t2, t2, targets))
    has_boxes = out_t.box_valid.sum(-1) > 0
    has_labels = out_t.label_valid.sum(-1) > 0
    new_strong = torch.where(in_mix, has_boxes, strong_flag)
    new_weak = torch.where(in_mix, ~has_boxes & has_labels, weak_flag)
    return out_feats, out_t, new_strong, new_weak


def mixup(feats: torch.Tensor, targets: DenseTargets, strong_flag: torch.Tensor,
          weak_flag: torch.Tensor, generator: Optional[torch.Generator],
          mix_up_ratio: float = 0.5, alpha: float = 1.0, max_events: int = 20):
    d = mixup_draws(feats.shape[0], generator, feats.device, alpha)
    return mixup_apply(feats, targets, strong_flag, weak_flag, d, mix_up_ratio, max_events)


def mixup_label_unlabel_apply(feats_labeled: torch.Tensor, feats_unlabeled: torch.Tensor,
                              targets_labeled: DenseTargets, targets_pseudo: DenseTargets,
                              d: MixupDraws, mix_up_ratio: float = 0.5,
                              max_events: int = 20):
    """Mix labeled clips into the head of the unlabeled (pseudo-labeled)
    stream.  A reject falls back to the labeled donor on overlap and to the
    pseudo target on a count overflow when it has boxes.  Returns (student
    feats, pseudo targets)."""
    b = feats_unlabeled.shape[0]
    nb = min(b, feats_labeled.shape[0])
    nmix = int(nb * mix_up_ratio)
    if nmix == 0:
        return feats_unlabeled, targets_pseudo
    lam = d.lam
    f1, f2 = feats_labeled[:nb], feats_unlabeled[:nb]
    t1 = DenseTargets(*(x[:nb] for x in targets_labeled))
    t2 = DenseTargets(*(x[:nb] for x in targets_pseudo))

    mixed = lam * f1 + (1 - lam) * f2
    union = concat_targets(t1, t2, lam)
    overlap = _has_same_class_overlap(union.labels, union.boxes, union.box_valid)
    n1b, n2b = t1.box_valid.sum(-1), t2.box_valid.sum(-1)
    too_many = (n1b + n2b) > max_events
    in_mix = torch.arange(nb, device=f1.device) < nmix
    keep_t2 = too_many & (n2b > 0)
    accept = in_mix & ~too_many & ~overlap
    use_t1 = in_mix & ~accept & ~keep_t2

    head = torch.where(_expand(accept, f1.dim()), mixed, f2)
    head = torch.where(_expand(use_t1, f1.dim()), f1, head)
    head_t = _select_targets(accept, union, _select_targets(use_t1, t1, t2))
    out_t = DenseTargets(*(torch.cat([h, rest[nb:]], dim=0)
                           for h, rest in zip(head_t, targets_pseudo)))
    return torch.cat([head, feats_unlabeled[nb:]], dim=0), out_t


def mixup_label_unlabel(feats_labeled: torch.Tensor, feats_unlabeled: torch.Tensor,
                        targets_labeled: DenseTargets, targets_pseudo: DenseTargets,
                        generator: Optional[torch.Generator], mix_up_ratio: float = 0.5,
                        alpha: float = 1.0, max_events: int = 20):
    d = mixup_draws(feats_unlabeled.shape[0], generator, feats_unlabeled.device, alpha,
                    permute=False)
    return mixup_label_unlabel_apply(feats_labeled, feats_unlabeled, targets_labeled,
                                     targets_pseudo, d, mix_up_ratio, max_events)
