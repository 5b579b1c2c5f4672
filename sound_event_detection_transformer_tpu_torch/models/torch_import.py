"""ImageNet weights for the backbone from a torchvision ResNet checkpoint.

Counterpart of the JAX package's ``models/torch_import.py``.  A torchvision
``state_dict`` (``resnet50-*.pth``, or one wrapped as ``{"state_dict": ...}``)
is renamed onto :class:`.resnet.ResNetBackbone`: ``conv1``, ``bn1``,
``layerS.B.convK`` -> ``layerS_B.convK``, ``downsample.0`` / ``.1`` ->
``downsample_conv`` / ``downsample_bn``, and BatchNorm's ``weight``,
``bias``, ``running_mean`` and ``running_var`` -> ``FrozenBatchNorm``'s
``scale``, ``bias``, ``mean`` and ``var``.  Both sides keep convolutions in
OIHW, so values copy as they are.  The classifier (``fc.*``) and
``num_batches_tracked`` are dropped; ``conv0``, which torchvision lacks,
keeps its fresh init.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

BN_NAMES = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def torchvision_to_backbone(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision ResNet names -> :class:`.resnet.ResNetBackbone` names."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        parts = key.split(".")
        if parts[0] == "conv1" and parts[-1] == "weight":
            out["conv1.weight"] = val
        elif parts[0] == "bn1" and parts[1] in BN_NAMES:
            out[f"bn1.{BN_NAMES[parts[1]]}"] = val
        elif parts[0].startswith("layer"):
            block, rest = f"{parts[0]}_{parts[1]}", parts[2:]
            if rest[0].startswith("conv") and rest[-1] == "weight":
                out[f"{block}.{rest[0]}.weight"] = val
            elif rest[0].startswith("bn") and rest[1] in BN_NAMES:
                out[f"{block}.{rest[0]}.{BN_NAMES[rest[1]]}"] = val
            elif rest[0] == "downsample" and rest[1] == "0" and rest[-1] == "weight":
                out[f"{block}.downsample_conv.weight"] = val
            elif rest[0] == "downsample" and rest[1] == "1" and rest[2] in BN_NAMES:
                out[f"{block}.downsample_bn.{BN_NAMES[rest[2]]}"] = val
    return out


class ImportReport(NamedTuple):
    loaded: List[str]  # backbone names that took the checkpoint's values
    skipped: List[Tuple[str, Tuple[int, ...], Tuple[int, ...]]]  # (name, file shape, model shape)


def load_imagenet_backbone(backbone: torch.nn.Module, checkpoint_path: str,
                           log=None) -> ImportReport:
    """Copy a torchvision ``.pth`` into ``backbone`` (a ``ResNetBackbone``) in
    place.  Leaves whose shapes differ are skipped and reported (with
    ``log.warning`` when given); names the backbone lacks are ignored."""
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    own = backbone.state_dict()
    loaded: List[str] = []
    skipped: List = []
    with torch.no_grad():
        for name, val in torchvision_to_backbone(sd).items():
            if name not in own:
                continue
            if tuple(val.shape) != tuple(own[name].shape):
                skipped.append((name, tuple(val.shape), tuple(own[name].shape)))
                continue
            own[name].copy_(val.to(torch.float32))
            loaded.append(name)
    if log is not None and skipped:
        log.warning(f"{len(skipped)} backbone leaves of {checkpoint_path} skipped, their "
                    f"shapes differ (name, file, model): {skipped}")
    return ImportReport(loaded, skipped)



TORCHVISION_STAGES = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet34": ("basic", (3, 4, 6, 3)),
                      "resnet50": ("bottleneck", (3, 4, 6, 3)),
                      "resnet101": ("bottleneck", (3, 4, 23, 3))}


def torchvision_resnet_shapes(arch: str) -> Dict[str, Tuple[int, ...]]:
    """The names and shapes of torchvision's ``resnetNN().state_dict()``
    (classifier and ``num_batches_tracked`` included), in its order: what
    :func:`load_imagenet_backbone` reads."""
    kind, stages = TORCHVISION_STAGES[arch]
    expansion = 4 if kind == "bottleneck" else 1
    shapes: Dict[str, Tuple[int, ...]] = {"conv1.weight": (64, 3, 7, 7)}

    def bn(prefix: str, n: int) -> None:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{leaf}"] = (n,)
        shapes[f"{prefix}.num_batches_tracked"] = ()

    bn("bn1", 64)
    cin = 64
    for s, n_blocks in enumerate(stages):
        planes = 64 * 2 ** s
        for b in range(n_blocks):
            p = f"layer{s + 1}.{b}"
            if kind == "bottleneck":
                convs = [(planes, cin, 1), (planes, planes, 3), (planes * 4, planes, 1)]
            else:
                convs = [(planes, cin, 3), (planes, planes, 3)]
            for k, (o, i, w) in enumerate(convs, 1):
                shapes[f"{p}.conv{k}.weight"] = (o, i, w, w)
                bn(f"{p}.bn{k}", o)
            if b == 0 and (s > 0 or cin != planes * expansion):
                shapes[f"{p}.downsample.0.weight"] = (planes * expansion, cin, 1, 1)
                bn(f"{p}.downsample.1", planes * expansion)
            cin = planes * expansion
    shapes["fc.weight"] = (1000, cin)
    shapes["fc.bias"] = (1000,)
    return shapes
