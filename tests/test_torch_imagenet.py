"""The port's ImageNet backbone import (``models/torch_import.py``) against
the JAX package's ``load_imagenet_backbone`` followed by
``weights.from_flax``, on a torchvision-layout resnet18 ``state_dict`` that
the test draws from a seed (no download): leaf for leaf, exactly (both sides
copy float32 values).  Also a checkpoint wrapped in ``{"state_dict": ...}``, a
leaf whose shape differs (skipped and reported), and the trainer's
``<data_root>/<backbone>.pth`` auto path."""
import contextlib
import io
import logging

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.config import SEDTConfig as JSEDTConfig
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.models.torch_import import (
    load_imagenet_backbone as jload,
)
from sound_event_detection_transformer_tpu_torch import cli, train_lib
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig
from sound_event_detection_transformer_tpu_torch.models import build_model
from sound_event_detection_transformer_tpu_torch.models.resnet import ResNetBackbone
from sound_event_detection_transformer_tpu_torch.models.torch_import import (
    load_imagenet_backbone,
    torchvision_resnet_shapes,
    torchvision_to_backbone,
)
from sound_event_detection_transformer_tpu_torch.weights import from_flax

torch.set_num_threads(2)


def seeded_state_dict(arch="resnet18", seed=0):
    rng = np.random.RandomState(seed)
    sd = {}
    for name, shape in torchvision_resnet_shapes(arch).items():
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.tensor(7)
        elif name.endswith("running_var"):
            sd[name] = torch.from_numpy(rng.rand(*shape).astype(np.float32) + 0.5)
        else:
            sd[name] = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.1)
    return sd


@pytest.fixture(scope="module")
def jax_init():
    """The JAX trainer's tiny model, initialised: (params, frozen) as numpy."""
    cfg = JSEDTConfig.tiny_test()
    model, _ = jbuild(cfg)
    m = cfg.model
    v = jax.jit(lambda r: model.init({"params": r, "dropout": r},
                                     jnp.zeros((1, m.max_frames, m.n_mels, 1)),
                                     jnp.zeros((1, m.max_frames), bool), True))(
        jax.random.PRNGKey(0))
    tree = lambda t: jax.tree.map(np.asarray, flax.core.unfreeze(t))
    return tree(v["params"]), tree(v["frozen"])


def port_model(params, frozen):
    model, _ = build_model(SEDTConfig.tiny_test(), device="cpu")
    model.load_state_dict(from_flax(params, frozen), strict=True)
    return model


@pytest.mark.parametrize("wrapped", [False, True])
def test_import_matches_jax(jax_init, tmp_path, wrapped):
    sd = seeded_state_dict()
    path = tmp_path / "resnet18.pth"
    torch.save({"state_dict": sd} if wrapped else sd, path)
    params, frozen = jax_init
    model = port_model(params, frozen)
    conv0 = model.backbone.conv0.weight.detach().clone()
    report = load_imagenet_backbone(model.backbone, str(path))
    want = from_flax(*jload(params, frozen, str(path)))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    # every backbone leaf but conv0 came from the file
    own = set(ResNetBackbone("resnet18").state_dict())
    assert set(report.loaded) == own - {"conv0.weight", "conv0.bias"} and not report.skipped
    assert torch.equal(model.backbone.conv0.weight, conv0)
    assert torch.equal(model.backbone.layer2_0.downsample_bn.var, sd["layer2.0.downsample.1.running_var"])
    assert torch.equal(model.backbone.layer4_1.conv2.weight, sd["layer4.1.conv2.weight"])


def test_shape_mismatch_is_skipped_and_reported(jax_init, tmp_path):
    sd = seeded_state_dict(seed=1)
    sd["layer3.0.conv1.weight"] = torch.zeros(256, 128, 1, 1)  # a bottleneck's shape
    sd["bn1.running_mean"] = torch.zeros(32)
    path = tmp_path / "odd.pth"
    torch.save(sd, path)
    params, frozen = jax_init
    model = port_model(params, frozen)
    before = model.backbone.layer3_0.conv1.weight.detach().clone()
    records = []
    log = logging.getLogger("test_torch_imagenet")
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    log.addHandler(handler)
    try:
        report = load_imagenet_backbone(model.backbone, str(path), log=log)
    finally:
        log.removeHandler(handler)
    assert report.skipped == [("bn1.mean", (32,), (64,)),
                              ("layer3_0.conv1.weight", (256, 128, 1, 1), (256, 128, 3, 3))]
    assert records and "2 backbone leaves" in records[0]
    assert torch.equal(model.backbone.layer3_0.conv1.weight, before)
    want = from_flax(*jload(params, frozen, str(path)))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_names_cover_the_backbone():
    """Every torchvision leaf but the classifier and the BN counters has a
    place in the port's backbone, at its shape, for both block kinds."""
    for arch in ("resnet18", "resnet50"):
        shapes = torchvision_resnet_shapes(arch)
        mapped = torchvision_to_backbone({k: torch.zeros(s) for k, s in shapes.items()})
        own = ResNetBackbone(arch).state_dict()
        assert set(own) - set(mapped) == {"conv0.weight", "conv0.bias"}
        assert all(tuple(v.shape) == tuple(own[k].shape) for k, v in mapped.items())
        kept = [k for k in shapes if not k.startswith("fc.") and "num_batches" not in k]
        assert len(mapped) == len(kept)


@pytest.mark.parametrize("how", ["auto", "flag", "none"])
def test_trainer_finds_the_checkpoint(tmp_path, how):
    """``--imagenet_backbone`` names the file; without it the trainer takes
    ``<data_root>/<backbone>.pth`` when present, else warns and trains the
    backbone from scratch."""
    sd = seeded_state_dict(seed=2)
    root = tmp_path / "data"
    root.mkdir()
    argv = ["--dataname", "urbansed", "--backbone", "resnet18", "--data_root", str(root)]
    if how == "auto":
        torch.save(sd, root / "resnet18.pth")
    elif how == "flag":
        torch.save(sd, tmp_path / "elsewhere.pth")
        argv += ["--imagenet_backbone", str(tmp_path / "elsewhere.pth")]
    args = cli.sedt_args(argv)
    model, _ = build_model(SEDTConfig.tiny_test(), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    records = []
    log = logging.getLogger("test_torch_imagenet.trainer")
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    log.addHandler(handler)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            path = train_lib._imagenet_backbone_init(model, args, log)
    finally:
        log.removeHandler(handler)
    if how == "none":
        assert path is None and "FROM SCRATCH" in records[0]
        assert not torch.equal(model.backbone.conv1.weight, sd["conv1.weight"])
    else:
        assert path == str(root / "resnet18.pth" if how == "auto" else tmp_path / "elsewhere.pth")
        assert torch.equal(model.backbone.conv1.weight, sd["conv1.weight"])
        assert torch.equal(model.backbone.bn1.var, sd["bn1.running_var"])
