"""The port's SP-SEDT patch crop on the device (``ops/patches.py``) against
the JAX package's ``extract_patches_device`` and against the port's host
crop (``data.transforms.extract_patches``), on the same numpy-seeded
features and boxes.

Tolerance atol 2e-5, as the JAX package's own test of its two crops: the
host crop min/max-normalises each patch before the resample and undoes it
after, which moves an f32 value by a few ulps of the features' range; the
two device crops do the same f32 arithmetic in the same order and agree to
about 1e-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.ops.patches import (
    extract_patches_device as jax_extract_patches_device,
)
from sound_event_detection_transformer_tpu_torch.data.transforms import (
    extract_patches,
    get_random_patch_boxes,
)
from sound_event_detection_transformer_tpu_torch.ops.patches import extract_patches_device

ATOL = 2e-5


def both(feats, boxes):
    """(the port's crops, JAX's crops) as numpy [B, P, 128, 64]."""
    got = extract_patches_device(torch.from_numpy(feats[..., None]), torch.from_numpy(boxes))
    want = jax_extract_patches_device(jnp.asarray(feats[..., None]), jnp.asarray(boxes))
    assert got.shape == tuple(want.shape) == boxes.shape[:2] + (128, 64, 1)
    return got[..., 0].numpy(), np.asarray(want[..., 0])


@pytest.mark.parametrize("t, f", [(128, 64), (496, 64), (100, 48)])
def test_device_crop_matches_jax_and_the_host_crop(t, f):
    rng = np.random.RandomState(t + f)
    b, p = 3, 5
    feats = rng.randn(b, t, f).astype(np.float32)
    boxes = np.stack([get_random_patch_boxes(t, p, rng=np.random.RandomState(i))
                      for i in range(b)])
    got, want = both(feats, boxes)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    host = np.stack([extract_patches(feats[i], boxes[i]) for i in range(b)])
    np.testing.assert_allclose(got, host, rtol=0, atol=ATOL)


def test_empty_box_guard():
    """Zero-length boxes widen by a frame on each side, clamped to the clip,
    as the host crop does."""
    feats = np.random.RandomState(1).randn(1, 64, 64).astype(np.float32)
    boxes = np.array([[[0.5, 0.0], [0.0, 0.0], [1.0, 0.0]]], np.float32)
    got, want = both(feats, boxes)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[0], extract_patches(feats[0], boxes[0]), rtol=0, atol=ATOL)

