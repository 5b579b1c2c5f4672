"""Kernel K4 of the PyTorch port (ops/flash_attention.py) on the CPU, where the
wrapper runs the kernel's plain blockwise version, against the JAX package's
Pallas flash kernel in interpret mode on the same numpy inputs.  The CUDA
kernel is held against the plain version on the card by ``test_torch_gpu.py``
and ``chip_smoke.py``.

Tolerances: forward 1e-5 in f32 (both sides keep an f32 running maximum, sum
and accumulator and differ only in the order of the sums); gradients 1e-4
(the backward recomputes the non-flash math, whose [Sq, Sk] products sum in
another order on the two sides); bf16 inputs one bf16 rounding of the output
(1e-2) against the plain version, bf16-level (3e-2) against the non-flash
path, which rounds the probabilities to bf16 before the second product."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.ops.attention import (
    make_key_padding_bias as jmake_bias,
)
from sound_event_detection_transformer_tpu.ops.attention import (
    scaled_dot_attention as jscaled_dot_attention,
)
from sound_event_detection_transformer_tpu.ops.pallas.flash_attention import (
    flash_attention as jflash_attention,
)
from sound_event_detection_transformer_tpu_torch.ops import flash_attention as fa
from sound_event_detection_transformer_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ,
    make_key_padding_bias,
    scaled_dot_attention,
)

torch.set_num_threads(2)
S = FLASH_MIN_SEQ + 8  # ragged: not a multiple of the key block


def _inputs(seed, b, h, sq, sk, d, bias_kind):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, sq, d).astype(np.float32)
    k = rs.randn(b, h, sk, d).astype(np.float32)
    v = rs.randn(b, h, sk, d).astype(np.float32)
    if bias_kind == "none":
        bias = None
    elif bias_kind == "full":
        bias = rs.randn(b, h, sq, sk).astype(np.float32)
    else:
        bias = np.array(jmake_bias(jnp.asarray(rs.rand(b, sk) < 0.2)))  # a writable copy
    return q, k, v, bias


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("sq,bias_kind", [(S, "padding"), (S, "full"), (S, "none"),
                                          (40, "padding")])
def test_plain_matches_pallas_flash_kernel(sq, bias_kind):
    q, k, v, bias = _inputs(0, 1, 2, sq, S, 32, bias_kind)
    want = np.asarray(jflash_attention(_j(q), _j(k), _j(v), _j(bias), interpret=True))
    fa.flash_attention.launches = 0
    got = fa.flash_attention(_t(q), _t(k), _t(v), _t(bias))
    assert fa.flash_attention.launches == 0  # CPU tensors never launch the kernel
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and the explicit plain version is what the wrapper ran
    plain = fa.flash_attention_plain(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("with_bias", [False, True])
def test_gradients_match_jax_flash_path(with_bias):
    """Mirror of the JAX package's flash gradient test: d 40, S ragged."""
    q, k, v, bias = _inputs(0, 1, 2, S, S, 40, "padding" if with_bias else "none")
    w = np.random.RandomState(1).randn(*q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        return (jflash_attention(q_, k_, v_, _j(bias), interpret=True) * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    (fa.flash_attention(*leaves, _t(bias)) * _t(w)).sum().backward()
    for got, ref in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_bias_gradient_is_the_non_flash_paths():
    q, k, v, bias = (_t(x) for x in _inputs(2, 2, 2, 9, 70, 16, "full"))
    grads = []
    for fn in (fa.flash_attention, fa.reference_attention):
        leaf = bias.clone().requires_grad_()
        fn(q, k, v, leaf).square().sum().backward()
        grads.append(leaf.grad)
    assert grads[0].shape == bias.shape
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)


def test_flash_path_against_non_flash_path_on_both_sides():
    """``use_flash=True`` on the CPU runs the blockwise version; both packages'
    flash paths agree with their non-flash paths, f32, 2e-5 as the JAX test."""
    q, k, v, bias = _inputs(3, 2, 2, 40, 150, 32, "padding")
    got = scaled_dot_attention(_t(q), _t(k), _t(v), _t(bias), use_flash=True)
    ref = scaled_dot_attention(_t(q), _t(k), _t(v), _t(bias), use_flash=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    jref = jscaled_dot_attention(_j(q), _j(k), _j(v), _j(bias), use_flash=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=2e-5, atol=2e-5)


def test_fully_padded_keys_give_the_plain_paths_average_not_nan():
    q, k, v, _ = _inputs(4, 2, 2, 5, 140, 16, "none")
    pad = np.zeros((2, 140), bool)
    pad[0] = True  # every key of clip 0 is padded
    pad[1, 100:] = True
    bias = make_key_padding_bias(torch.from_numpy(pad))
    got = fa.flash_attention(_t(q), _t(k), _t(v), bias)
    ref = fa.reference_attention(_t(q), _t(k), _t(v), bias)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(v[0].mean(1, keepdims=True),
                                                               got[0].shape), rtol=1e-5, atol=1e-5)


def test_bf16_inputs_f32_state():
    """Under autocast q, k, v arrive in bf16 and the bias in f32."""
    q, k, v, bias = (_t(x) for x in _inputs(5, 1, 2, 33, S, 32, "padding"))
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    got = fa.flash_attention(qb, kb, vb, bias)
    assert got.dtype == torch.bfloat16
    exact = fa.flash_attention_plain(qb.float(), kb.float(), vb.float(), bias)
    torch.testing.assert_close(got.float(), exact, rtol=1e-2, atol=1e-2)
    non_flash = fa.reference_attention(qb, kb, vb, bias)
    torch.testing.assert_close(got.float(), non_flash.float(), rtol=3e-2, atol=3e-2)


def test_launch_count_unchanged_and_apply_works_under_inference_mode():
    q, k, v, bias = (_t(x) for x in _inputs(6, 1, 1, 4, 20, 16, "padding"))
    before = fa.flash_attention.launches
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v, bias)
    assert out.shape == q.shape and fa.flash_attention.launches == before


def test_wrapper_rejects_bad_input():
    q = torch.zeros(1, 2, 4, 16)
    k = torch.zeros(1, 2, 6, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q[0], k[0], k[0])  # not 4-D
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, torch.zeros(1, 2, 7, 16))  # k and v disagree
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), k)  # mixed types
    with pytest.raises(TypeError):
        fa.flash_attention(q, k, k, torch.zeros(1, 1, 1, 6, dtype=torch.bfloat16))
    with pytest.raises(RuntimeError):
        fa.flash_attention(q, k, k, torch.zeros(1, 1, 1, 5))  # bias not broadcastable
