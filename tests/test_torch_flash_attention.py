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


# ------------------------------------------------ the tensor-core variant's host side

DENSE = (8 * 752 * 256, 32, 256, 1)  # [B, S, H, D] projections seen as [B, H, S, D], D 32


@pytest.mark.parametrize("dtype,d,strides,offsets,want", [
    (torch.bfloat16, 32, DENSE, (0, 0, 0), "tensor"),
    (torch.bfloat16, 64, (4096, 64, 128, 1), (0, 0, 0), "tensor"),
    (torch.bfloat16, 128, (8192, 128, 256, 1), (16, 32, 48), "tensor"),
    (torch.bfloat16, 16, (4096, 16, 128, 1), (0, 0, 0), "f32"),  # D 16 stays on the f32 cores
    (torch.float32, 32, DENSE, (0, 0, 0), "f32"),
    (torch.float32, 128, (8192, 128, 256, 1), (0, 0, 0), "f32"),
    (torch.bfloat16, 32, DENSE, (0, 8, 0), "f32"),  # k on an 8- but not 16-byte boundary
    (torch.bfloat16, 32, (8 * 752 * 260, 32, 260, 1), (0, 0, 0), "f32"),  # row stride 4 mod 8
    (torch.bfloat16, 32, DENSE, (0, 0, 4), None),  # 4 bytes: neither kernel
    (torch.float32, 32, (1000, 32, 250, 1), (0, 0, 0), None),  # row stride 2 mod 4
    (torch.bfloat16, 32, (4096, 32, 1, 128), (0, 0, 0), None),  # the last dim strided
    (torch.bfloat16, 40, DENSE, (0, 0, 0), None),  # no such head dim
])
def test_kernel_variant_is_a_pure_function_of_type_dim_strides_and_address(
        dtype, d, strides, offsets, want):
    layouts = [(strides, 1 << 20 | off) for off in offsets]
    if want is None:
        with pytest.raises(ValueError):
            fa.kernel_variant(dtype, d, layouts)
    else:
        assert fa.kernel_variant(dtype, d, layouts) == want


def test_kernel_variant_of_real_tensors():
    """The projections' layout takes the tensor-core kernel; a view that
    starts 4 elements in is 8- but not 16-byte aligned and takes the other."""
    x = torch.zeros(2, 40, 4, 64, dtype=torch.bfloat16).transpose(1, 2)
    lay = lambda t: (t.stride(), t.data_ptr())
    assert fa.kernel_variant(x.dtype, 32, [lay(x[..., :32])] * 3) == "tensor"
    assert fa.kernel_variant(x.dtype, 32, [lay(x[..., 4:36])] * 3) == "f32"
    assert fa.kernel_variant(torch.float32, 32, [lay(x.float()[..., :32])] * 3) == "f32"


@pytest.mark.parametrize("blocks,sk,sms,want", [
    (8 * 8 * 6, 752, 132, (1, 768)),  # the long clip's encoder shape: the grid is full
    (8 * 8 * 1, 752, 132, (4, 192)),  # its cross shape: four ranges of three tiles
    (132, 752, 132, (1, 768)),  # one block an SM is full
    (131, 752, 132, (3, 256)),
    (8, 752, 132, (12, 64)),  # never more ranges than tiles
    (8, 64, 132, (1, 64)),  # one tile cannot be split
    (8, 40, 132, (1, 64)),
    (1, 65, 132, (2, 64)),  # a ragged second range of one key
    (64, 752, 64, (1, 768)),
    (16, 1000, 108, (8, 128)),
])
def test_key_splits(blocks, sk, sms, want):
    n, per = fa.key_splits(blocks, sk, sms)
    assert (n, per) == want
    assert per % fa.TILE_K == 0 and (n - 1) * per < sk <= n * per  # every range holds a key


def test_rows_per_block():
    assert [fa.rows_per_block(s) for s in (1, 41, 64, 65, 752)] == [64, 64, 64, 128, 128]


@pytest.mark.parametrize("bias_kind,keys_per_split", [("padding", 128), ("full", 64),
                                                      ("none", 192), ("masked_range", 128)])
def test_split_merge_matches_plain_and_pallas(bias_kind, keys_per_split):
    """The key split's arithmetic (per-range partials merged by the
    online-softmax rule) against the unsplit plain version and the Pallas
    kernel in interpret mode, 1e-5; ``masked_range`` pads every key of the
    second range (and, for clip 0, every key there is)."""
    sk = S + 40
    q, k, v, bias = _inputs(7, 2, 2, 41, sk, 32, "none" if bias_kind == "masked_range" else bias_kind)
    if bias_kind == "masked_range":
        pad = np.zeros((2, sk), bool)
        pad[0] = True
        pad[1, keys_per_split:2 * keys_per_split] = True
        bias = make_key_padding_bias(torch.from_numpy(pad)).numpy()
    got = fa.flash_attention_split_plain(_t(q), _t(k), _t(v), _t(bias), keys_per_split)
    assert torch.isfinite(got).all()
    plain = fa.flash_attention_plain(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    want = np.asarray(jflash_attention(_j(q), _j(k), _j(v), _j(bias), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if bias_kind == "masked_range":  # the all-padded clip is the uniform average
        np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(
            v[0].mean(1, keepdims=True), got[0].shape), rtol=1e-5, atol=1e-5)


def test_merge_weighs_a_masked_range_as_nothing():
    m = [torch.tensor([[0.5]]), torch.tensor([[-1.0e9]])]
    parts = [(m[0], torch.tensor([[2.0]]), torch.tensor([[4.0, 6.0]])),
             (m[1], torch.tensor([[128.0]]), torch.tensor([[1.0e3, -1.0e3]]))]
    torch.testing.assert_close(fa.merge_partials(parts), torch.tensor([[2.0, 3.0]]))
    both_masked = [(m[1], torch.tensor([[2.0]]), torch.tensor([[2.0, 4.0]])),
                   (m[1], torch.tensor([[2.0]]), torch.tensor([[6.0, 0.0]]))]
    torch.testing.assert_close(fa.merge_partials(both_masked), torch.tensor([[2.0, 1.0]]))


def test_hi_lo_split_of_the_probabilities_keeps_f32_accuracy():
    """P = P_hi + P_lo in bf16, both multiplied with bf16 V into f32, against
    the f32 product: 2e-5, where one rounding of P gives bf16 level."""
    rs = np.random.RandomState(8)
    p = torch.softmax(torch.from_numpy(rs.randn(64, 752).astype(np.float32)) * 3, dim=-1)
    p = p / p.amax(dim=-1, keepdim=True)  # as the kernel holds them: exp(s - m), at most 1
    v = torch.from_numpy(rs.randn(752, 32).astype(np.float32)).bfloat16().float()
    hi, lo = fa.split_hi_lo(p)
    assert hi.dtype == lo.dtype == torch.bfloat16
    exact = (p.double() @ v.double()).float()
    two = hi.float() @ v + lo.float() @ v
    one = hi.float() @ v
    scale = float(exact.abs().max())
    assert float((two - exact).abs().max()) <= 2e-5 * scale
    assert float((one - exact).abs().max()) > 1e-4 * scale  # a single rounding is not enough
    np.testing.assert_allclose((hi.float() + lo.float()).numpy(), p.numpy(), rtol=2e-5, atol=0)
