"""K1's f32 route (split TF32 on the tensor cores) emulated on the CPU,
held against the JAX package.

The CUDA kernel runs each f32 product of S = Q K^T and O = P V as three
TF32 products: every operand element x is split into hi = tf32(x) and
lo = tf32(x - hi) (``cvt.rna.tf32.f32``: round to nearest, ties away from
zero, to 10 mantissa bits) and a.b is taken as lo.hi' + hi.lo' + hi.hi'
with f32 accumulation.  Here the same split runs in torch on the int32
view, the rest of the forward is the plain version's arithmetic, and O
and LSE must stay within the f32 bar (2e-5, the JAX suite's) of the
Pallas ``_fwd_call`` in interpret mode and of
``flash_attention_fwd_plain``, while one TF32 product misses it.  The
same file checks the wrapper's 16-byte alignment rule on CPU tensors.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.ops.attention import _fwd_call
from learningorchestra_tpu_torch.ops import attention as port
from learningorchestra_tpu_torch.ops import layers

TOL = 2e-5
BLOCK = 128


def _tf32(x):
    """cvt.rna.tf32.f32: add half of the dropped 13 bits' unit to the
    magnitude (the int32 view is sign-magnitude), then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(eq, a, b, single):
    """einsum(eq, a, b) as the kernel takes it: hi.hi' alone (single
    TF32) or lo.hi' + hi.lo' + hi.hi' (split TF32), f32 accumulation."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if single:
        return torch.einsum(eq, ah, bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, ah, bh)


def _emulated_fwd(q, k, v, key_mask, causal=False, window=None,
                  single=False):
    """flash_attention_fwd_plain's arithmetic with both products in
    (split) TF32: (O, LSE (B, H, Tq, 1))."""
    b, _, tq, d = q.shape
    s = _product("bhqd,bhkd->bhqk", q, k, single) * (1.0 / math.sqrt(d))
    keep = port._keep_mask(key_mask, b, tq, k.shape[2], causal, window,
                           q.device)
    if keep is None:
        keep = torch.ones(())
    s = s + (keep - 1.0) * 1e30
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m) * keep
    l = p.sum(-1, keepdim=True)
    acc = _product("bhqk,bhkd->bhqd", p, v, single)
    nonempty = l > 0.0
    o = torch.where(nonempty, acc / torch.where(nonempty, l, 1.0), 0.0)
    lse = torch.where(nonempty, m + torch.log(torch.clamp_min(l, 1e-30)),
                      1e30)
    return o, lse


def _jax_fwd(q, k, v, mask, causal=False, window=None):
    """The Pallas forward in interpret mode, padded to BLOCK multiples as
    flash_attention pads (padded keys masked, padded rows sliced off)."""
    b, tq, tk = q.shape[0], q.shape[2], k.shape[2]
    pad_q, pad_k = (-tq) % BLOCK, (-tk) % BLOCK
    km = np.pad(mask.astype(np.float32), ((0, 0), (0, pad_k)))[:, None, :]
    pq = ((0, 0), (0, 0), (0, pad_q), (0, 0))
    pk = ((0, 0), (0, 0), (0, pad_k), (0, 0))
    o, lse = _fwd_call(jnp.asarray(np.pad(q, pq)), jnp.asarray(np.pad(k, pk)),
                       jnp.asarray(np.pad(v, pk)), jnp.asarray(km), BLOCK,
                       BLOCK, True, causal, window)
    assert b == o.shape[0]
    return np.asarray(o)[:, :, :tq], np.asarray(lse)[:, :, :tq]


# name: (B, H, Tq, Tk, D), causal, window.  Every case has a key mask
# with a pad tail on batch row 0 and no live key on batch row 1.
CASES = {
    "t512": ((2, 2, 512, 512, 64), False, None),
    "d40": ((2, 2, 128, 128, 40), False, None),
    "d128": ((2, 2, 128, 128, 128), False, None),
    "causal_window65_t300": ((2, 2, 300, 300, 64), True, 65),
}


def _inputs(shape, seed=0):
    b, h, tq, tk, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, d), dtype=np.float32)
    k = rng.standard_normal((b, h, tk, d), dtype=np.float32)
    v = rng.standard_normal((b, h, tk, d), dtype=np.float32)
    mask = np.zeros((b, tk), bool)
    mask[0, :tk - tk // 8] = True  # pad tail
    mask[0, rng.integers(0, tk, tk // 10)] = False
    return q, k, v, mask


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_tf32_holds_the_f32_bar(case):
    shape, causal, window = CASES[case]
    q, k, v, mask = _inputs(shape)
    qt, kt, vt, mt = (torch.from_numpy(a) for a in (q, k, v, mask))
    o, lse = _emulated_fwd(qt, kt, vt, mt, causal, window)
    o_plain, lse_plain = port.flash_attention_fwd_plain(qt, kt, vt, mt,
                                                        causal, window)
    o_jax, lse_jax = _jax_fwd(q, k, v, mask, causal, window)
    for name, want_o, want_lse in (("plain", o_plain, lse_plain),
                                   ("pallas", o_jax, lse_jax)):
        assert _max_err(o, want_o) <= TOL, name
        assert _max_err(lse[0], want_lse[0]) <= TOL, name
    # Batch row 1 has no live key: O = 0 and LSE = 1e30 exactly.
    assert torch.all(o[1] == 0.0)
    assert torch.all(lse[1] == np.float32(1e30))
    np.testing.assert_array_equal(lse_jax[1], np.float32(1e30))


def test_single_tf32_misses_the_f32_bar():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(CASES["t512"][0]))
    o_plain, lse_plain = port.flash_attention_fwd_plain(q, k, v, mask)
    o, lse = _emulated_fwd(q, k, v, mask, single=True)
    err = max(_max_err(o, o_plain), _max_err(lse[0], lse_plain[0]))
    assert err > TOL
    o, lse = _emulated_fwd(q, k, v, mask)
    split_err = max(_max_err(o, o_plain), _max_err(lse[0], lse_plain[0]))
    assert split_err * 10 < err


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # tf32's unit in the last place at [1, 2)
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23,
                      -(1.0 + ulp / 2), 1.0 + 1.5 * ulp], dtype=torch.float32)
    want = [1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp]
    assert _tf32(x).tolist() == want
    hi, lo = _split(x)
    assert torch.equal(_tf32(lo), lo)
    assert bool(((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alignment_check_covers_k1_in_both_dtypes(dtype, monkeypatch):
    # The views a BERT-base attention layer hands the kernel: q, k, v cut
    # from the fused qkv projection (row stride 3*H*D), and O.
    seen = {}

    def capture(q, k, v, key_mask=None, **kw):
        seen.update(q=q, k=k, v=v)
        return port.flash_attention(q, k, v, key_mask, **kw)

    monkeypatch.setattr(layers, "flash_attention", capture)
    layer = layers.MultiHeadSelfAttention(12, 768).to(dtype)
    with torch.no_grad():
        layer(torch.zeros(2, 16, 768, dtype=dtype))
    q, k, v = seen["q"], seen["k"], seen["v"]
    assert q.stride() == (16 * 36 * 64, 64, 36 * 64, 1)
    o = port._like_heads_last(q)
    port._check_aligned(("q", q), ("k", k), ("v", v), ("o", o))

    flat = torch.zeros(2 * 12 * 16 * 64 + 1, dtype=dtype)
    shifted = flat[1:].view(2, 12, 16, 64)  # base one element off
    with pytest.raises(ValueError, match="v must be 16-byte aligned"):
        port._check_aligned(("q", q), ("v", shifted))
    wide = torch.zeros(2, 12, 16, 66, dtype=dtype)[..., :64]
    with pytest.raises(ValueError, match="k must be 16-byte aligned"):
        port._check_aligned(("k", wide))  # row stride of 66 elements
