"""Port kernels K2/K3 (flash attention backward) against the JAX package.

The port's plain backward (the CPU side of ``flash_attention_bwd``) is
held against the Pallas ``_bwd_call`` run in interpret mode on the same
dO, LSE and delta; the autograd Function's gradients against ``jax.grad``
of ``flash_attention(..., interpret=True)`` with ``sum(sin(O))``, as the
JAX suite's own backward test does.  Tolerances are the JAX suite's
(tests/test_ops.py): f32 grads atol/rtol 5e-5, bf16 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.ops.attention import _bwd_call
from learningorchestra_tpu.ops.attention import (
    flash_attention as jax_flash,
)
from learningorchestra_tpu_torch.ops import attention as port

B, H, T, D = 2, 2, 48, 16
BLOCK = 16
DTYPES = {"f32": (jnp.float32, torch.float32, 5e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _random_mask(seed=3, tk=T):
    return np.random.default_rng(seed).random((B, tk)) > 0.4


CASES = {
    "unmasked": dict(),
    "key_mask": dict(mask=_random_mask()),
    "causal": dict(causal=True),
    "causal_window": dict(causal=True, window=5),
    "causal_window_masked": dict(
        mask=_random_mask(11), causal=True, window=20,
    ),
    "unaligned": dict(mask=_random_mask(5, tk=41), tq=37, tk=41),
    "unaligned_causal": dict(mask=_random_mask(5, tk=41), tq=37, tk=41,
                             causal=True),
    # Head widths whose padding the card's bf16 tiling handles: D = 40
    # below the 64-wide instance (zero-filled columns), D = 128 the wide one.
    "d40_key_mask": dict(mask=_random_mask(19), d=40),
    "d128_causal_window": dict(mask=_random_mask(23, tk=33), tq=33, tk=33,
                               causal=True, window=9, d=128),
}


def _case(name, seed=7):
    kw = dict(CASES[name])
    tq, tk, d = kw.pop("tq", T), kw.pop("tk", T), kw.pop("d", D)
    q, k, v, do = _arrays(seed, (B, H, tq, d), (B, H, tk, d), (B, H, tk, d),
                          (B, H, tq, d))
    return q, k, v, do, kw.pop("mask", None), kw


def _jax_bwd(q, k, v, do, lse, delta, mask, causal=False, window=None,
             dtype=jnp.float32):
    """Pallas backward as flash_attention's custom_vjp drives it: every
    tensor padded to block multiples, padded keys masked, padded rows of
    dQ/dK/dV sliced off."""
    tq, tk = q.shape[2], k.shape[2]
    pad_q, pad_k = (-tq) % BLOCK, (-tk) % BLOCK
    km = np.ones((B, tk), np.float32) if mask is None else \
        mask.astype(np.float32)
    km = np.pad(km, ((0, 0), (0, pad_k)))[:, None, :]
    pq = ((0, 0), (0, 0), (0, pad_q), (0, 0))
    pk = ((0, 0), (0, 0), (0, pad_k), (0, 0))
    dq, dk, dv = _bwd_call(
        jnp.asarray(np.pad(q, pq)).astype(dtype),
        jnp.asarray(np.pad(k, pk)).astype(dtype),
        jnp.asarray(np.pad(v, pk)).astype(dtype),
        jnp.asarray(km),
        jnp.asarray(np.pad(do, pq)).astype(dtype),
        jnp.asarray(np.pad(lse, pq)), jnp.asarray(np.pad(delta, pq)),
        BLOCK, BLOCK, True, causal, window,
    )
    return tuple(np.asarray(g.astype(jnp.float32))[:, :, :n]
                 for g, n in ((dq, tq), (dk, tk), (dv, tk)))


def _to(x, dtype):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_bwd_matches_pallas(case, dt):
    jdt, tdt, tol = DTYPES[dt]
    q, k, v, do, mask, kw = _case(case)
    qt, kt, vt, dot = (_to(a, tdt) for a in (q, k, v, do))
    mt = None if mask is None else torch.from_numpy(mask)
    o, lse = port.flash_attention_fwd(qt, kt, vt, mt, **kw)
    delta = (dot.float() * o.float()).sum(-1, keepdim=True)
    grads = port.flash_attention_bwd_plain(qt, kt, vt, mt, dot, lse, delta,
                                           **kw)
    assert [g.dtype for g in grads] == [tdt] * 3
    assert [g.shape for g in grads] == [qt.shape, kt.shape, vt.shape]
    # The reference sees the same rounded inputs, LSE and delta.
    ref = _jax_bwd(*(t.float().numpy() for t in (qt, kt, vt, dot)),
                   lse.numpy(), delta.numpy(), mask, dtype=jdt, **kw)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol, err_msg=name)


def _port_grads(q, k, v, mask, tdt, **kw):
    qt, kt, vt = (_to(a, tdt).requires_grad_() for a in (q, k, v))
    mt = None if mask is None else torch.from_numpy(mask)
    out = port.flash_attention(qt, kt, vt, mt, **kw)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    torch.sin(out).sum().backward()
    return [t.grad.float().numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("case,dt", [
    ("key_mask", "f32"), ("causal_window_masked", "f32"),
    ("unaligned_causal", "f32"), ("unaligned_causal", "bf16"),
])
def test_function_grads_match_jax_grad(case, dt):
    jdt, tdt, tol = DTYPES[dt]
    q, k, v, _, mask, kw = _case(case, seed=9)
    jm = None if mask is None else jnp.asarray(mask)
    ref = jax.grad(
        lambda q, k, v: jnp.sum(jnp.sin(jax_flash(
            q, k, v, jm, block_q=BLOCK, block_k=BLOCK, interpret=True, **kw
        ))), argnums=(0, 1, 2),
    )(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    got = _port_grads(q, k, v, mask, tdt, **kw)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g, np.asarray(r.astype(jnp.float32)),
                                   atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_masked_rows_and_keys_get_exact_zero_grads(dt):
    _, tdt, _ = DTYPES[dt]
    q, k, v, _, _, _ = _case("unmasked", seed=13)
    mask = _random_mask(17)
    mask[0] = False  # batch row 0: every key masked
    dq, dk, dv = _port_grads(q, k, v, mask, tdt)
    for g in (dq, dk, dv):
        assert np.isfinite(g).all()
        assert np.max(np.abs(g[0])) == 0.0
    masked = ~mask[1]
    assert masked.any()
    assert np.max(np.abs(dk[1][:, masked])) == 0.0
    assert np.max(np.abs(dv[1][:, masked])) == 0.0
    assert np.abs(dk[1][:, ~masked]).max() > 0.0


def test_bwd_wrapper_validates_and_counts_no_launch_on_cpu():
    q, k, v, do, mask, _ = _case("key_mask")
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    mt = torch.from_numpy(mask)
    o, lse = port.flash_attention_fwd(qt, kt, vt, mt)
    delta = (dot * o).sum(-1, keepdim=True)
    before = (port.bwd_dq_launches, port.bwd_dkv_launches, port.launches)
    dq, dk, dv = port.flash_attention_bwd(qt, kt, vt, mt, dot, lse, delta)
    args = (qt, kt, vt, mt, dot, lse, delta)
    torch.testing.assert_close(port.flash_attention_bwd_dq(*args), dq,
                               rtol=0, atol=0)
    for got, want in zip(port.flash_attention_bwd_dkv(*args), (dk, dv)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    _port_grads(q, k, v, mask, torch.float32)
    assert (port.bwd_dq_launches, port.bwd_dkv_launches,
            port.launches) == before
    with pytest.raises(ValueError, match="do must match q"):
        port.flash_attention_bwd(qt, kt, vt, mt, dot[:, :1], lse, delta)
    with pytest.raises(ValueError, match="do must match q"):
        port.flash_attention_bwd(qt, kt, vt, mt, dot.to(torch.bfloat16),
                                 lse, delta)
    with pytest.raises(ValueError, match="lse must be"):
        port.flash_attention_bwd(qt, kt, vt, mt, dot, lse[..., 0], delta)
    with pytest.raises(ValueError, match="delta must be"):
        port.flash_attention_bwd(qt, kt, vt, mt, dot, lse, delta.double())
    with pytest.raises(ValueError, match="window requires causal"):
        port.flash_attention_bwd(qt, kt, vt, mt, dot, lse, delta,
                                 window=4)
    with pytest.raises(ValueError, match="key_mask"):
        port.flash_attention_bwd(qt, kt, vt, mt[:, 1:], dot, lse, delta)


def test_bwd_validates_once_for_both_kernels(monkeypatch):
    q, k, v, do, mask, _ = _case("key_mask")
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    mt = torch.from_numpy(mask)
    o, lse = port.flash_attention_fwd(qt, kt, vt, mt)
    delta = (dot * o).sum(-1, keepdim=True)
    calls = []
    check = port._check_bwd_inputs
    monkeypatch.setattr(port, "_check_bwd_inputs",
                        lambda *a: calls.append(1) or check(*a))
    port.flash_attention_bwd(qt, kt, vt, mt, dot, lse, delta)
    assert len(calls) == 1


def test_alignment_check_names_the_tensor():
    qkv = torch.zeros(2, 48, 3, 2, 16, dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    port._check_aligned(("q", q), ("k", k), ("v", v))  # fused-qkv views
    flat = torch.zeros(2 * 2 * 48 * 16 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 2, 48, 16)  # base 2 bytes off
    with pytest.raises(ValueError, match="do must be 16-byte aligned"):
        port._check_aligned(("q", q), ("do", shifted))
    odd_rows = torch.zeros(2, 2, 48, 20, dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="k must be 16-byte aligned"):
        port._check_aligned(("k", odd_rows))  # 40-byte row stride
    one_row = torch.zeros(64, dtype=torch.bfloat16).as_strided(
        (1, 2, 1, 16), (5, 16, 3, 1))
    port._check_aligned(("q", one_row))  # strides of length-1 dims unused


def test_no_grad_paths_skip_the_function():
    q, k, v, _, mask, _ = _case("key_mask")
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with torch.no_grad():
        assert port.flash_attention(qt, kt, vt).grad_fn is None
    with torch.inference_mode():
        out = port.flash_attention(qt, kt, vt, torch.from_numpy(mask))
    assert out.grad_fn is None
