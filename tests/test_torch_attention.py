"""Port kernel K1 (flash attention forward) against the JAX package.

The port's plain forward (the CPU side of ``flash_attention_fwd``) is held
against the Pallas ``_fwd_call`` run in interpret mode, O and LSE, on the
same seeded inputs.  Tolerances are the JAX suite's own
(tests/test_ops.py): f32 atol/rtol 2e-5, bf16 3e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.ops.attention import _fwd_call
from learningorchestra_tpu.ops.attention import mha_reference as jax_mha
from learningorchestra_tpu_torch.ops import attention as port

B, H, T, D = 2, 3, 48, 16
BLOCK = 16


def _inputs(seed=7, tq=T, tk=T):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, tq, D), dtype=np.float32)
    k = rng.standard_normal((B, H, tk, D), dtype=np.float32)
    v = rng.standard_normal((B, H, tk, D), dtype=np.float32)
    return q, k, v


def _jax_fwd(q, k, v, mask, causal=False, window=None, dtype=jnp.float32):
    """Pallas forward as flash_attention drives it: pad to block
    multiples, padded keys masked, padded query rows sliced off."""
    tq, tk = q.shape[2], k.shape[2]
    pad_q, pad_k = (-tq) % BLOCK, (-tk) % BLOCK
    km = np.ones((B, tk), np.float32) if mask is None else \
        mask.astype(np.float32)
    km = np.pad(km, ((0, 0), (0, pad_k)))[:, None, :]
    pq = ((0, 0), (0, 0), (0, pad_q), (0, 0))
    pk = ((0, 0), (0, 0), (0, pad_k), (0, 0))
    o, lse = _fwd_call(
        jnp.asarray(np.pad(q, pq)).astype(dtype),
        jnp.asarray(np.pad(k, pk)).astype(dtype),
        jnp.asarray(np.pad(v, pk)).astype(dtype),
        jnp.asarray(km), BLOCK, BLOCK, True, causal, window,
    )
    return (np.asarray(o.astype(jnp.float32))[:, :, :tq],
            np.asarray(lse)[:, :, :tq])


def _port_fwd(q, k, v, mask, causal=False, window=None,
              dtype=torch.float32):
    o, lse = port.flash_attention_fwd(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype),
        None if mask is None else torch.from_numpy(mask),
        causal, window,
    )
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (q.shape[0], q.shape[1], q.shape[2], 1)
    return o.float().numpy(), lse.numpy()


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
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fwd_matches_pallas_f32(case):
    kw = dict(CASES[case])
    mask = kw.pop("mask", None)
    q, k, v = _inputs()
    o_j, lse_j = _jax_fwd(q, k, v, mask, **kw)
    o_p, lse_p = _port_fwd(q, k, v, mask, **kw)
    np.testing.assert_allclose(o_p, o_j, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse_p, lse_j, atol=2e-5, rtol=2e-5)


def test_fully_masked_row_is_zero_with_empty_lse():
    q, k, v = _inputs()
    mask = np.zeros((B, T), bool)
    mask[1, :3] = True  # batch row 0 masks every key
    o_j, lse_j = _jax_fwd(q, k, v, mask)
    o_p, lse_p = _port_fwd(q, k, v, mask)
    assert np.max(np.abs(o_p[0])) == 0.0
    assert np.all(lse_p[0] == np.float32(1e30))
    np.testing.assert_array_equal(lse_p[0], lse_j[0])
    np.testing.assert_allclose(o_p, o_j, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse_p[1], lse_j[1], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_unaligned_lengths(causal):
    q, _, _ = _inputs(tq=37)
    _, k, v = _inputs(seed=8, tk=41)
    mask = _random_mask(5, tk=41)
    o_j, lse_j = _jax_fwd(q, k, v, mask, causal=causal)
    o_p, lse_p = _port_fwd(q, k, v, mask, causal=causal)
    assert o_p.shape == (B, H, 37, D)
    np.testing.assert_allclose(o_p, o_j, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse_p, lse_j, atol=2e-5, rtol=2e-5)


def test_bfloat16_matches_pallas():
    q, k, v = _inputs()
    mask = _random_mask()
    o_j, lse_j = _jax_fwd(q, k, v, mask, dtype=jnp.bfloat16)
    o_p, lse_p = _port_fwd(q, k, v, mask, dtype=torch.bfloat16)
    np.testing.assert_allclose(o_p, o_j, atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(lse_p, lse_j, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("case", ["unmasked", "key_mask", "causal_window"])
def test_mha_reference_matches_jax(case):
    kw = dict(CASES[case])
    mask = kw.pop("mask", None)
    q, k, v = _inputs(seed=21)
    ref = np.asarray(jax_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), **kw,
    ))
    out = port.mha_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), **kw,
    ).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_public_entry_takes_plain_path_on_cpu_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs())
    before = port.launches
    out = port.flash_attention(q, k, v, causal=True)
    assert port.launches == before
    np.testing.assert_allclose(
        out.numpy(),
        port.mha_reference(q, k, v, causal=True).numpy(),
        atol=2e-5, rtol=2e-5,
    )


def test_wrapper_validates_arguments():
    q, k, v = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="window requires causal"):
        port.flash_attention(q, k, v, window=4)
    with pytest.raises(ValueError, match="shape mismatch"):
        port.flash_attention(q, k[:, :2], v[:, :2])
    with pytest.raises(ValueError, match="key_mask"):
        port.flash_attention(q, k, v, torch.ones(B, T + 1))
