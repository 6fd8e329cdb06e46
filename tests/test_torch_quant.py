"""Port kernels K4/K5 (row-wise int8 quantize / dequantize) and the
quantized artifact format against the JAX package.

Deterministic quantization must be bit-identical to the Pallas kernel
(interpret mode) and dequantization exact; a JAX ``quantize_pytree`` tree
dequantizes to the same arrays in the port.  Stochastic rounding is held
to unbiasedness (the TPU's random bits are not reproducible).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.ops import quant as jq
from learningorchestra_tpu_torch.ops import quant as pq


def _cases():
    rng = np.random.default_rng(0)
    ties = np.zeros((4, 64), np.float32)
    # abs max 127 -> scale exactly 1.0: every x/scale below is an exact
    # half, so round-half-to-even decides each one.
    ties[0, :8] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    ties[1, :4] = [-127, 3.5, -3.5, 4.5]
    ties[2] = 0.0  # a zero row: scale 1e-12 / 127
    ties[3] = np.linspace(-1, 1, 64, dtype=np.float32)
    return {
        "normal": rng.standard_normal((37, 64), dtype=np.float32),
        "wide": rng.standard_normal((5, 3072), dtype=np.float32) * 3,
        "ties_and_zero_rows": ties,
        "tiny": rng.standard_normal((9, 33), dtype=np.float32) * 1e-9,
        "huge": rng.standard_normal((6, 128), dtype=np.float32) * 1e20,
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_bit_identical_to_pallas(case):
    x = CASES[case]
    v_j, s_j = jq.quantize_rowwise(
        jnp.asarray(x), stochastic=False, interpret=True
    )
    v_p, s_p = pq.quantize_rowwise(torch.from_numpy(x))
    assert v_p.dtype == torch.int8 and s_p.dtype == torch.float32
    assert s_p.shape == (x.shape[0], 1)
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(
        s_p.numpy().view(np.uint32), np.asarray(s_j).view(np.uint32)
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_dequantize_exact(case):
    v_j, s_j = jq.quantize_rowwise(
        jnp.asarray(CASES[case]), stochastic=False, interpret=True
    )
    out_j = np.asarray(jq.dequantize_rowwise(v_j, s_j, interpret=True))
    out_p = pq.dequantize_rowwise(
        torch.from_numpy(np.array(v_j)), torch.from_numpy(np.array(s_j))
    ).numpy()
    np.testing.assert_array_equal(out_p, out_j)


def _tree():
    rng = np.random.default_rng(1)
    return {"params": {
        "dense": {
            "kernel": rng.standard_normal((64, 96), dtype=np.float32),
            "bias": rng.standard_normal((96,), dtype=np.float32),
        },
        "qkv": {
            "kernel": rng.standard_normal((32, 6, 64), dtype=np.float32),
            "bias": rng.standard_normal((6, 64), dtype=np.float32),
        },
        "small": {"kernel": rng.standard_normal((8, 8), dtype=np.float32)},
    }}


def _to_port_leaves(tree):
    if isinstance(tree, dict):
        return {k: _to_port_leaves(v) for k, v in tree.items()}
    if isinstance(tree, jq.QuantizedLeaf):
        return pq.QuantizedLeaf(tree.values, tree.scales, tree.shape,
                                tree.dtype)
    return tree


def test_jax_quantized_tree_dequantizes_identically():
    qtree = jq.quantize_pytree(_tree())
    ref = jq.dequantize_pytree(qtree)
    port_tree = _to_port_leaves(qtree)
    assert pq.has_quantized_leaves(port_tree)
    out = pq.dequantize_pytree(port_tree, device="cpu")
    for path in (("dense", "kernel"), ("qkv", "kernel")):
        a = out["params"][path[0]][path[1]]
        b = ref["params"][path[0]][path[1]]
        assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        out["params"]["dense"]["bias"], ref["params"]["dense"]["bias"]
    )


def test_port_quantize_pytree_writes_the_jax_artifact_bytes():
    tree = _tree()
    ref = jq.quantize_pytree(tree)
    # Tensor leaves quantize on their device; numpy leaves on the CPU.
    mixed = {"params": {
        "dense": {k: torch.from_numpy(v)
                  for k, v in tree["params"]["dense"].items()},
        "qkv": tree["params"]["qkv"],
        "small": tree["params"]["small"],
    }}
    out = pq.quantize_pytree(mixed)
    for name in ("dense", "qkv"):
        a, b = out["params"][name]["kernel"], ref["params"][name]["kernel"]
        assert isinstance(a, pq.QuantizedLeaf)
        assert a.shape == b.shape and a.dtype == b.dtype == "float32"
        assert isinstance(a.values, np.ndarray)
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.scales, b.scales)
    # qkv rows are head_dim wide, exactly as the JAX tree flattens them.
    assert out["params"]["qkv"]["kernel"].values.shape == (32 * 6, 64)
    # Below min_elements and 1-D leaves stay full precision.
    assert not isinstance(out["params"]["small"]["kernel"], pq.QuantizedLeaf)
    assert isinstance(out["params"]["dense"]["bias"], torch.Tensor)
    assert not pq.has_quantized_leaves(tree)


def test_stochastic_rounding_is_unbiased_and_seeded():
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((16, 64), dtype=np.float32)
    )
    v0, s0 = pq.quantize_rowwise(x, stochastic=True, seed=3)
    v1, _ = pq.quantize_rowwise(x, stochastic=True, seed=3)
    v2, _ = pq.quantize_rowwise(x, stochastic=True, seed=4)
    assert torch.equal(v0, v1)
    assert not torch.equal(v0, v2)
    deq = torch.stack([
        pq.dequantize_rowwise(*pq.quantize_rowwise(
            x, stochastic=True, seed=s))
        for s in range(200)
    ])
    # Each entry rounds to one of two neighbours a scale apart; the mean
    # of 200 draws sits within ~4 standard errors (scale/2/sqrt(200)).
    err = (deq.mean(0) - x).abs() / s0
    assert float(err.max()) < 0.15
    # Deterministic rounding would be biased on these same entries.
    det = pq.dequantize_rowwise(*pq.quantize_rowwise(x))
    assert float(((det - x).abs() / s0).mean()) > 0.2


def test_philox_words_match_reference_vector():
    # Random123's published Philox4x32-10 known-answer vector: counter
    # (0, 0, 0, 0), key (0, 0) -> 6627e8d5 e169c58d bc57ac4c 9b00dbd8.
    u = pq.philox_uniform(0, 1, 4)
    expect = np.array([0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
                      np.uint64)
    np.testing.assert_array_equal(
        u.numpy()[0], ((expect >> 9).astype(np.float32)) / (1 << 23)
    )


def test_wrappers_validate():
    with pytest.raises(ValueError, match="2-D"):
        pq.quantize_rowwise(torch.zeros(3))
    with pytest.raises(TypeError, match="float"):
        pq.quantize_rowwise(torch.zeros(3, 4, dtype=torch.int32))
    with pytest.raises(TypeError, match="int8"):
        pq.dequantize_rowwise(torch.zeros(3, 4), torch.zeros(3, 1))
    with pytest.raises(TypeError, match="scales"):
        pq.dequantize_rowwise(torch.zeros(3, 4, dtype=torch.int8),
                              torch.zeros(3))
