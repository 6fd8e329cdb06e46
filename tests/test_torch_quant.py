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


# -- the grouped launch: plan, packing, pytree paths -------------------------

# BERT-base's 51 quantized leaves as (rows, width), in flax tree order:
# Embed_0, Embed_1, then per block qkv (768, 36, 64) flattened to 64-wide
# rows, out, Dense_0, Dense_1, then the pooler.
BERT_BASE_LEAVES = (
    [(30522, 768), (512, 768)]
    + [(768 * 36, 64), (768, 768), (768, 3072), (3072, 768)] * 12
    + [(768, 768)]
)
EDGE_LEAVES = [(7, 1), (5, 3), (9, 33), (100, 64), (3, 4100), (1, 768),
               (2, 3072), (1, 1)]


def _covered_rows(plan):
    """Rows each leaf's blocks touch, found the way the kernel finds them:
    a block's leaf is the last whose first block is <= its index."""
    seen = [np.zeros(lp.n, np.int64) for lp in plan.leaves]
    for launch in range(plan.launches):
        idx = [i for i, lp in enumerate(plan.leaves) if lp.launch == launch]
        firsts = [plan.leaves[i].first_block for i in idx]
        last = plan.leaves[idx[-1]]
        for block in range(last.first_block + last.blocks):
            i = idx[np.searchsorted(firsts, block, side="right") - 1]
            lp = plan.leaves[i]
            r0 = (block - lp.first_block) * lp.rows_per_block
            seen[i][r0:r0 + lp.rows_per_block] += 1
    return seen


def _assert_packed(plan):
    ends = {"values": 0, "scales": 0, "out": 0}
    for lp in plan.leaves:
        assert lp.values_offset % 16 == 0
        assert lp.scales_offset % 4 == 0 and lp.out_offset % 4 == 0
        # Slices in leaf order, disjoint, inside their buffers.
        assert lp.values_offset >= ends["values"]
        assert lp.scales_offset >= ends["scales"]
        assert lp.out_offset >= ends["out"]
        ends = {"values": lp.values_offset + lp.n * lp.d,
                "scales": lp.scales_offset + lp.n,
                "out": lp.out_offset + lp.n * lp.d}
    assert ends["values"] <= plan.values_bytes
    assert ends["scales"] <= plan.scales_count
    assert ends["out"] <= plan.out_count


@pytest.mark.parametrize("direction", ["quantize", "dequantize"])
@pytest.mark.parametrize("leaves", ["bert_base", "edges"])
def test_plan_covers_every_row_once(direction, leaves):
    shapes = BERT_BASE_LEAVES if leaves == "bert_base" else EDGE_LEAVES
    plan = pq.plan_group(shapes, direction)
    assert [(lp.n, lp.d) for lp in plan.leaves] == list(shapes)
    _assert_packed(plan)
    for lp, seen in zip(plan.leaves, _covered_rows(plan)):
        assert (seen == 1).all(), (lp.n, lp.d)
        assert (lp.blocks - 1) * lp.rows_per_block < lp.n


def test_plan_bert_base_classes_and_bytes():
    q = pq.plan_group(BERT_BASE_LEAVES, "quantize")
    dq = pq.plan_group(BERT_BASE_LEAVES, "dequantize")
    assert len(q.leaves) == 51 and q.launches == dq.launches == 1
    by_width = {lp.d: (lp.cls, lp.lanes, lp.rows_per_block)
                for lp in q.leaves}
    # 64-wide qkv rows: 16 lanes x one float4, 2 rows a warp, 8 slots.
    assert by_width == {64: (pq.SUBWARP, 16, 64), 768: (pq.WARP, 0, 4),
                        3072: (pq.BLOCK, 0, 1)}
    # Every BERT-base width is a multiple of 4: 4-byte int8 chunks.
    assert {(lp.cls, lp.lanes) for lp in dq.leaves} == {
        (4, 16), (4, 192), (4, 768)}
    elements = sum(n * d for n, d in BERT_BASE_LEAVES)
    moved = sum(5 * n * d + 4 * n for n, d in BERT_BASE_LEAVES)
    assert elements == 109_358_592
    assert round(moved / 1e6, 1) == 548.5  # the bound's bytes (PERF.md)
    # Packed buffers waste at most 15 bytes (or 3 floats) a leaf.
    assert q.values_bytes - elements < 16 * 51
    assert q.out_count - elements < 4 * 51


@pytest.mark.parametrize("shape,quant_class,deq_width", [
    ((7, 1), pq.GENERAL, 1),
    ((5, 3), pq.GENERAL, 1),
    ((9, 33), pq.GENERAL, 1),
    ((100, 64), pq.SUBWARP, 4),
    ((3, 4100), pq.GENERAL, 4),  # too wide for a block's registers
    ((1, 768), pq.WARP, 4),
    ((2, 4096), pq.BLOCK, 4),
    ((4, 8), pq.SUBWARP, 4),
])
def test_plan_edge_shapes(shape, quant_class, deq_width):
    q = pq.plan_group([shape], "quantize").leaves[0]
    dq = pq.plan_group([shape], "dequantize").leaves[0]
    assert q.cls == quant_class and dq.cls == deq_width
    assert dq.lanes * dq.cls == shape[1]
    assert q.blocks == -(-shape[0] // q.rows_per_block)
    if quant_class == pq.SUBWARP:
        assert q.lanes >= shape[1] // 4 and q.lanes & (q.lanes - 1) == 0
    # A misaligned source takes the scalar classes.
    assert pq.plan_group([shape], "quantize", [False]).leaves[0].cls == \
        pq.GENERAL
    assert pq.plan_group([shape], "dequantize", [False]).leaves[0].cls == 1


def test_plan_splits_launches_above_the_cap():
    shapes = [(3 + i % 5, 64 * (1 + i % 3)) for i in range(2 * pq.MAX_LEAVES
                                                           + 2)]
    plan = pq.plan_group(shapes, "quantize")
    assert plan.launches == 3
    counts = [sum(lp.launch == k for lp in plan.leaves) for k in range(3)]
    assert counts == [pq.MAX_LEAVES, pq.MAX_LEAVES, 2]
    for k in (0, pq.MAX_LEAVES, 2 * pq.MAX_LEAVES):
        assert plan.leaves[k].first_block == 0
    _assert_packed(plan)
    assert all((s == 1).all() for s in _covered_rows(plan))
    with pytest.raises(ValueError, match="non-empty"):
        pq.plan_group([(0, 4)], "quantize")


def _class_tree():
    """A narrow tree with a leaf of every row class, both rounding
    neighbours' ties, a leaf under min_elements and 1-D biases."""
    rng = np.random.default_rng(5)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    halves = normal(48, 128)
    halves[:, 0] = 127.0  # scale exactly 1: the halves below are ties
    halves[:, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    halves[3] = 0.0  # an all-zero row
    return {"params": {
        "qkv": {"kernel": normal(32, 2, 64), "bias": normal(2, 64)},
        "d96": {"kernel": normal(64, 96), "bias": normal(96)},
        "d384": {"kernel": normal(16, 384, scale=1e20)},
        "block": {"kernel": normal(2, 2048)},
        "halves": {"kernel": halves},
        "odd": {"kernel": normal(200, 33, scale=1e-9)},
        "wide": {"kernel": normal(1, 4100)},
        "narrow": {"kernel": normal(4096, 1)},
        "half_precision": {"kernel": normal(64, 64).astype(np.float16)},
        "small": {"kernel": normal(8, 8)},
    }}


def _mixed(tree):
    """The same tree with every other leaf a CPU tensor."""
    flip = [False]

    def leaf(x):
        flip[0] = not flip[0]
        return torch.from_numpy(x.copy()) if flip[0] else x

    return {"params": {name: {k: leaf(v) for k, v in node.items()}
                       for name, node in tree["params"].items()}}


def test_port_quantize_pytree_packed_matches_jax():
    tree = _class_tree()
    ref = jq.quantize_pytree(tree)
    launches = pq.quantize_launches
    out = pq.quantize_pytree(_mixed(tree))
    assert pq.quantize_launches == launches  # the CPU runs no kernel
    classes = {pq.plan_group([lf.values.shape], "quantize").leaves[0].cls
               for node in out["params"].values() for lf in node.values()
               if isinstance(lf, pq.QuantizedLeaf)}
    assert classes == {pq.SUBWARP, pq.WARP, pq.BLOCK, pq.GENERAL}
    for name, node in ref["params"].items():
        for key, want in node.items():
            got = out["params"][name][key]
            if not isinstance(want, jq.QuantizedLeaf):
                assert not isinstance(got, pq.QuantizedLeaf), (name, key)
                np.testing.assert_array_equal(np.asarray(got), want)
                continue
            assert isinstance(got, pq.QuantizedLeaf), (name, key)
            assert got.shape == want.shape and got.dtype == str(want.dtype)
            np.testing.assert_array_equal(got.values, np.asarray(want.values))
            np.testing.assert_array_equal(
                got.scales.view(np.uint32),
                np.asarray(want.scales).view(np.uint32))


def test_port_dequantize_pytree_packed_exact_against_jax():
    qtree = jq.quantize_pytree(_class_tree())
    ref = jq.dequantize_pytree(qtree)
    launches = pq.dequantize_launches
    out = pq.dequantize_pytree(_to_port_leaves(qtree), device="cpu")
    assert pq.dequantize_launches == launches
    for name, node in ref["params"].items():
        for key, want in node.items():
            got = out["params"][name][key]
            if isinstance(qtree["params"][name][key], jq.QuantizedLeaf):
                assert isinstance(got, torch.Tensor)
                assert str(got.dtype) == f"torch.{np.asarray(want).dtype}"
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                np.testing.assert_array_equal(got, want)


def test_quantized_leaves_are_plain_arrays_and_round_trip():
    import pickle

    tree = _class_tree()
    qtree = pq.quantize_pytree(tree)
    leaves = [lf for node in qtree["params"].values() for lf in node.values()
              if isinstance(lf, pq.QuantizedLeaf)]
    assert len(leaves) == 9
    for lf in leaves:
        assert type(lf.values) is np.ndarray and type(lf.scales) is np.ndarray
        assert lf.values.dtype == np.int8 and lf.scales.dtype == np.float32
        assert lf.values.shape == (int(np.prod(lf.shape[:-1])), lf.shape[-1])
        assert lf.scales.shape == (lf.values.shape[0], 1)
        # A view of the packed buffer pickles its own bytes, not the
        # buffer's: the artifact stays the size of its leaves.
        assert len(pickle.dumps(lf.values, protocol=pickle.HIGHEST_PROTOCOL)
                   ) < lf.values.nbytes + 512
    back = pq.dequantize_pytree(pickle.loads(pickle.dumps(qtree)),
                                device="cpu")
    for name, node in tree["params"].items():
        for key, leaf in node.items():
            got = back["params"][name][key]
            assert tuple(got.shape) == leaf.shape
            assert str(np.asarray(got).dtype) == str(leaf.dtype)
    # Deterministic: the same bytes every save.
    again = pq.quantize_pytree(tree)
    for name, node in qtree["params"].items():
        for key, lf in node.items():
            if isinstance(lf, pq.QuantizedLeaf):
                np.testing.assert_array_equal(
                    again["params"][name][key].values, lf.values)


def test_grouped_dequantize_takes_only_a_dequantize_plan():
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal((6, 40), dtype=np.float32))
    plan, values, scales = pq._quantize_group([x])
    with pytest.raises(ValueError, match="dequantize plan"):
        pq._dequantize_group(plan, values, scales)
    # The two directions share the buffers' layout.
    dplan = pq.plan_group([(6, 40)], "dequantize")
    out = pq._dequantize_group(dplan, values, scales)
    (v, s), = pq._leaf_views(plan, values, scales)
    np.testing.assert_array_equal(out[:240].view(6, 40).numpy(),
                                  pq.dequantize_rowwise_plain(v, s).numpy())


def test_descriptor_layout_matches_the_kernel_and_checks_inputs():
    import ctypes

    # LeafDesc in csrc/quant.cu: 3 pointers, 2 int64, 4 int32 = 56 bytes;
    # 64 of them stay under the 4 KB kernel-parameter limit.
    assert ctypes.sizeof(pq._LeafDesc) == 56
    assert pq._LeafDesc.d.offset == 40 and pq._LeafDesc.n.offset == 24
    assert pq.MAX_LEAVES * ctypes.sizeof(pq._LeafDesc) + 12 <= 4096
    with pytest.raises(ValueError, match="contiguous 2-D float32"):
        pq._quantize_group([torch.zeros(4, 8).t()])
    plan = pq.plan_group([(4, 8)], "dequantize")
    with pytest.raises(ValueError, match="packed buffers"):
        pq._dequantize_group(plan, torch.zeros(8, dtype=torch.int8),
                             torch.zeros(4))
