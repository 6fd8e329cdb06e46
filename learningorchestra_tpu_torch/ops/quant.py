"""Row-wise int8 quantization — port of ``learningorchestra_tpu/ops/quant.py``.

``quantize_rowwise`` (kernel K4) and ``dequantize_rowwise`` (kernel K5)
launch ``csrc/quant.cu`` on CUDA tensors and run their plain PyTorch
versions on CPU tensors.  Deterministic quantization is bit-identical to
the Pallas kernel as XLA compiles it: ``scale = max(|x|max, 1e-12) *
f32(1/127)``, IEEE ``x / scale``, round half to even, clip to +-127.
Stochastic rounding uses Philox4x32-10 keyed by (seed, row); the plain
version computes the same Philox words, so kernel and plain agree bit for
bit, but neither reproduces the TPU's random bits.

Each kernel is one grouped launch over many matrices ("leaves"): a plan
(:func:`plan_group`, a plain function of the leaf shapes) gives every leaf
a row class, a block count, its first block in its launch and 16-byte
aligned offsets into packed buffers.  The one-matrix wrappers launch the
same kernel with one leaf; ``quantize_pytree`` and ``dequantize_pytree``
launch once per direction for a whole artifact (once per
``MAX_LEAVES`` leaves), and on the CPU run the same packing with the plain
versions per leaf.

The artifact format (``QuantizedLeaf``, ``quantize_pytree``,
``dequantize_pytree``) is the JAX package's: plain numpy fields, leading
axes flattened to ``reshape(-1, shape[-1])``, so an int8 artifact holds
exactly the JAX package's int8 rows and scales.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from learningorchestra_tpu_torch.concurrency_rt import make_lock
from learningorchestra_tpu_torch.kernels import build

#: Kernel launches made by the quantize / dequantize kernels, and the
#: leaves (matrices) those launches processed.
quantize_launches = 0
quantize_leaves = 0
dequantize_launches = 0
dequantize_leaves = 0
_count_lock = make_lock("quant._count_lock")


def count_launch(**deltas: int) -> None:
    """Add each delta to its module counter under one lock, so a launch's
    count and its leaves move together and concurrent loads count
    exactly."""
    with _count_lock:
        for counter, n in deltas.items():
            globals()[counter] += n


_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for b holding uint32 values in
    int64 lanes, without overflowing int64."""
    bl, bh = b & 0xFFFF, b >> 16
    t_lo = a * bl  # < 2^48
    t = a * bh + (t_lo >> 16)  # < 2^48 + 2^32
    hi = t >> 16
    lo = ((t & 0xFFFF) << 16) | (t_lo & 0xFFFF)
    return hi, lo


def philox_uniform(seed: int, n: int, d: int, device="cpu") -> torch.Tensor:
    """(n, d) f32 uniforms in [0, 1) from 23 bits of Philox4x32-10 — the
    stream ``csrc/quant.cu`` draws: key (seed, row), counter (col // 4),
    word col % 4."""
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    c0 = (cols >> 2).expand(n, d)
    c1 = torch.zeros_like(c0)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0 = torch.full_like(c0, seed & _U32)
    k1 = rows.expand(n, d) & _U32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _U32
        k1 = (k1 + _W1) & _U32
    words = torch.stack([c0, c1, c2, c3], dim=-1)
    bits = torch.gather(words, -1, (cols & 3).expand(n, d)[..., None])[..., 0]
    return (bits >> 9).to(torch.float32) * (1.0 / (1 << 23))


def quantize_rowwise_plain(x, *, stochastic: bool = False, seed: int = 0):
    x = x.to(torch.float32)
    abs_max = torch.amax(x.abs(), dim=-1, keepdim=True)
    # XLA compiles the reference's `/ 127.0` into a multiply by the f32
    # reciprocal; the division by the per-row scale stays a true division.
    scale = torch.clamp_min(abs_max, 1e-12) * (1.0 / 127.0)
    scaled = x / scale
    if stochastic:
        q = torch.floor(
            scaled + philox_uniform(seed, x.shape[0], x.shape[1], x.device)
        )
    else:
        q = torch.round(scaled)  # half to even, like jnp.round
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_rowwise_plain(values, scales):
    return values.to(torch.float32) * scales


# -- the grouped launch's plan -----------------------------------------------

#: Leaves one launch takes (``kMaxLeaves`` in ``csrc/quant.cu``: their
#: descriptors fill the kernel's parameters, under 4 KB).
MAX_LEAVES = 64
_THREADS = 128  # kThreads: 4 warps a block, both kernels
_SLOTS = 8  # kSlots: float4 a quantize thread holds in registers
_DEQ_CHUNKS = 2048  # dequantize chunks a block takes (16 a thread)
_ALIGN = 16  # bytes: every leaf's slice of a packed buffer starts here

#: Quantize row classes (``csrc/quant.cu``): rows of <= 128 floats share a
#: warp, <= 1024 take a warp, <= 4096 a block (all held in registers);
#: anything else (wider, d % 4 != 0, or a misaligned source) is general.
SUBWARP, WARP, BLOCK, GENERAL = range(4)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Where one (n, d) leaf sits in a grouped launch and its buffers."""

    n: int
    d: int
    cls: int  # quantize: row class; dequantize: chunk width (4 or 1)
    lanes: int  # quantize sub-warp: lanes per row; dequantize: chunks a row
    rows_per_block: int
    blocks: int
    launch: int  # which launch of the group takes it
    first_block: int  # its first block within that launch
    values_offset: int  # bytes into the packed int8 buffer
    scales_offset: int  # elements into the packed f32 scales buffer
    out_offset: int  # elements into the packed f32 matrix buffer


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    direction: str  # "quantize" or "dequantize": the classes' meaning
    leaves: tuple[LeafPlan, ...]
    launches: int
    values_bytes: int
    scales_count: int
    out_count: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _quantize_class(d: int, aligned: bool) -> tuple[int, int, int]:
    """(row class, lanes per row, rows per block) of a quantize leaf."""
    if aligned and d % 4 == 0:
        d4 = d // 4
        if d4 <= 32:
            lanes = 1 << (d4 - 1).bit_length()
            return SUBWARP, lanes, 4 * _SLOTS * (32 // lanes)
        if d4 <= 32 * _SLOTS:
            return WARP, 0, 4
        if d4 <= _THREADS * _SLOTS:
            return BLOCK, 0, 1
    return GENERAL, 0, 4


def _dequantize_class(d: int, aligned: bool) -> tuple[int, int, int]:
    """(chunk width, chunks per row, rows per block) of a dequantize
    leaf."""
    width = 4 if aligned and d % 4 == 0 else 1
    per_row = d // width
    return width, per_row, max(1, _DEQ_CHUNKS // per_row)


def plan_group(shapes, direction: str, aligned=None) -> GroupPlan:
    """The grouped launch for matrices of ``shapes`` ((n, d) each, in leaf
    order): each leaf's row class, blocks, launch, first block and the
    16-byte aligned offsets of its slices of the packed values (int8),
    scales (f32) and matrix (f32) buffers.  ``aligned[i]`` says whether
    leaf i's own source pointer is 16-byte aligned (the packed buffers
    always are); a leaf that is not takes the scalar class."""
    shapes = tuple((int(n), int(d)) for n, d in shapes)
    aligned = (True,) * len(shapes) if aligned is None else \
        tuple(bool(a) for a in aligned)
    return _plan(shapes, direction, aligned)


@functools.lru_cache(maxsize=64)
def _plan(shapes, direction, aligned) -> GroupPlan:
    # Cached: an artifact's shapes repeat on every save and load, and
    # building the plan costs more host time than the launch it plans.
    if direction not in ("quantize", "dequantize"):
        raise ValueError(f"direction must be quantize or dequantize, got "
                         f"{direction!r}")
    classify = _quantize_class if direction == "quantize" else \
        _dequantize_class
    leaves = []
    values = scales = out = 0
    for i, (n, d) in enumerate(shapes):
        if n < 1 or d < 1:
            raise ValueError(f"a {direction} kernel needs a non-empty "
                             f"matrix, got {(n, d)}")
        cls, lanes, rows = classify(d, aligned[i])
        launch, index = divmod(i, MAX_LEAVES)
        first = 0 if index == 0 else \
            leaves[-1].first_block + leaves[-1].blocks
        leaves.append(LeafPlan(
            n=n, d=d, cls=cls, lanes=lanes, rows_per_block=rows,
            blocks=-(-n // rows), launch=launch, first_block=first,
            values_offset=values, scales_offset=scales, out_offset=out,
        ))
        values = _round_up(values + n * d, _ALIGN)
        scales = _round_up(scales + n, _ALIGN // 4)
        out = _round_up(out + n * d, _ALIGN // 4)
    return GroupPlan(direction=direction, leaves=tuple(leaves),
                     launches=-(-len(leaves) // MAX_LEAVES),
                     values_bytes=values, scales_count=scales,
                     out_count=out)


class _LeafDesc(ctypes.Structure):
    """``LeafDesc`` in ``csrc/quant.cu``."""

    _fields_ = [
        ("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
        ("scales", ctypes.c_void_p), ("n", ctypes.c_longlong),
        ("first_block", ctypes.c_longlong), ("d", ctypes.c_int),
        ("cls", ctypes.c_int), ("lanes", ctypes.c_int),
        ("rows_per_block", ctypes.c_int),
    ]


_fns: dict = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("quant"), name)
        if name == "lo_quantize_group":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_uint, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(direction: str, plan: GroupPlan, pointers, device, *,
            stochastic: bool = False, seed: int = 0) -> None:
    """Launch the plan's kernels on ``device``'s current stream; pointers
    are (src, dst, scales) per leaf."""
    if plan.direction != direction:
        raise ValueError(f"a {plan.direction} plan cannot launch the "
                         f"{direction} kernel")
    name = f"lo_{direction}_group"
    fn = _kernel(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for launch in range(plan.launches):
            descs = [
                _LeafDesc(src, dst, sc, lp.n, lp.first_block, lp.d, lp.cls,
                          lp.lanes, lp.rows_per_block)
                for lp, (src, dst, sc) in zip(plan.leaves, pointers)
                if lp.launch == launch
            ]
            table = (_LeafDesc * len(descs))(*descs)
            if direction == "quantize":
                status = fn(ctypes.addressof(table), len(descs),
                            int(stochastic), seed & _U32, stream)
            else:
                status = fn(ctypes.addressof(table), len(descs), stream)
            build.check(status, f"{direction}_rowwise")
            if direction == "quantize":
                count_launch(quantize_launches=1, quantize_leaves=len(descs))
            else:
                count_launch(dequantize_launches=1,
                             dequantize_leaves=len(descs))


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % _ALIGN == 0


def _span(buf: torch.Tensor, offset: int, count: int) -> torch.Tensor:
    return buf[offset:offset + count]


def _quantize_group(mats, *, stochastic: bool = False, seed: int = 0):
    """Quantize contiguous 2-D f32 matrices on one device into one packed
    int8 values buffer and one packed f32 scales buffer: one grouped
    launch on CUDA, the plain version per leaf on the CPU.  Returns
    (plan, values, scales)."""
    device = mats[0].device
    for m in mats:
        if m.dim() != 2 or m.dtype != torch.float32 or \
                not m.is_contiguous() or m.device != device:
            raise ValueError(
                f"grouped quantize takes contiguous 2-D float32 matrices on "
                f"{device}, got {m.dtype} {tuple(m.shape)} on {m.device}")
    plan = plan_group([m.shape for m in mats], "quantize",
                      [_aligned(m) for m in mats])
    values = torch.empty(plan.values_bytes, dtype=torch.int8, device=device)
    scales = torch.empty(plan.scales_count, dtype=torch.float32,
                         device=device)
    if device.type == "cpu":
        for m, lp in zip(mats, plan.leaves):
            v, s = quantize_rowwise_plain(m, stochastic=stochastic,
                                          seed=seed)
            _span(values, lp.values_offset, lp.n * lp.d).copy_(v.reshape(-1))
            _span(scales, lp.scales_offset, lp.n).copy_(s.reshape(-1))
    else:
        _launch("quantize", plan, [
            (m.data_ptr(), values.data_ptr() + lp.values_offset,
             scales.data_ptr() + 4 * lp.scales_offset)
            for m, lp in zip(mats, plan.leaves)
        ], device, stochastic=stochastic, seed=seed)
    return plan, values, scales


def _dequantize_group(plan: GroupPlan, values: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """The packed f32 matrices of packed int8 values and f32 scales laid
    out by ``plan``: one grouped launch on CUDA, the plain version per leaf
    on the CPU."""
    if plan.direction != "dequantize":
        raise ValueError(f"expected a dequantize plan, got a "
                         f"{plan.direction} plan")
    if values.dtype != torch.int8 or scales.dtype != torch.float32 or \
            values.device != scales.device or \
            values.numel() < plan.values_bytes or \
            scales.numel() < plan.scales_count or \
            not (values.is_contiguous() and scales.is_contiguous()):
        raise ValueError(
            f"packed buffers must be contiguous int8 ({plan.values_bytes}) "
            f"and float32 ({plan.scales_count}) on one device, got "
            f"{values.dtype} {values.numel()} on {values.device}, "
            f"{scales.dtype} {scales.numel()} on {scales.device}")
    out = torch.empty(plan.out_count, dtype=torch.float32,
                      device=values.device)
    if values.device.type == "cpu":
        for lp, (v, s) in zip(plan.leaves, _leaf_views(plan, values, scales)):
            _span(out, lp.out_offset, lp.n * lp.d).copy_(
                dequantize_rowwise_plain(v, s).reshape(-1))
    else:
        _launch("dequantize", plan, [
            (values.data_ptr() + lp.values_offset,
             out.data_ptr() + 4 * lp.out_offset,
             scales.data_ptr() + 4 * lp.scales_offset)
            for lp in plan.leaves
        ], values.device)
    return out


def _leaf_views(plan: GroupPlan, values, scales):
    """Per-leaf (values (n, d), scales (n, 1)) views of packed buffers
    (tensors or numpy arrays)."""
    return [
        (values[lp.values_offset:lp.values_offset + lp.n * lp.d].reshape(
            lp.n, lp.d),
         scales[lp.scales_offset:lp.scales_offset + lp.n].reshape(lp.n, 1))
        for lp in plan.leaves
    ]


def quantize_rowwise(x, *, stochastic: bool = False, seed: int = 0):
    """int8-quantize each row of a 2-D float tensor with a per-row scale.
    Returns (values int8 (n, d), scales f32 (n, 1)).

    Deterministic by default, as in the JAX package's artifact path,
    which always quantizes deterministically (a persistence format must
    load the same bytes every save)."""
    if x.dim() != 2:
        raise ValueError(f"expected 2-D input, got shape {tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"expected a float tensor, got {x.dtype}")
    if x.device.type == "cpu":
        return quantize_rowwise_plain(x, stochastic=stochastic, seed=seed)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, d = x.shape
    x = x.to(torch.float32).contiguous()
    plan = plan_group([(n, d)], "quantize", [_aligned(x)])
    values = torch.empty((n, d), device=x.device, dtype=torch.int8)
    scales = torch.empty((n, 1), device=x.device, dtype=torch.float32)
    _launch("quantize", plan,
            [(x.data_ptr(), values.data_ptr(), scales.data_ptr())],
            x.device, stochastic=stochastic, seed=seed)
    return values, scales


def dequantize_rowwise(values, scales):
    """int8 values (n, d) x per-row f32 scales (n, 1) -> f32 (n, d)."""
    if values.dim() != 2 or values.dtype != torch.int8:
        raise TypeError(
            f"values must be 2-D int8, got {values.dtype} {tuple(values.shape)}"
        )
    n, d = values.shape
    if tuple(scales.shape) != (n, 1) or scales.dtype != torch.float32:
        raise TypeError(
            f"scales must be ({n}, 1) float32, got {scales.dtype} "
            f"{tuple(scales.shape)}"
        )
    if values.device != scales.device:
        raise ValueError(f"values on {values.device}, scales on {scales.device}")
    if values.device.type == "cpu":
        return dequantize_rowwise_plain(values, scales)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    values = values.contiguous()
    scales = scales.contiguous()
    plan = plan_group([(n, d)], "dequantize", [_aligned(values)])
    out = torch.empty((n, d), device=values.device, dtype=torch.float32)
    _launch("dequantize", plan,
            [(values.data_ptr(), out.data_ptr(), scales.data_ptr())],
            values.device)
    return out


# -- quantized artifact format (pytree level) --------------------------------


class QuantizedLeaf:
    """Host-side container for one int8-quantized parameter tensor: the
    on-disk unit of the quantized artifact format (row-wise int8 values,
    per-row f32 scales, the original shape and dtype), plain numpy
    fields."""

    __slots__ = ("values", "scales", "shape", "dtype")

    def __init__(self, values, scales, shape, dtype):
        self.values = values
        self.scales = scales
        self.shape = tuple(shape)
        self.dtype = str(dtype)

    def __repr__(self):
        return (f"QuantizedLeaf(shape={self.shape}, dtype={self.dtype}, "
                f"int8+scales)")


# Below this many elements a tensor stays full precision: biases and
# norm scales are tiny (no footprint win) and precision-critical.
_QUANT_MIN_ELEMENTS = 4096


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class _Slot:
    """Stands for the i-th collected leaf while a tree is rebuilt."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _collect(tree, pick):
    """(the tree with each leaf ``pick`` accepts replaced by a _Slot, the
    accepted leaves in tree order)."""
    found = []

    def leaf_fn(leaf):
        if not pick(leaf):
            return leaf
        found.append(leaf)
        return _Slot(len(found) - 1)

    return _tree_map(leaf_fn, tree), found


def _fill(shell, results):
    return _tree_map(
        lambda x: results[x.index] if isinstance(x, _Slot) else x, shell)


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).removeprefix("torch.")


def _quantizable(leaf, min_elements: int) -> bool:
    if isinstance(leaf, torch.Tensor):
        floating, count = leaf.is_floating_point(), leaf.numel()
    elif isinstance(leaf, np.ndarray):
        floating, count = np.issubdtype(leaf.dtype, np.floating), leaf.size
    else:
        return False
    return floating and leaf.ndim >= 2 and count >= min_elements


def _as_matrix(leaf) -> torch.Tensor:
    """The leaf as the contiguous f32 (-1, shape[-1]) matrix the kernel
    reads, on the leaf's own device (numpy on the CPU)."""
    return torch.as_tensor(leaf).detach().to(torch.float32).reshape(
        -1, leaf.shape[-1]).contiguous()


def quantize_pytree(tree, *, min_elements: int = _QUANT_MIN_ELEMENTS):
    """int8-quantize every large float leaf of a nested dict of numpy
    arrays and tensors.

    >=2-D float leaves with at least ``min_elements`` elements become
    :class:`QuantizedLeaf` (leading axes flattened to ``(-1, shape[-1])``);
    everything else passes through untouched.  Tensor leaves are quantized
    on their own device, all of one device's leaves together (one grouped
    kernel launch and one device-to-host copy of each packed buffer on
    CUDA); numpy leaves on the CPU.  Each leaf's values and scales are
    numpy views of the packed host buffers.  Rounding is deterministic: a
    persistence format must load the same bytes every save."""
    shell, found = _collect(tree, lambda x: _quantizable(x, min_elements))
    by_device: dict = {}
    for i, leaf in enumerate(found):
        device = leaf.device if isinstance(leaf, torch.Tensor) else \
            torch.device("cpu")
        by_device.setdefault(device, []).append(i)
    quantized = [None] * len(found)
    for idx in by_device.values():
        plan, values, scales = _quantize_group(
            [_as_matrix(found[i]) for i in idx])
        views = _leaf_views(plan, values.cpu().numpy(), scales.cpu().numpy())
        for i, (v, s) in zip(idx, views):
            quantized[i] = QuantizedLeaf(v, s, found[i].shape,
                                         _dtype_name(found[i]))
    return _fill(shell, quantized)


def _host_tensor(arr, dtype) -> torch.Tensor:
    """A flat CPU tensor over a leaf's numpy field (a copy only where the
    array is read-only, which torch cannot wrap)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != dtype:
        raise TypeError(f"quantized leaf field must be {dtype}, got "
                        f"{arr.dtype}")
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr.reshape(-1))


def _upload(found, plan: GroupPlan, device):
    """The leaves' int8 values and f32 scales in packed buffers on
    ``device``, copied leaf by leaf into their slices."""
    values = torch.empty(plan.values_bytes, dtype=torch.int8, device=device)
    scales = torch.empty(plan.scales_count, dtype=torch.float32,
                         device=device)
    for leaf, lp in zip(found, plan.leaves):
        _span(values, lp.values_offset, lp.n * lp.d).copy_(
            _host_tensor(leaf.values, np.int8))
        _span(scales, lp.scales_offset, lp.n).copy_(
            _host_tensor(leaf.scales, np.float32))
    return values, scales


def _quantized_shapes(found):
    shapes = []
    for leaf in found:
        n, d = np.shape(leaf.values)
        if np.shape(leaf.scales) != (n, 1):
            raise TypeError(f"scales must be ({n}, 1), got "
                            f"{np.shape(leaf.scales)}")
        shapes.append((n, d))
    return shapes


def dequantize_pytree(tree, *, device="cuda"):
    """Inverse of :func:`quantize_pytree`: each QuantizedLeaf becomes a
    tensor on ``device`` in its original shape and dtype; other leaves
    pass through.  All leaves go up in one packed int8 buffer and one
    packed scales buffer, and one grouped kernel launch on CUDA (the plain
    version per leaf on the CPU) dequantizes them into one f32 buffer,
    whose per-leaf views are returned."""
    device = torch.device(device)
    shell, found = _collect(tree, lambda x: isinstance(x, QuantizedLeaf))
    if not found:
        return shell
    plan = plan_group(_quantized_shapes(found), "dequantize")
    out = _dequantize_group(plan, *_upload(found, plan, device))
    return _fill(shell, [
        _span(out, lp.out_offset, lp.n * lp.d).view(leaf.shape).to(
            getattr(torch, leaf.dtype))
        for leaf, lp in zip(found, plan.leaves)
    ])


def has_quantized_leaves(tree) -> bool:
    if isinstance(tree, dict):
        return any(has_quantized_leaves(v) for v in tree.values())
    return isinstance(tree, QuantizedLeaf)
