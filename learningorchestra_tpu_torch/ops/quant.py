"""Row-wise int8 quantization — port of ``learningorchestra_tpu/ops/quant.py``.

``quantize_rowwise`` (kernel K4) and ``dequantize_rowwise`` (kernel K5)
launch ``csrc/quant.cu`` on CUDA tensors and run their plain PyTorch
versions on CPU tensors.  Deterministic quantization is bit-identical to
the Pallas kernel as XLA compiles it: ``scale = max(|x|max, 1e-12) *
f32(1/127)``, IEEE ``x / scale``, round half to even, clip to +-127.
Stochastic rounding uses Philox4x32-10 keyed by (seed, row); the plain
version computes the same Philox words, so kernel and plain agree bit for
bit, but neither reproduces the TPU's random bits.

The artifact format (``QuantizedLeaf``, ``quantize_pytree``,
``dequantize_pytree``) is the JAX package's: plain numpy fields, leading
axes flattened to ``reshape(-1, shape[-1])``, so an int8 artifact holds
exactly the JAX package's int8 rows and scales.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from learningorchestra_tpu_torch.kernels import build

#: Kernel launches made by ``quantize_rowwise`` / ``dequantize_rowwise``.
quantize_launches = 0
dequantize_launches = 0

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


_fns: dict = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("quant"), name)
        if name == "lo_quantize_rowwise":
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                ctypes.c_void_p,
            ]
        else:
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def quantize_rowwise(x, *, stochastic: bool = False, seed: int = 0):
    """int8-quantize each row of a 2-D float tensor with a per-row scale.
    Returns (values int8 (n, d), scales f32 (n, 1)).

    Deterministic by default: the port has no training path yet, and the
    artifact format always quantizes deterministically."""
    global quantize_launches
    if x.dim() != 2:
        raise ValueError(f"expected 2-D input, got shape {tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"expected a float tensor, got {x.dtype}")
    if x.device.type == "cpu":
        return quantize_rowwise_plain(x, stochastic=stochastic, seed=seed)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, d = x.shape
    if n == 0 or d == 0:
        raise ValueError(f"quantize kernel needs a non-empty matrix, got {(n, d)}")
    x = x.to(torch.float32).contiguous()
    values = torch.empty((n, d), device=x.device, dtype=torch.int8)
    scales = torch.empty((n, 1), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        status = _kernel("lo_quantize_rowwise")(
            x.data_ptr(), values.data_ptr(), scales.data_ptr(), n, d,
            int(stochastic), seed & 0xFFFFFFFF,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(status, "quantize_rowwise")
    quantize_launches += 1
    return values, scales


def dequantize_rowwise(values, scales):
    """int8 values (n, d) x per-row f32 scales (n, 1) -> f32 (n, d)."""
    global dequantize_launches
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
    if n == 0 or d == 0:
        raise ValueError(f"dequantize kernel needs a non-empty matrix, got {(n, d)}")
    values = values.contiguous()
    scales = scales.contiguous()
    out = torch.empty((n, d), device=values.device, dtype=torch.float32)
    with torch.cuda.device(values.device):
        status = _kernel("lo_dequantize_rowwise")(
            values.data_ptr(), scales.data_ptr(), out.data_ptr(), n, d,
            torch.cuda.current_stream(values.device).cuda_stream,
        )
    build.check(status, "dequantize_rowwise")
    dequantize_launches += 1
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


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).removeprefix("torch.")


def quantize_pytree(tree, *, min_elements: int = _QUANT_MIN_ELEMENTS):
    """int8-quantize every large float leaf of a nested dict of numpy
    arrays and tensors.

    >=2-D float leaves with at least ``min_elements`` elements become
    :class:`QuantizedLeaf` (leading axes flattened to ``(-1, shape[-1])``);
    everything else passes through untouched.  A tensor leaf is quantized
    on its own device (the kernel on CUDA); a numpy leaf on the CPU.
    Rounding is deterministic: a persistence format must load the same
    bytes every save."""

    def leaf_fn(leaf):
        if isinstance(leaf, torch.Tensor):
            floating, count = leaf.is_floating_point(), leaf.numel()
        elif isinstance(leaf, np.ndarray):
            floating = np.issubdtype(leaf.dtype, np.floating)
            count = leaf.size
        else:
            return leaf
        if not floating or leaf.ndim < 2 or count < min_elements:
            return leaf
        mat = torch.as_tensor(leaf).detach().to(torch.float32)
        values, scales = quantize_rowwise(mat.reshape(-1, leaf.shape[-1]))
        return QuantizedLeaf(
            values.cpu().numpy(), scales.cpu().numpy(),
            leaf.shape, _dtype_name(leaf),
        )

    return _tree_map(leaf_fn, tree)


def dequantize_pytree(tree, *, device="cuda"):
    """Inverse of :func:`quantize_pytree`: each QuantizedLeaf becomes a
    tensor on ``device`` in its original shape and dtype (dequantized by
    the kernel on CUDA); other leaves pass through."""
    device = torch.device(device)

    def leaf_fn(leaf):
        if not isinstance(leaf, QuantizedLeaf):
            return leaf
        # torch.tensor copies: the leaf's arrays may be read-only.
        mat = dequantize_rowwise(
            torch.tensor(leaf.values, device=device),
            torch.tensor(leaf.scales, device=device),
        )
        return mat.reshape(leaf.shape).to(getattr(torch, leaf.dtype))

    return _tree_map(leaf_fn, tree)


def has_quantized_leaves(tree) -> bool:
    if isinstance(tree, dict):
        return any(has_quantized_leaves(v) for v in tree.values())
    return isinstance(tree, QuantizedLeaf)
