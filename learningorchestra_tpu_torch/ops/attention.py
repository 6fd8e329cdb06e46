"""Flash attention — port of ``learningorchestra_tpu/ops/attention.py``.

``flash_attention_fwd`` is the wrapper of kernel K1 (``csrc/flash_fwd.cu``,
which replaces the Pallas ``_fwd_kernel``).  A CUDA tensor launches the
kernel or raises; a CPU tensor goes to ``flash_attention_fwd_plain``, the
same arithmetic in plain PyTorch.  Layout and padding rules are the JAX
package's: q, k, v are (B, H, T, D), the key mask is (B, Tk), the ragged
tail is masked (in the kernel, not by padding copies), fully-masked rows
give O = 0 and LSE = +1e30.

The kernel's own tiles are 64 x 64 (the TPU's 256 x 512 blocks do not
carry over to a Hopper SM).  Backward (K2, K3) is not ported yet: on CUDA a
call whose inputs require grad raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from learningorchestra_tpu_torch.kernels import build

_NEG_BIG = -1e30  # additive mask value; exp(_NEG_BIG - lse) == 0 in f32
_LSE_EMPTY = 1e30  # lse sentinel for fully-masked rows

#: Kernel launches made by ``flash_attention_fwd`` in this process.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _validate_window(window, causal) -> None:
    if window is None:
        return
    if not causal:
        raise ValueError("window requires causal=True")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _keep_mask(key_mask, b, tq, tk, causal, window, device):
    """(B|1, 1, Tq|1, Tk) float keep mask, or None when nothing is masked."""
    keep = None
    if key_mask is not None:
        keep = key_mask.to(torch.float32).reshape(b, 1, 1, tk)
    if causal:
        rows = torch.arange(tq, device=device)[:, None]
        cols = torch.arange(tk, device=device)[None, :]
        tri = cols <= rows
        if window is not None:
            tri = tri & (cols > rows - window)
        tri = tri.to(torch.float32)[None, None]
        keep = tri if keep is None else keep * tri
    return keep


def mha_reference(q, k, v, key_mask=None, causal: bool = False,
                  window: int | None = None):
    """Plain multi-head attention. q,k,v: (B, H, T, D); key_mask: (B, Tk).

    Fully-masked rows output exactly 0 (the double-``where`` pattern of
    the JAX reference)."""
    _validate_window(window, causal)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    b, _, tq, _ = q.shape
    tk = k.shape[2]
    keep = _keep_mask(key_mask, b, tq, tk, causal, window, q.device)
    if keep is None:
        p = torch.softmax(s, dim=-1)
    else:
        maskb = keep > 0
        m = torch.amax(torch.where(maskb, s, _NEG_BIG), dim=-1, keepdim=True)
        m = torch.where(m > _NEG_BIG / 2, m, 0.0)
        p = torch.exp(torch.where(maskb, s - m, _NEG_BIG))
        p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_fwd_plain(q, k, v, key_mask=None, causal: bool = False,
                              window: int | None = None):
    """The kernel's arithmetic in plain PyTorch, over whole rows: f32
    scores scaled after the product, additive -1e30 on masked keys, P
    multiplied by keep, P rounded to the storage dtype before P.V.
    Returns (O like q, LSE (B, H, Tq, 1) f32)."""
    _validate_window(window, causal)
    b, _, tq, d = q.shape
    tk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    keep = _keep_mask(key_mask, b, tq, tk, causal, window, q.device)
    if keep is None:
        keep = torch.ones((), device=q.device)
    s = s + (keep - 1.0) * -_NEG_BIG
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m) * keep
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()
    )
    nonempty = l > 0.0
    o = torch.where(nonempty, acc / torch.where(nonempty, l, 1.0), 0.0)
    lse = torch.where(
        nonempty, m + torch.log(torch.clamp_min(l, 1e-30)), _LSE_EMPTY
    )
    return o.to(q.dtype), lse


_lib_fn = None


def _kernel():
    global _lib_fn
    if _lib_fn is None:
        fn = build.load("flash_fwd").lo_flash_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib_fn = fn
    return _lib_fn


def _check_inputs(q, k, v, key_mask):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, T, D), got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if key_mask is not None and tuple(key_mask.shape) != (b, k.shape[2]):
        raise ValueError(
            f"key_mask must be (B, Tk) = {(b, k.shape[2])}, got "
            f"{tuple(key_mask.shape)}"
        )


def flash_attention_fwd(q, k, v, key_mask=None, causal: bool = False,
                        window: int | None = None):
    """Blockwise attention forward. Returns (O like q, LSE (B, H, Tq, 1)
    f32).

    On CUDA: f32 or bf16, D a multiple of 8 up to 128, the last dim of
    q/k/v contiguous (any batch/head/row strides, so views of a fused qkv
    projection need no copy).  O is allocated (B, Tq, H, D) and returned
    as its (B, H, Tq, D) transpose, so merging heads afterwards is free.
    """
    global launches
    _validate_window(window, causal)
    _check_inputs(q, k, v, key_mask)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, key_mask, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)
    ):
        raise NotImplementedError(
            "flash attention backward (K2/K3) is not ported yet: it comes "
            "with the training slice; call under torch.inference_mode()"
        )
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"flash kernel needs D in 8..128, a multiple of 8; got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"flash kernel grid limit: B, H <= 65535, got {b}, {h}")
    if tq == 0 or tk == 0:
        raise ValueError("flash kernel needs Tq, Tk >= 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    km = None
    if key_mask is not None:
        km = key_mask.to(device=q.device, dtype=torch.float32).contiguous()
    o = torch.empty((b, tq, h, d), device=q.device, dtype=q.dtype)
    o = o.transpose(1, 2)
    lse = torch.empty((b, h, tq, 1), device=q.device, dtype=torch.float32)
    strides = (ctypes.c_longlong * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
    )
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(q.device):
        status = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            km.data_ptr() if km is not None else None,
            o.data_ptr(), lse.data_ptr(), ctypes.addressof(strides),
            b, h, tq, tk, d, _DTYPES[q.dtype], int(causal),
            int(window or 0), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(status, "flash_fwd")
    launches += 1
    return o, lse


def flash_attention(q, k, v, key_mask=None, *, causal: bool = False,
                    window: int | None = None):
    """Blockwise attention. q,k,v: (B, H, T, D); key_mask: (B, Tk)."""
    return flash_attention_fwd(q, k, v, key_mask, causal, window)[0]
