"""Flash attention — port of ``learningorchestra_tpu/ops/attention.py``.

``flash_attention_fwd`` is the wrapper of kernel K1 (``csrc/flash_fwd.cu``,
which replaces the Pallas ``_fwd_kernel``; tensor cores in both dtypes:
bf16 ``mma.sync``, and f32 as split TF32); ``flash_attention_bwd`` wraps
K2 and K3 (``csrc/flash_bwd.cu``: ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``).  A CUDA tensor launches the kernel or raises; a CPU
tensor goes to the ``*_plain`` version, the same arithmetic in plain
PyTorch (the backward's plain versions, like its kernels, recompute S and
dP in each pass).  Layout and padding rules are the JAX package's: q, k, v are
(B, H, T, D), the key mask is (B, Tk), the ragged tail is masked (in the
kernel, not by padding copies), fully-masked rows give O = 0 and LSE =
+1e30, and their gradients are exactly 0.

``flash_attention`` runs through :class:`_FlashAttention` (the
counterpart of the JAX ``_flash_core`` custom_vjp) whenever grad is on and
an input requires it, on both devices. The kernels' own tiles are 64 x 64
(the TPU's 256 x 512 blocks do not carry over to a Hopper SM).

FLOPs: an active FLOP counter (obs/costs.py) cannot see a ctypes
launch, so each wrapper adds its kernel's count by formula — 4 (K1), 6
(K2) and 8 (K3) · B·H·D · the live (query, key) pairs
(:func:`~learningorchestra_tpu_torch.obs.costs.attention_pairs`) — and
runs a plain version uncounted, so a program counts the same FLOPs on
the CPU and on the card.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from learningorchestra_tpu_torch.kernels import build
from learningorchestra_tpu_torch.obs import costs

_NEG_BIG = -1e30  # additive mask value; exp(_NEG_BIG - lse) == 0 in f32
_LSE_EMPTY = 1e30  # lse sentinel for fully-masked rows

#: Kernel launches made by ``flash_attention_fwd`` in this process.
launches = 0
#: K2 / K3 launches made by ``flash_attention_bwd`` in this process.
bwd_dq_launches = 0
bwd_dkv_launches = 0
_count_lock = threading.Lock()


def count_launch(counter: str, n: int = 1) -> None:
    """Add ``n`` to the module counter ``counter`` under a lock: replica
    batchers launch K1 from several threads at once, and ``+=`` on a
    module global is a read, an add and a store."""
    with _count_lock:
        globals()[counter] += n


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: FLOPs per (query, key) pair and head dimension of K1, K2 and K3: Q.K
#: and P.V forward; Q.K, dO.V and dS.K for dQ; Q.K, dO.V, dS.Q and P.dO
#: for dK, dV.
_FLOPS_PER_PAIR = {"flash_attention_fwd": 4, "flash_attention_bwd_dq": 6,
                   "flash_attention_bwd_dkv": 8}


def _note_flops(name: str, q, k, causal, window) -> None:
    """Add ``name``'s FLOPs by formula to an active FLOP counter."""
    if not costs.counting():
        return
    b, h, tq, d = q.shape
    costs.note_kernel_flops(name, _FLOPS_PER_PAIR[name] * b * h * d
                            * costs.attention_pairs(tq, k.shape[2],
                                                    bool(causal), window))


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


def _bwd_terms(q, k, v, key_mask, do, lse, delta, causal, window):
    """P = exp(S - LSE) * keep and dS = P * (dP - delta) * scale, both f32
    over whole rows: what each backward pass recomputes."""
    _validate_window(window, causal)
    b, _, tq, d = q.shape
    tk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    keep = _keep_mask(key_mask, b, tq, tk, causal, window, q.device)
    if keep is None:
        keep = torch.ones((), device=q.device)
    s = s + (keep - 1.0) * -_NEG_BIG
    p = torch.exp(s - lse) * keep
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta) * scale


def flash_attention_bwd_dq_plain(q, k, v, key_mask, do, lse, delta,
                                 causal: bool = False,
                                 window: int | None = None):
    """K2's arithmetic in plain PyTorch: dS cast to k's type before
    dQ = dS.K (the reference's rounding point).  Returns dq like q."""
    _, ds = _bwd_terms(q, k, v, key_mask, do, lse, delta, causal, window)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, key_mask, do, lse, delta,
                                  causal: bool = False,
                                  window: int | None = None):
    """K3's arithmetic in plain PyTorch: dS cast to q's type before
    dK = dS^T.Q, P cast to dO's type before dV = P^T.dO.  Returns (dk like
    k, dv like v)."""
    p, ds = _bwd_terms(q, k, v, key_mask, do, lse, delta, causal, window)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum(
        "bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float()
    )
    return dk.to(k.dtype), dv.to(v.dtype)


_lib_fns: dict = {}


def _kernel(symbol: str, n_ptr: int):
    """The ctypes function ``symbol`` of a flash library: ``n_ptr``
    pointers, the strides array, eight ints, the scale and the stream."""
    fn = _lib_fns.get(symbol)
    if fn is None:
        lib = build.load("flash_fwd" if symbol == "lo_flash_fwd"
                         else "flash_bwd")
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_void_p] * (n_ptr + 1) + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib_fns[symbol] = fn
    return fn


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
    q/k/v contiguous and their base addresses and batch/head/row strides
    16-byte aligned (so views of a fused qkv projection need no copy).  O
    is allocated (B, Tq, H, D) and returned as its (B, H, Tq, D)
    transpose, so merging heads afterwards is free.
    """
    _validate_window(window, causal)
    _check_inputs(q, k, v, key_mask)
    _note_flops("flash_attention_fwd", q, k, causal, window)
    if q.device.type == "cpu":
        with costs.uncounted():
            return flash_attention_fwd_plain(q, k, v, key_mask, causal,
                                             window)
    km = _check_kernel_inputs(q, k, v, key_mask)
    b, h, tq, d = q.shape
    o = _like_heads_last(q)
    _check_aligned(("q", q), ("k", k), ("v", v), ("o", o))
    lse = torch.empty((b, h, tq, 1), device=q.device, dtype=torch.float32)
    _launch("lo_flash_fwd", (q, k, v, km, o, lse), (q, k, v, o), q, k,
            causal, window)
    count_launch("launches")
    return o, lse


def _check_kernel_inputs(q, k, v, key_mask, *more):
    """What the CUDA kernels take: f32 or bf16 on a CUDA device, D a
    multiple of 8 up to 128, each tensor's last dim contiguous. Returns
    the key mask as contiguous f32 on q's device (or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
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
    for name, t in (("q", q), ("k", k), ("v", v)) + more:
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if key_mask is None:
        return None
    return key_mask.to(device=q.device, dtype=torch.float32).contiguous()


def _like_heads_last(x):
    """An empty (B, H, T, D) tensor like x whose memory is (B, T, H, D):
    merging heads afterwards (or the qkv projection's backward) reads it
    without a transposing copy."""
    b, h, t, d = x.shape
    return torch.empty((b, t, h, d), device=x.device,
                       dtype=x.dtype).transpose(1, 2)


def _launch(symbol, ptrs, strided, q, k, causal, window):
    """Launch a flash kernel on q's device and current stream: ``ptrs``
    are its tensor arguments (None for a null pointer), ``strided`` the
    tensors whose (batch, head, row) strides it takes, in order."""
    b, h, tq, d = q.shape
    strides = (ctypes.c_longlong * (3 * len(strided)))(
        *(t.stride(i) for t in strided for i in range(3))
    )
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(q.device):
        status = _kernel(symbol, len(ptrs))(
            *(t.data_ptr() if t is not None else None for t in ptrs),
            ctypes.addressof(strides), b, h, tq, k.shape[2], d,
            _DTYPES[q.dtype], int(causal), int(window or 0),
            1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(status, symbol)


def flash_attention_bwd_plain(q, k, v, key_mask, do, lse, delta,
                              causal: bool = False,
                              window: int | None = None):
    """K2 then K3's arithmetic in plain PyTorch: (dq, dk, dv)."""
    args = (q, k, v, key_mask, do, lse, delta, causal, window)
    return (flash_attention_bwd_dq_plain(*args),
            *flash_attention_bwd_dkv_plain(*args))


def _check_aligned(*named) -> None:
    """The tensor-core flash kernels (K1 in both dtypes, K2/K3 in bf16)
    copy 16-byte chunks (``cp.async``): each tensor's base address and its
    batch, head and row strides (those of dimensions longer than 1) must be
    multiples of 16 bytes."""
    for name, t in named:
        step = 16 // t.element_size()
        if t.data_ptr() % 16 or any(
            t.size(i) > 1 and t.stride(i) % step for i in range(3)
        ):
            raise ValueError(
                f"{name} must be 16-byte aligned for the flash kernels' "
                f"16-byte copies (base address and batch/head/row "
                f"strides): address {t.data_ptr():#x}, strides {t.stride()}"
            )


def _check_bwd_inputs(q, k, v, key_mask, do, lse, delta, causal, window):
    """Raise on arguments the backward does not take.  Returns None for
    CPU tensors (the plain path), else what the kernels take: the key mask
    as f32 (or None), LSE and delta contiguous on q's device."""
    _validate_window(window, causal)
    _check_inputs(q, k, v, key_mask)
    b, h, tq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"do must match q: got {do.dtype} {tuple(do.shape)} on "
            f"{do.device}, q is {q.dtype} {tuple(q.shape)} on {q.device}"
        )
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, tq, 1) or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be (B, H, Tq, 1) float32 = {(b, h, tq, 1)}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    if q.device.type == "cpu":
        return None
    km = _check_kernel_inputs(q, k, v, key_mask, ("do", do))
    if q.dtype == torch.bfloat16:
        _check_aligned(("q", q), ("k", k), ("v", v), ("do", do))
    return km, lse.to(q.device).contiguous(), delta.to(q.device).contiguous()


def _launch_dq(q, k, v, do, km, lse, delta, causal, window):
    """K2 on checked inputs; dq is allocated (B, T, H, D) in memory."""
    dq = _like_heads_last(q)
    _launch("lo_flash_bwd_dq", (q, k, v, km, do, lse, delta, dq),
            (q, k, v, do, dq), q, k, causal, window)
    count_launch("bwd_dq_launches")
    return dq


def _launch_dkv(q, k, v, do, km, lse, delta, causal, window):
    """K3 on checked inputs; dk, dv are allocated (B, T, H, D) in memory."""
    dk, dv = _like_heads_last(k), _like_heads_last(v)
    _launch("lo_flash_bwd_dkv", (q, k, v, km, do, lse, delta, dk, dv),
            (q, k, v, do, dk, dv), q, k, causal, window)
    count_launch("bwd_dkv_launches")
    return dk, dv


def flash_attention_bwd_dq(q, k, v, key_mask, do, lse, delta,
                           causal: bool = False, window: int | None = None):
    """dQ from the forward's LSE and delta = rowsum(dO * O) (both
    (B, H, Tq, 1) f32); ``do`` is in q's type.  On CUDA it launches K2,
    with the forward's limits (and, in bf16, 16-byte alignment); dq is
    allocated (B, T, H, D) in memory and returned as its (B, H, T, D)
    view, like the forward's O."""
    dev = _check_bwd_inputs(q, k, v, key_mask, do, lse, delta, causal,
                            window)
    _note_flops("flash_attention_bwd_dq", q, k, causal, window)
    if dev is None:
        with costs.uncounted():
            return flash_attention_bwd_dq_plain(q, k, v, key_mask, do, lse,
                                                delta, causal, window)
    return _launch_dq(q, k, v, do, *dev, causal, window)


def flash_attention_bwd_dkv(q, k, v, key_mask, do, lse, delta,
                            causal: bool = False, window: int | None = None):
    """(dK, dV) from the same inputs as :func:`flash_attention_bwd_dq`; on
    CUDA it launches K3."""
    dev = _check_bwd_inputs(q, k, v, key_mask, do, lse, delta, causal,
                            window)
    _note_flops("flash_attention_bwd_dkv", q, k, causal, window)
    if dev is None:
        with costs.uncounted():
            return flash_attention_bwd_dkv_plain(q, k, v, key_mask, do,
                                                 lse, delta, causal, window)
    return _launch_dkv(q, k, v, do, *dev, causal, window)


def flash_attention_bwd(q, k, v, key_mask, do, lse, delta,
                        causal: bool = False, window: int | None = None):
    """Blockwise attention backward: K2 then K3, as the JAX ``_bwd_call``
    runs its two passes, on inputs checked once.  Returns (dq, dk, dv) in
    q's, k's and v's types."""
    dev = _check_bwd_inputs(q, k, v, key_mask, do, lse, delta, causal,
                            window)
    _note_flops("flash_attention_bwd_dq", q, k, causal, window)
    _note_flops("flash_attention_bwd_dkv", q, k, causal, window)
    if dev is None:
        with costs.uncounted():
            return flash_attention_bwd_plain(q, k, v, key_mask, do, lse,
                                             delta, causal, window)
    args = (q, k, v, do, *dev, causal, window)
    return (_launch_dq(*args), *_launch_dkv(*args))


class _FlashAttention(torch.autograd.Function):
    """``_flash_core`` and its custom_vjp (JAX ``ops/attention.py``
    :530-559): the forward saves O and LSE, the backward computes delta =
    rowsum(dO * O) in plain torch (the JAX package does it in XLA outside
    Pallas) and runs K2 + K3. The key mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, window):
        o, lse = flash_attention_fwd(q, k, v, key_mask, causal, window)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        do = g.float()
        delta = (do * o.float()).sum(-1, keepdim=True)
        do = do.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, key_mask, do, lse, delta,
                                         ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, key_mask=None, *, causal: bool = False,
                    window: int | None = None):
    """Blockwise attention. q,k,v: (B, H, T, D); key_mask: (B, Tk).
    Differentiable through K2/K3 when grad is on and an input requires
    it; otherwise the bare forward (serving, evaluation)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, key_mask, causal, window)
    return flash_attention_fwd(q, k, v, key_mask, causal, window)[0]
