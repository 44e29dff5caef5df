"""Kernels 3, 4 and 5: flash attention with segment ids built from lengths,
forward and backward.

`flash_stock` launches `csrc/flash_stock.cu` (kernel 3) on CUDA tensors and
runs `flash_stock_plain` on CPU tensors. Both compute what JAX's stock TPU
flash kernel (`jax.experimental.pallas.ops.tpu.flash_attention.flash_attention`,
non-causal, with `SegmentIds`) computes where the JAX package's estimator
calls it (`jyutvoice_tpu/models/estimator.py::_attend`, "flash_stock"):
the segment id of position i is `i < length`, and query i sees key j iff the
two ids are equal. So valid queries see the valid keys, padded queries see
only the padded keys, and no row is empty: every row, padded ones included,
is a softmax over a non-empty key set. Scores are `q.k` in f32, then scaled
(`s *= sm_scale`, after the product); masked entries get `-0.7 * f32 max`.

Training: when autograd needs the gradient of q, k or v, `flash_stock` runs
the `FlashStock` function instead. Its forward is kernel 3 with the
residuals (the row max m and row sum l of the scaled scores, (B, H, T) f32)
and its backward `flash_stock_bwd`: di = sum(o * do) in torch, then
kernels 4 (`flash_stock_bwd_dkv`, dK and dV) and 5 (`flash_stock_bwd_dq`,
dQ) of `csrc/flash_stock_bwd.cu`, the counterparts of the stock kernel's
`_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`. Kernel 3's
products take bf16 operands, kernels 4 and 5 TF32 ones, all with f32
accumulation. On CPU tensors the same function runs the plain forward and
`flash_stock_bwd_plain`. Neither path falls back to the other.

Layout: q, k, v (and do) are (B, T, H, D), last dim contiguous, any other
strides (the estimator's (B, T, H*D) projections go in as views); outputs
and gradients are contiguous (B, T, H, D), i.e. merged heads. lengths (B,)
int32. The kernels take T a multiple of 64 (the long-form and training
gates send multiples of 512) and D in (64, 128); the sources' headers say
what bounds them and what their design does about that.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from jyutvoice_tpu_torch import kernels

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
TILE = 64  # the kernels' query and key tile
_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_void_p]
)


def _bwd_argtypes(n_ptr: int):
    return (
        [ctypes.c_void_p] * n_ptr
        + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )


def segment_keep_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B, 1, T, T) bool: query i sees key j iff (i < len) == (j < len)."""
    pos = torch.arange(t, device=lengths.device)
    seg = pos[None, :] < lengths[:, None].to(pos.dtype)  # (B, T)
    return (seg[:, :, None] == seg[:, None, :])[:, None]


def _scores(q, k, lengths, scale):
    """(B, H, T, T) f32 scaled scores with the segment mask added."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return s + torch.where(segment_keep_mask(lengths, q.shape[1]), 0.0, MASK_VALUE)


def flash_stock_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
    *, scale: float, residuals: bool = False,
):
    """Dense f32 scores, the segment-equality mask, softmax, P.V.
    (B, T, H, D) -> contiguous (B, T, H, D); with `residuals`, also the row
    max m and row sum l of the scaled scores, (B, H, T), as the stock
    kernel's forward saves them."""
    s = _scores(q, k, lengths, scale)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", e / l[..., None], v.float()).contiguous()
    return (o, m, l) if residuals else o


def flash_stock_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = sum(o * do, -1) as a contiguous (B, H, T) f32 tensor."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, do, m, l, di, lengths, scale):
    p = torch.exp(_scores(q, k, lengths, scale) - m[..., None]) / l[..., None]
    do = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = (dp - di[..., None]) * p * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


def flash_stock_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, m: torch.Tensor, l: torch.Tensor, lengths: torch.Tensor,
    *, scale: float,
):
    """The stock backward in dense f32 (`_flash_attention_bwd`'s form):
    p = exp(s - m) / l, di = sum(o * do), dv = p^T do, dp = do v^T,
    ds = (dp - di) * p * scale, dk = ds^T q, dq = ds k. Returns contiguous
    (B, T, H, D) dq, dk, dv."""
    return _bwd_plain(q, k, v, do, m, l, flash_stock_di(o, do), lengths, scale)


def _fn(source: str, name: str, argtypes):
    fn = getattr(kernels.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_operands(what: str, lengths, **tensors) -> None:
    q = tensors["q"]
    if not (q.is_cuda and lengths.device == q.device
            and all(a.device == q.device for a in tensors.values())):
        raise ValueError(f"{what}: tensors and lengths must share one CUDA device")
    if q.dim() != 4 or any(a.shape != q.shape for a in tensors.values()):
        shapes = ", ".join(f"{n} {tuple(a.shape)}" for n, a in tensors.items())
        raise ValueError(f"{what}: operands must be (B, T, H, D) alike, got {shapes}")
    if q.shape[3] not in (64, 128):
        raise ValueError(f"{what}: head dim {q.shape[3]} not in (64, 128)")
    if q.shape[1] % TILE or q.shape[1] == 0:
        raise ValueError(f"{what}: T={q.shape[1]} is not a positive multiple of {TILE}")
    for name, a in tensors.items():
        if a.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {a.dtype}")
        if a.stride(3) != 1 or any(s % 4 for s in a.stride()[:3]) or a.data_ptr() % 16:
            raise ValueError(f"{what}: {name} needs a contiguous last dim, "
                             "strides that are multiples of 4 and 16-byte alignment")
    if lengths.dtype != torch.int32 or lengths.shape != (q.shape[0],) or not lengths.is_contiguous():
        raise ValueError(f"{what}: lengths must be a contiguous (B,) int32 tensor")


def _launch_fwd(q, k, v, lengths, scale, residuals):
    _check_operands("flash_stock", lengths, q=q, k=k, v=v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), device=q.device, dtype=torch.float32)
    m = l = None
    if residuals:
        m = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
        l = torch.empty_like(m)
    status = _fn("flash_stock", "jv_flash_stock_fwd", _FWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr() if residuals else None, l.data_ptr() if residuals else None,
        lengths.data_ptr(), b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(status, "flash_stock")
    kernels.LAUNCHES["flash_stock"] += 1
    return (out, m, l) if residuals else out


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_stock(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
    *, scale: float, residuals: bool = False,
):
    """(B, T, H, D) q/k/v + (B,) lengths -> (B, T, H, D). CUDA tensors launch
    kernel 3; CPU tensors take the plain version. `residuals` also returns
    (m, l), (B, H, T). When autograd needs the gradient of q, k or v, the
    call goes through `FlashStock` (kernel 3 with residuals, kernels 4 and 5
    for the backward)."""
    if _needs_grad(q, k, v):
        if residuals:
            raise ValueError("flash_stock: residuals are the backward's input and "
                             "are not differentiable; call under torch.no_grad()")
        return FlashStock.apply(q, k, v, lengths, float(scale))
    if q.device.type == "cpu":
        return flash_stock_plain(q, k, v, lengths, scale=scale, residuals=residuals)
    return _launch_fwd(q, k, v, lengths, scale, residuals)


def _check_rows(what: str, q, **stats) -> None:
    b, t, h, _ = q.shape
    for name, a in stats.items():
        if a.shape != (b, h, t) or a.dtype != torch.float32 or not a.is_contiguous() \
                or a.device != q.device:
            raise ValueError(f"{what}: {name} must be a contiguous (B, H, T) float32 "
                             "tensor on q's device")


def _launch_bwd(entry, q, k, v, do, m, l, di, lengths, scale, outs):
    what = entry[3:]  # the kernel's name in LAUNCHES
    _check_operands(what, lengths, q=q, k=k, v=v, do=do)
    _check_rows(what, q, m=m, l=l, di=di)
    b, t, h, d = q.shape
    status = _fn("flash_stock_bwd", entry, _bwd_argtypes(7 + len(outs) + 1))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(),
        l.data_ptr(), di.data_ptr(), *(o.data_ptr() for o in outs), lengths.data_ptr(),
        b, t, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(status, what)
    kernels.LAUNCHES[what] += 1


def _grad_like(q):
    return torch.empty(q.shape, device=q.device, dtype=torch.float32)


def flash_stock_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor, di: torch.Tensor, lengths: torch.Tensor,
    *, scale: float,
):
    """Kernel 4: (dk, dv), contiguous (B, T, H, D) f32, from the residuals
    m, l and di = sum(o * do), each (B, H, T). CPU tensors take the plain
    backward."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, m, l, di, lengths, scale)[1:]
    dk, dv = _grad_like(q), _grad_like(q)
    _launch_bwd("jv_flash_stock_bwd_dkv", q, k, v, do, m, l, di, lengths, scale, (dk, dv))
    return dk, dv


def flash_stock_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor, di: torch.Tensor, lengths: torch.Tensor,
    *, scale: float,
):
    """Kernel 5: dq, contiguous (B, T, H, D) f32, from the same inputs as
    kernel 4. CPU tensors take the plain backward."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, m, l, di, lengths, scale)[0]
    dq = _grad_like(q)
    _launch_bwd("jv_flash_stock_bwd_dq", q, k, v, do, m, l, di, lengths, scale, (dq,))
    return dq


def flash_stock_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, m: torch.Tensor, l: torch.Tensor, lengths: torch.Tensor,
    *, scale: float,
):
    """dq, dk, dv (contiguous (B, T, H, D) f32) of kernel 3's output o given
    its gradient do and the residuals m, l. CUDA tensors compute
    di = sum(o * do) in torch (as the JAX package does in XLA) and launch
    kernels 4 and 5; CPU tensors take `flash_stock_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_stock_bwd_plain(q, k, v, o, do, m, l, lengths, scale=scale)
    di = flash_stock_di(o, do)
    dk, dv = flash_stock_bwd_dkv(q, k, v, do, m, l, di, lengths, scale=scale)
    dq = flash_stock_bwd_dq(q, k, v, do, m, l, di, lengths, scale=scale)
    return dq, dk, dv


class FlashStock(torch.autograd.Function):
    """Differentiable kernel 3: forward with residuals, backward through
    `flash_stock_bwd` (the counterpart of the stock kernel's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale):
        if q.device.type == "cpu":
            o, m, l = flash_stock_plain(q, k, v, lengths, scale=scale, residuals=True)
        else:
            o, m, l = _launch_fwd(q, k, v, lengths, scale, residuals=True)
        ctx.save_for_backward(q, k, v, o, m, l, lengths)
        ctx.scale = scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, m, l, lengths = ctx.saved_tensors
        dq, dk, dv = flash_stock_bwd(q, k, v, o, do.contiguous(), m, l, lengths,
                                     scale=ctx.scale)
        return dq, dk, dv, None, None
