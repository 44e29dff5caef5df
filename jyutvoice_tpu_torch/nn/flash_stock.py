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
`_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`. Both read their
operands from one buffer that `flash_stock_bwd_prepare` writes once per
backward (a third launch of the same source): q, do, k and v rounded to
TF32 and laid out as the tiles wgmma reads, q, do and k also transposed,
and the log2-domain normaliser of each row. Kernel 3's products take fp16
operands (bf16 put rows that see a handful of keys past the bar:
`scripts/flash_fwd_precision.py`), kernels 4 and 5 TF32 ones, all with f32 accumulation;
`flash_stock_bwd_rounded` is their rounding in plain PyTorch. On CPU
tensors the same function runs the plain forward and
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
from jyutvoice_tpu_torch.nn.resblock_stage import swizzle_index, tf32_round

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
TILE = 64  # the kernels' query and key tile
_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_void_p]
)
_PREP_ARGTYPES = (
    [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 12
    + [ctypes.c_void_p]
)
# kernel 4 (two outputs) and kernel 5 (one): prepared, di, outputs, lengths
_BWD_ARGTYPES = {
    n: [ctypes.c_void_p] * (3 + n) + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    for n in (1, 2)
}


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


# ---------------------------------------------------------------------------
# Kernels 4 and 5's operands and arithmetic in plain PyTorch
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
# the prepared buffer's tile images, in order; "_t": transposed
PREP_REGIONS = ("q", "do", "q_t", "do_t", "k", "v", "k_t")
# an accumulator serves as the A operand of the next tf32 product with its
# columns in this order within each 8 (csrc/hopper.cuh); the transposed
# images store their 64 positions so
K_ORDER = tuple(8 * (i // 8) + (0, 2, 4, 6, 1, 3, 5, 7)[i % 8] for i in range(TILE))


def prep_numel(b: int, t: int, h: int, d: int) -> int:
    """f32 elements of the prepared buffer: 7 tile regions and lse2."""
    return b * h * t * (len(PREP_REGIONS) * d + 1)


def _tile_images(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) -> (B, H, T/64, 64 * D): each 64-row tile rounded to
    TF32 as a K-major image, D/32 blocks of (64 rows x 32) each swizzled
    (`swizzle_index`)."""
    b, t, h, d = x.shape
    y = tf32_round(x.float()).permute(0, 2, 1, 3).reshape(b, h, t // TILE, TILE, d // 32, 32)
    y = y.transpose(3, 4).reshape(b, h, t // TILE, d // 32, TILE * 32)
    return y[..., swizzle_index(TILE).to(x.device)].reshape(b, h, t // TILE, TILE * d)


def _transposed_images(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) -> (B, H, T/64, D * 64): each tile rounded to TF32 and
    transposed (D rows, the 64 positions in `K_ORDER`), as 2 blocks of
    (D rows x 32) each swizzled."""
    b, t, h, d = x.shape
    y = tf32_round(x.float()).permute(0, 2, 1, 3).reshape(b, h, t // TILE, TILE, d)
    y = y[:, :, :, list(K_ORDER)].transpose(3, 4)  # (b, h, nt, d, 64)
    y = y.reshape(b, h, t // TILE, d, 2, 32).transpose(3, 4).reshape(b, h, t // TILE, 2, d * 32)
    return y[..., swizzle_index(d).to(x.device)].reshape(b, h, t // TILE, d * TILE)


def flash_stock_bwd_prepare_plain(q, k, v, do, m, l) -> torch.Tensor:
    """The preparation in plain PyTorch: one flat f32 tensor holding the
    tile images of `PREP_REGIONS` (q, do, k, v as `_tile_images`; q, do, k
    transposed as `_transposed_images`), each (B, H, T/64, 64 D), then
    lse2 = m log2(e) + log2(l), (B, H, T)."""
    images = {"q": q, "do": do, "k": k, "v": v}
    parts = [(_transposed_images(images[r[:-2]]) if r.endswith("_t") else _tile_images(images[r]))
             for r in PREP_REGIONS]
    lse2 = m.float() * LOG2E + torch.log2(l.float())
    return torch.cat([a.reshape(-1) for a in parts] + [lse2.reshape(-1)])


def flash_stock_bwd_rounded(
    q, k, v, do, m, l, di, lengths, *, scale: float, round_scores=tf32_round,
    round_grads=tf32_round,
):
    """Kernels 4 and 5's arithmetic in dense PyTorch, for their error budget:
    q and k rounded by `round_scores` for s = q k^T, p = exp2(s scale
    log2(e) - lse2) with masked entries 0, and every other operand (do, v,
    p, ds = p (dp - di), q, k) rounded by `round_grads` where it enters a
    product; f32 otherwise. Returns dq, dk, dv as `_bwd_plain` does."""
    q, k, v, do = (a.float() for a in (q, k, v, do))
    lse2 = m.float() * LOG2E + torch.log2(l.float())
    s = torch.einsum("bqhd,bkhd->bhqk", round_scores(q), round_scores(k))
    p = torch.exp2(s * (scale * LOG2E) - lse2[..., None])
    p = torch.where(segment_keep_mask(lengths, q.shape[1]), p, 0.0)
    r = round_grads
    dp = torch.einsum("bqhd,bkhd->bhqk", r(do), r(v))
    ds = p * (dp - di[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", r(p), r(do))
    dk = torch.einsum("bhqk,bqhd->bkhd", r(ds), r(q)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", r(ds), r(k)) * scale
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


def _fn(source: str, name: str, argtypes):
    fn = getattr(kernels.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_operands(what: str, lengths, **tensors) -> None:
    """Raise on operands the kernels do not take (lengths None: none to check)."""
    q = tensors["q"]
    if not (q.is_cuda and (lengths is None or lengths.device == q.device)
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
    if lengths is not None and (lengths.dtype != torch.int32 or lengths.shape != (q.shape[0],)
                                or not lengths.is_contiguous()):
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
    kernels.count_launch("flash_stock")
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
                or a.device != q.device or a.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be a contiguous, 16-byte aligned "
                             "(B, H, T) float32 tensor on q's device")


def flash_stock_bwd_prepare(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor,
) -> torch.Tensor:
    """The operands of kernels 4 and 5 in the layout they read (one flat f32
    tensor; `flash_stock_bwd_prepare_plain` says what it holds). CUDA
    tensors launch the preparation kernel of `csrc/flash_stock_bwd.cu`;
    CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_stock_bwd_prepare_plain(q, k, v, do, m, l)
    _check_operands("flash_stock_bwd_prep", None, q=q, k=k, v=v, do=do)
    _check_rows("flash_stock_bwd_prep", q, m=m, l=l)
    b, t, h, d = q.shape
    prep = torch.empty(prep_numel(b, t, h, d), device=q.device, dtype=torch.float32)
    status = _fn("flash_stock_bwd", "jv_flash_stock_bwd_prep", _PREP_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
        prep.data_ptr(), b, t, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *do.stride()[:3], torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(status, "flash_stock_bwd_prep")
    kernels.count_launch("flash_stock_bwd_prep")
    return prep


def _launch_bwd(entry, q, k, v, do, m, l, di, lengths, scale, prepared, outs):
    what = entry[3:]  # the kernel's name in LAUNCHES
    _check_operands(what, lengths, q=q, k=k, v=v, do=do)
    _check_rows(what, q, m=m, l=l, di=di)
    b, t, h, d = q.shape
    if prepared is None:
        prepared = flash_stock_bwd_prepare(q, k, v, do, m, l)
    elif (prepared.device != q.device or prepared.dtype != torch.float32
          or prepared.numel() != prep_numel(b, t, h, d) or not prepared.is_contiguous()):
        raise ValueError(f"{what}: `prepared` is not flash_stock_bwd_prepare's output "
                         "for these operands")
    status = _fn("flash_stock_bwd", entry, _BWD_ARGTYPES[len(outs)])(
        prepared.data_ptr(), di.data_ptr(), *(o.data_ptr() for o in outs), lengths.data_ptr(),
        b, t, h, d, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(status, what)
    kernels.count_launch(what)


def _grad_like(q):
    return torch.empty(q.shape, device=q.device, dtype=torch.float32)


def flash_stock_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor, di: torch.Tensor, lengths: torch.Tensor,
    *, scale: float, prepared: torch.Tensor = None,
):
    """Kernel 4: (dk, dv), contiguous (B, T, H, D) f32, from the residuals
    m, l and di = sum(o * do), each (B, H, T). `prepared` is
    `flash_stock_bwd_prepare`'s output for these operands; without it the
    call prepares its own. CPU tensors take the plain backward."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, m, l, di, lengths, scale)[1:]
    dk, dv = _grad_like(q), _grad_like(q)
    _launch_bwd("jv_flash_stock_bwd_dkv", q, k, v, do, m, l, di, lengths, scale, prepared,
                (dk, dv))
    return dk, dv


def flash_stock_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor, di: torch.Tensor, lengths: torch.Tensor,
    *, scale: float, prepared: torch.Tensor = None,
):
    """Kernel 5: dq, contiguous (B, T, H, D) f32, from the same inputs as
    kernel 4. CPU tensors take the plain backward."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, m, l, di, lengths, scale)[0]
    dq = _grad_like(q)
    _launch_bwd("jv_flash_stock_bwd_dq", q, k, v, do, m, l, di, lengths, scale, prepared, (dq,))
    return dq


def flash_stock_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, m: torch.Tensor, l: torch.Tensor, lengths: torch.Tensor,
    *, scale: float,
):
    """dq, dk, dv (contiguous (B, T, H, D) f32) of kernel 3's output o given
    its gradient do and the residuals m, l. CUDA tensors compute
    di = sum(o * do) in torch (as the JAX package does in XLA), prepare the
    operands once and launch kernels 4 and 5 on them; CPU tensors take
    `flash_stock_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_stock_bwd_plain(q, k, v, o, do, m, l, lengths, scale=scale)
    di = flash_stock_di(o, do)
    prep = flash_stock_bwd_prepare(q, k, v, do, m, l)
    dk, dv = flash_stock_bwd_dkv(q, k, v, do, m, l, di, lengths, scale=scale, prepared=prep)
    dq = flash_stock_bwd_dq(q, k, v, do, m, l, di, lengths, scale=scale, prepared=prep)
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
