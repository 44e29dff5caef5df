"""CAM++ speaker-embedding network.

The counterpart of the JAX package's `models/campplus.py` (the 3D-Speaker
CAM++ that the reference runs as `campplus.onnx`): 80-bin kaldi fbank at
16 kHz, mean-normalized over time -> 192-d speaker embedding. An FCM 2-D
residual front end over (frequency, time) with stride on frequency only, a
stride-2 TDNN, three CAM-attentive dense-TDNN blocks with transitions, and
mean + std statistics pooling into a dense layer. Batch norms use running
statistics. Channels-last (B, T, C); the front end runs NHWC with
H = frequency, W = time. Parameter names follow the JAX tree.

`build_campplus` makes the module from a tree: trees converted from an
ONNX export can carry conv biases (a batch norm folded into its conv) and
an affine dense batch norm, which the module then has too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CampPlusConfig:
    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4  # bottleneck = bn_size * growth_rate = 128
    init_channels: int = 128
    m_channels: int = 32  # FCM width
    num_layers: Tuple[int, ...] = (12, 24, 16)
    kernel_sizes: Tuple[int, ...] = (3, 3, 3)
    dilations: Tuple[int, ...] = (1, 2, 2)
    seg_len: int = 100  # CAM segment pooling window

    @property
    def fcm_out_channels(self) -> int:
        return self.m_channels * (self.feat_dim // 8)


class ResBlock2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv1 = core.Conv2d(in_ch, out_ch, 3)
        self.bn1 = core.BatchNorm(out_ch)
        self.conv2 = core.Conv2d(out_ch, out_ch, 3)
        self.bn2 = core.BatchNorm(out_ch)
        if stride != 1 or in_ch != out_ch:
            self.sc_conv = core.Conv2d(in_ch, out_ch, 1)
            self.sc_bn = core.BatchNorm(out_ch)

    def forward(self, x: Tensor, stride: int, mz) -> Tensor:
        out = mz(torch.relu(self.bn1(self.conv1(x, stride=(stride, 1)))))
        out = mz(self.bn2(self.conv2(out)))
        if hasattr(self, "sc_conv"):
            sc = mz(self.sc_bn(self.sc_conv(x, stride=(stride, 1), padding=(0, 0))))
        else:
            sc = x
        return torch.relu(out + sc)


class FCM(nn.Module):
    def __init__(self, cfg: CampPlusConfig):
        super().__init__()
        m = cfg.m_channels
        self.conv1 = core.Conv2d(1, m, 3)
        self.bn1 = core.BatchNorm(m)
        self.layer1 = nn.ModuleList([ResBlock2d(m, m, 2), ResBlock2d(m, m, 1)])
        self.layer2 = nn.ModuleList([ResBlock2d(m, m, 2), ResBlock2d(m, m, 1)])
        self.conv2 = core.Conv2d(m, m, 3)
        self.bn2 = core.BatchNorm(m)

    def forward(self, x: Tensor, mz) -> Tensor:
        """(B, T, F) fbank -> (B, T, C * F / 8)."""
        b, t, _ = x.shape
        h = x.transpose(1, 2)[..., None]  # (B, F, T, 1)
        h = mz(torch.relu(self.bn1(self.conv1(h))))
        for layer in (self.layer1, self.layer2):
            for i, blk in enumerate(layer):
                h = blk(h, 2 if i == 0 else 1, mz)
        h = mz(torch.relu(self.bn2(self.conv2(h, stride=(2, 1)))))
        # the reference flattens channel-major: feature c * F' + f
        return h.permute(0, 2, 3, 1).reshape(b, t, -1)


def _seg_pool_mean(x: Tensor, seg_len: int, t_valid: Optional[Tensor]) -> Tensor:
    """Per-segment time mean repeated over each segment (the CAM local
    context), as F.avg_pool1d(ceil_mode=True): the last partial segment
    averages its own frames. With t_valid (B,), frames past it are absent."""
    b, t, c = x.shape
    n_seg = -(-t // seg_len)
    pad = n_seg * seg_len - t
    sums = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(b, n_seg, seg_len, c).sum(dim=2)
    if t_valid is None:
        counts = torch.full((1, n_seg), float(seg_len), device=x.device)
        counts[0, -1] = float(seg_len - pad)
    else:
        starts = torch.arange(n_seg, dtype=torch.float32, device=x.device) * seg_len
        counts = torch.clamp(t_valid.float()[:, None] - starts[None, :], 1e-6, seg_len)
    means = sums / counts[:, :, None]
    return torch.repeat_interleave(means, seg_len, dim=1)[:, :t]


class CAMLayer(nn.Module):
    def __init__(self, bn_ch: int, out_ch: int, k: int):
        super().__init__()
        self.local = core.Conv1d(bn_ch, out_ch, k, bias=False)
        self.lin1 = core.Linear(bn_ch, bn_ch // 2)
        self.lin2 = core.Linear(bn_ch // 2, out_ch)

    def forward(self, x: Tensor, dilation: int, seg_len: int, mz, t_valid) -> Tensor:
        y = self.local(x, padding="same_torch", dilation=dilation)
        if t_valid is None:
            mean = x.mean(dim=1, keepdim=True)
        else:  # x is zero past t_valid: divide by the true count
            mean = x.sum(dim=1, keepdim=True) / t_valid[:, None, None].to(x.dtype)
        context = mean + _seg_pool_mean(x, seg_len, t_valid)
        m = torch.sigmoid(self.lin2(torch.relu(self.lin1(context))))
        return mz(y * m)


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, bn_ch: int, k: int):
        super().__init__()
        self.bn1 = core.BatchNorm(in_ch)
        self.linear1 = core.Linear(in_ch, bn_ch, bias=False)
        self.bn2 = core.BatchNorm(bn_ch)
        self.cam = CAMLayer(bn_ch, out_ch, k)

    def forward(self, x: Tensor, dilation: int, seg_len: int, mz, t_valid) -> Tensor:
        h = self.linear1(mz(torch.relu(self.bn1(x))))
        h = mz(torch.relu(self.bn2(h)))
        return self.cam(h, dilation, seg_len, mz, t_valid)


class Transit(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.bn = core.BatchNorm(ch)
        self.linear = core.Linear(ch, ch // 2, bias=False)


class DenseBlock(nn.Module):
    def __init__(self, in_ch: int, n_layers: int, cfg: CampPlusConfig, k: int):
        super().__init__()
        bn_ch = cfg.bn_size * cfg.growth_rate
        self.layers = nn.ModuleList(
            DenseLayer(in_ch + j * cfg.growth_rate, cfg.growth_rate, bn_ch, k)
            for j in range(n_layers)
        )
        self.transit = Transit(in_ch + n_layers * cfg.growth_rate)


class TDNN(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = core.Conv1d(in_ch, out_ch, 5, bias=False)
        self.bn = core.BatchNorm(out_ch)


class Dense(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.linear = core.Linear(in_ch, out_ch, bias=False)
        self.bn = core.BatchNorm(out_ch, affine=False)


class CampPlus(nn.Module):
    def __init__(self, cfg: CampPlusConfig = CampPlusConfig()):
        super().__init__()
        self.cfg = cfg
        self.head = FCM(cfg)
        self.tdnn = TDNN(cfg.fcm_out_channels, cfg.init_channels)
        blocks, ch = [], cfg.init_channels
        for n_layers, k in zip(cfg.num_layers, cfg.kernel_sizes):
            blocks.append(DenseBlock(ch, n_layers, cfg, k))
            ch = (ch + n_layers * cfg.growth_rate) // 2
        self.blocks = nn.ModuleList(blocks)
        self.out_bn = core.BatchNorm(ch)
        self.dense = Dense(ch * 2, cfg.embedding_size)


def _add_optional(module: nn.Module, node) -> None:
    """Give conv leaves the bias and batch norms the weight and bias that
    the tree node carries."""
    if isinstance(module, (core.Conv1d, core.Conv2d, core.Linear)):
        if isinstance(node, dict) and "b" in node and module.bias is None:
            module.bias = nn.Parameter(torch.empty(module.weight.shape[0]),
                                       requires_grad=False)
        return
    if isinstance(module, core.BatchNorm):
        if isinstance(node, dict) and "gamma" in node and module.weight is None:
            n = module.running_mean.shape[0]
            module.weight = nn.Parameter(torch.empty(n), requires_grad=False)
            module.bias = nn.Parameter(torch.empty(n), requires_grad=False)
        return
    if isinstance(module, nn.ModuleList):
        for i, child in enumerate(module):
            if isinstance(node, (list, tuple)) and i < len(node):
                _add_optional(child, node[i])
        return
    for name, child in module.named_children():
        if isinstance(node, dict) and name in node:
            _add_optional(child, node[name])


def build_campplus(tree, cfg: CampPlusConfig = CampPlusConfig()) -> CampPlus:
    """A CampPlus module holding the JAX-layout tree `tree` (strict both
    ways, through `weights/from_jax.py`), on the CPU."""
    model = CampPlus(cfg)
    _add_optional(model, tree)
    return load_jax_params(model, tree).eval()


def apply_campplus(model: CampPlus, feat: Tensor, t_len: Optional[Tensor] = None) -> Tensor:
    """Mean-normalized kaldi fbank (B, T, 80) -> speaker embedding (B, 192).

    With t_len ((B,) valid frame counts) the input may be zero-padded to
    any T: every layer output is zeroed past the valid frames (so each conv
    sees the zeros an exact-length run would), and the CAM context means,
    the segment pooling and the statistics pooling divide by the true
    counts, so a bucket-padded run equals the exact-length run."""
    cfg = model.cfg
    t = feat.shape[1]
    if t_len is None:
        mz2d = mzt = lambda x: x  # noqa: E731
        t1 = None
    else:
        tl = t_len.to(torch.int64)
        m1 = (torch.arange(t, device=feat.device)[None, :] < tl[:, None])[..., None]
        feat = torch.where(m1, feat, 0.0)
        m2d = m1[:, None, :, :]  # NHWC (B, F, T, C): time on axis 2
        mz2d = lambda x: torch.where(m2d, x, 0.0)  # noqa: E731

    x = model.head(feat, mz2d)
    x = model.tdnn.conv(x, stride=2, padding=(2, 2))
    if t_len is not None:
        # after the stride-2 TDNN (k 5, pad 2) the valid length is (t - 1) // 2 + 1
        t1 = torch.div(tl - 1, 2, rounding_mode="floor") + 1
        mt = (torch.arange(x.shape[1], device=x.device)[None, :] < t1[:, None])[..., None]
        mzt = lambda y: torch.where(mt, y, 0.0)  # noqa: E731
    x = mzt(torch.relu(model.tdnn.bn(x)))
    for block, d in zip(model.blocks, cfg.dilations):
        for layer in block.layers:
            x = torch.cat([x, layer(x, d, cfg.seg_len, mzt, t1)], dim=-1)
        x = block.transit.linear(mzt(torch.relu(block.transit.bn(x))))
    x = mzt(torch.relu(model.out_bn(x)))
    # statistics pooling: mean and unbiased std over the valid frames
    if t1 is None:
        mean = x.mean(dim=1)
        var = x.var(dim=1, unbiased=True)
    else:
        n = t1.to(x.dtype)[:, None]
        mean = x.sum(dim=1) / n
        dev = mzt(x - mean[:, None, :])
        var = torch.square(dev).sum(dim=1) / torch.clamp(n - 1.0, min=1.0)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return model.dense.bn(model.dense.linear(torch.cat([mean, std], dim=-1)))
