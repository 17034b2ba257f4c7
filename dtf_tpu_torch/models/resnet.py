"""ResNet-20 (CIFAR) and ResNet-50 v1.5 (ImageNet), BASELINE configs 2 and 3
(counterpart of ``dtf_tpu.models.resnet``).

The JAX package's choices, kept: compute at ``dtype`` (bf16 by default),
parameters and BatchNorm statistics in f32, the head in f32 after the
spatial mean; batches arrive NHWC. ``x.permute(0, 3, 1, 2)`` of an NHWC
tensor is NCHW in channels-last memory, with no copy, and on the card
the convolutions run so (cuDNN; XLA computes them without a Pallas
kernel too). On the CPU they run on contiguous NCHW: this torch's CPU
convolution backward corrupts memory on channels-last inputs.

- :class:`Conv` is flax's ``nn.Conv(padding="SAME", use_bias=False)``:
  XLA's SAME padding puts the odd pixel of a strided window's padding at
  the end (``lo = total // 2``, ``hi = total - lo``), which torch's
  symmetric ``padding`` cannot say; such an input is padded first
  (:func:`same_pads`).
- :class:`BatchNorm` is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
  as the reference configures it: statistics in f32, the variance
  E[x²] − E[x]² clipped at 0, the running variance the BIASED batch
  variance (torch's ``BatchNorm2d`` keeps the unbiased one, so the module
  keeps its own buffers ``mean`` and ``var``), ``ra = 0.9·ra + 0.1·batch``.
  Given a ``group`` (the mesh's data group), the statistics are the
  global batch's, as GSPMD makes them for the reference: one all-reduce
  of [Σx, Σx², n] a layer forward, one of the sums' cotangents backward.
  XLA computes it with no Pallas kernel; on the card it runs PyTorch's
  fused batch-norm kernels (:func:`_fused_forward`), on the CPU plain f32
  ops (:func:`_plain_forward`), which ``chip_smoke.py`` holds the fused
  ones against.

Module names are flax's (``stem_conv``, ``stem_bn``, ``BasicBlock_0``,
``Conv_0``, ``BatchNorm_2``, ``shortcut``, ``shortcut_bn``, ``head``), so
:mod:`dtf_tpu_torch.convert` carries the variables across.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from dtf_tpu_torch.convert import is_kernel
from dtf_tpu_torch.core.comms import TpDense
from dtf_tpu_torch.core.train import LossAux

#: flax ``momentum`` (the running average keeps this share of itself)
MOMENTUM = 0.9
EPSILON = 1e-5


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of a length-``n`` dim for a window ``k`` at
    stride ``s``: (before, after), the odd one after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _layout(x: torch.Tensor):
    """The memory format the convolutions take: channels-last on the
    card, contiguous NCHW elsewhere (module docstring)."""
    return torch.channels_last if x.is_cuda else torch.contiguous_format


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """``x`` [N, C, H, W] and the symmetric padding left for the op: the
    padding itself when SAME is symmetric, else ``x`` padded (a copy) and
    0."""
    (th, bh), (lw, rw) = (same_pads(x.shape[2], k, s),
                          same_pads(x.shape[3], k, s))
    if th == bh and lw == rw:
        return x, (th, lw)
    x = F.pad(x, (lw, rw, th, bh), value=value)
    return x.contiguous(memory_format=_layout(x)), (0, 0)


class Conv(nn.Module):
    """A bias-free k×k convolution at stride ``stride`` with SAME padding;
    ``weight`` [out, in, k, k] f32, the product at ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, k, k,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = _pad_same(x, self.k, self.stride)
        w = self.weight.to(self.dtype, memory_format=_layout(x))
        return F.conv2d(x, w, stride=self.stride, padding=pad)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _batch_moments(stats, c, group, eps):
    """[Σx (C), Σx² (C), n] of this rank → (mean, var, live, inv, count)
    of the group's batch: var = E[x²] − E[x]² clipped at 0 (``live``
    where it was not), inv = (var + ε)^−½."""
    _all_reduce(stats, group)
    count = stats[2 * c]
    mean = stats[:c] / count
    var = stats[c:2 * c] / count - mean * mean
    live = var > 0                        # jnp.maximum(0, var)'s side
    var = torch.where(live, var, 0.0)
    return mean, var, live, torch.rsqrt(var + eps), count


def _plain_forward(x, scale, bias, eps, group):
    """Plain f32 ops: (y, mean, var, saved for the backward)."""
    dims, c = (0, 2, 3), x.shape[1]
    xf = x.float()
    mean, var, live, inv, count = _batch_moments(torch.cat(
        [xf.sum(dims), (xf * xf).sum(dims),
         xf.new_full((1,), x.numel() // c)]), c, group, eps)
    mul = inv * scale
    y = ((xf - mean[:, None, None]) * mul[:, None, None]
         + bias[:, None, None]).to(x.dtype)
    return y, mean, var, (x, mean, inv, scale, live, count)


def _plain_backward(gy, saved, group):
    """(dx, dscale, dbias) of y = (x − μ)·inv·γ + β with μ = S1/n,
    var = S2/n − μ² (clipped), inv = (var + ε)^−½ and S1, S2 the sums
    over the group; the sums' cotangents summed over the group."""
    x, mean, inv, scale, live, count = saved
    dims = (0, 2, 3)
    gyf, xf = gy.float(), x.float()
    sum_gy = gyf.sum(dims)
    sum_gy_xc = (gyf * (xf - mean[:, None, None])).sum(dims)
    d_var = torch.where(live, -0.5 * scale * sum_gy_xc * inv ** 3, 0.0)
    d_mean = -scale * inv * sum_gy - 2.0 * mean * d_var
    d_s1, d_s2 = _all_reduce(torch.cat([d_mean, d_var]) / count,
                             group).chunk(2)
    gx = (gyf * (scale * inv)[:, None, None] + d_s1[:, None, None]
          + 2.0 * xf * d_s2[:, None, None])
    return gx.to(x.dtype), sum_gy_xc * inv, sum_gy


def _fused_forward(x, scale, bias, eps, group):
    """PyTorch's fused CUDA batch-norm kernels (those of its
    SyncBatchNorm): one pass for this rank's mean and variance (Welford,
    f32), turned into [Σx, Σx², n] for the group's sums, one pass for y."""
    c, n = x.shape[1], x.numel() // x.shape[1]
    mean, invstd = torch.batch_norm_stats(x, eps)
    if group is None:
        var = (invstd.pow(-2) - eps).clamp_min(0.0)
        count = mean.new_full((), n)
    else:
        sq = invstd.pow(-2) - eps + mean * mean
        mean, var, _, invstd, count = _batch_moments(torch.cat(
            [mean * n, sq * n, mean.new_full((1,), n)]), c, group, eps)
    y = torch.batch_norm_elemt(x, scale, bias, mean, invstd, eps)
    return y, mean, var, (x, mean, invstd, scale, count)


def _fused_backward(gy, saved, group):
    """The fused kernels' backward: per-channel Σdy and Σdy·(x − μ)
    (summed over the group) with dscale and dbias in one pass, dx in a
    second."""
    x, mean, invstd, scale, count = saved
    if not (gy.is_contiguous(memory_format=torch.channels_last)
            or gy.is_contiguous()):
        gy = gy.contiguous()
    sum_dy, sum_dy_xmu, g_scale, g_bias = torch.batch_norm_backward_reduce(
        gy, x, mean, invstd, scale, True, True, True)
    if group is not None:
        sum_dy, sum_dy_xmu = _all_reduce(torch.cat([sum_dy, sum_dy_xmu]),
                                         group).chunk(2)
    gx = torch.batch_norm_backward_elemt(
        gy, x, mean, invstd, scale, sum_dy, sum_dy_xmu,
        count.to(torch.int32).reshape(1))
    return gx, g_scale, g_bias


def _batchnorm_impl(x):
    """(forward, backward) of train-mode BatchNorm for ``x``: the fused
    CUDA kernels on the card, the plain f32 ops elsewhere."""
    if x.is_cuda:
        return _fused_forward, _fused_backward
    return _plain_forward, _plain_backward


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm over (N, H, W) of x [N, C, H, W]: returns
    (y at x's dtype, batch mean, biased batch variance), both f32. Saves
    x and per-channel vectors only. Over a ``group`` the statistics are
    the group's (one all-reduce of [Σx, Σx², n]) and so are the sums'
    cotangents (one all-reduce backward). On the card PyTorch's fused
    batch-norm kernels run (their variance is Welford's, not
    E[x²] − E[x]²: the same value to f32 rounding); elsewhere plain f32
    ops, which hold flax's formula term for term."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        fwd, ctx.bwd = _batchnorm_impl(x)
        y, mean, var, saved = fwd(x, scale, bias, eps, group)
        ctx.save_for_backward(*saved)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        gx, g_scale, g_bias = ctx.bwd(gy, ctx.saved_tensors, ctx.group)
        return gx, g_scale, g_bias, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` as the reference configures it (module
    docstring): ``weight`` (flax's ``scale``) and ``bias`` [C] f32, the
    buffers ``mean`` (0) and ``var`` (1) [C] f32; output at ``dtype``.
    ``zero_init``: the scale starts at 0 (each block's last BatchNorm).
    ``group``: the process group whose global batch the statistics are
    of (None: this process's batch)."""

    def __init__(self, channels: int, *, dtype: torch.dtype = torch.bfloat16,
                 zero_init: bool = False, group=None, device=None):
        super().__init__()
        self.dtype, self.zero_init, self.group = dtype, zero_init, group
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = torch.rsqrt(self.var + EPSILON) * self.weight
            return ((x.float() - self.mean[:, None, None]) * mul[:, None, None]
                    + self.bias[:, None, None]).to(self.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                             EPSILON, self.group)
        with torch.no_grad():
            self.mean.copy_(MOMENTUM * self.mean + (1 - MOMENTUM) * mean)
            self.var.copy_(MOMENTUM * self.var + (1 - MOMENTUM) * var)
        return y


class BasicBlock(nn.Module):
    """Two 3×3 convolutions (ResNet-18/20/34), the stride on the first."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides: int, **kw):
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, 3, strides, **_conv_kw(kw))
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, 3, 1, **_conv_kw(kw))
        self.BatchNorm_1 = BatchNorm(filters, zero_init=True, **kw)
        _shortcut(self, in_ch, filters, strides, kw)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        return F.relu(y + _residual(self, x))


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 → 1×1 (×4), v1.5: the stride on the 3×3."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides: int, **kw):
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, 1, 1, **_conv_kw(kw))
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, 3, strides, **_conv_kw(kw))
        self.BatchNorm_1 = BatchNorm(filters, **kw)
        self.Conv_2 = Conv(filters, filters * 4, 1, 1, **_conv_kw(kw))
        # the residual branch starts as the identity
        self.BatchNorm_2 = BatchNorm(filters * 4, zero_init=True, **kw)
        _shortcut(self, in_ch, filters * 4, strides, kw)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        return F.relu(y + _residual(self, x))


def _conv_kw(kw: dict) -> dict:
    return {"dtype": kw["dtype"], "device": kw["device"]}


def _shortcut(block, in_ch, out_ch, strides, kw):
    """A 1×1 projection and its BatchNorm where the block changes the
    shape (flax compares the shapes; so do the channels and stride)."""
    block.has_shortcut = strides != 1 or in_ch != out_ch
    if block.has_shortcut:
        block.shortcut = Conv(in_ch, out_ch, 1, strides, **_conv_kw(kw))
        block.shortcut_bn = BatchNorm(out_ch, **kw)


def _residual(block, x):
    return block.shortcut_bn(block.shortcut(x)) if block.has_shortcut else x


class ResNet(nn.Module):
    """``stem`` "imagenet": 7×7/2 conv, BatchNorm, ReLU, 3×3/2 max-pool;
    "cifar": 3×3/1 conv, BatchNorm, ReLU. Then ``stage_sizes`` blocks a
    stage at ``num_filters·2^i`` filters (stride 2 on each stage's first
    block but the first stage's), the spatial mean and the f32 head.
    ``group``: every BatchNorm's (module docstring)."""

    def __init__(self, stage_sizes, block, num_classes: int,
                 num_filters: int = 64, stem: str = "imagenet",
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 device=None, group=None):
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"stem={stem!r} must be imagenet | cifar")
        self.stem, self.dtype = stem, dtype
        kw = {"dtype": dtype, "device": device, "group": group}
        k, s = (7, 2) if stem == "imagenet" else (3, 1)
        self.stem_conv = Conv(in_channels, num_filters, k, s,
                              **_conv_kw(kw))
        self.stem_bn = BatchNorm(num_filters, **kw)
        width, idx = num_filters, 0
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                filters = num_filters * 2 ** i
                setattr(self, f"{block.__name__}_{idx}", block(
                    width, filters, 2 if (i > 0 and j == 0) else 1, **kw))
                width, idx = filters * block.expansion, idx + 1
        self.n_blocks, self.block_name = idx, block.__name__
        self.head = TpDense(width, num_classes, parallel="column",
                            dtype=torch.float32, device=device)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image [N, H, W, C] (f32) → logits [N, num_classes] f32."""
        x = image.permute(0, 3, 1, 2).to(self.dtype)
        x = x.contiguous(memory_format=_layout(x))      # no copy on the card
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        if self.stem == "imagenet":
            x, pad = _pad_same(x, 3, 2, value=-math.inf)
            x = F.max_pool2d(x, 3, 2, padding=pad)
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x)
        return self.head(x.mean(dim=(2, 3)))


def resnet20(num_classes: int = 10, dtype=torch.bfloat16, **kw) -> ResNet:
    """CIFAR ResNet-20: 3 stages × 3 basic blocks, 16 base filters."""
    return ResNet((3, 3, 3), BasicBlock, num_classes, num_filters=16,
                  stem="cifar", dtype=dtype, **kw)


def resnet50(num_classes: int = 1000, dtype=torch.bfloat16, **kw) -> ResNet:
    """ImageNet ResNet-50 v1.5."""
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_classes, num_filters=64,
                  stem="imagenet", dtype=dtype, **kw)


def _ce_and_accuracy(logits, labels):
    labels = labels.long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.detach().argmax(-1) == labels).float().mean()
    return loss, acc


def make_loss(model: ResNet, *, weight_decay: float = 0.0):
    """``loss_fn(params, batch, rng) -> (loss, LossAux)`` over batch =
    {"image" [N, H, W, C], "label" [N]}: the mean softmax CE plus
    ``weight_decay·½·Σ‖k‖²`` over every kernel (the convolutions' and the
    head's; not BatchNorm's scale or bias, not the biases), the metric
    ``accuracy``. The model runs in train mode, so its BatchNorm
    statistics move (``TrainState.extra``). ``rng`` is unused."""
    kernels = [n for n, p in model.named_parameters()
               if is_kernel(n, p.ndim)]

    def loss_fn(params, batch, rng):
        logits = model(batch["image"])
        loss, acc = _ce_and_accuracy(logits, batch["label"])
        if weight_decay:
            l2 = torch.stack([params[n].square().sum() for n in kernels])
            loss = loss + weight_decay * 0.5 * l2.sum()
        return loss, LossAux(metrics={"accuracy": acc})

    return loss_fn


def make_eval(model: ResNet):
    """``eval_fn(params, batch) -> {"eval_loss", "eval_accuracy"}``; run
    it in eval mode (``make_eval_step(model=)``): the running
    statistics."""

    def eval_fn(params, batch):
        loss, acc = _ce_and_accuracy(model(batch["image"]), batch["label"])
        return {"eval_loss": loss, "eval_accuracy": acc}

    return eval_fn
