"""Layer primitives (counterpart of ``tpudet/nn/layers.py``).

Layout is NCHW inside the port. Conventions kept from tpudet:

  * TF "SAME" padding, which is asymmetric: ``total = max((out-1)*stride +
    (k-1)*dilation + 1 - in, 0)``, ``lo = total // 2``, ``hi = total - lo``;
    max-pooling pads with ``-inf``, average pooling with zeros that count in
    the divisor (flax's ``avg_pool``);
  * glorot-uniform conv kernels and zero biases, drawn from a caller's
    ``torch.Generator``;
  * BatchNorm as flax's ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)`` and
    GroupNorm as flax's ``nn.GroupNorm(8, epsilon=1e-5)``, written by hand
    (see :class:`BatchNorm`, :class:`GroupNorm`); their parameter and buffer
    names (``scale``, ``bias``, ``mean``, ``var``) are flax's, so weights
    transfer by name;
  * a compute ``dtype`` per module with flax's casts, done explicitly rather
    than by ``torch.autocast`` (whose per-op choices differ from flax's): a
    conv casts its input and kernel to ``dtype`` and adds the bias in
    ``dtype``; BatchNorm reduces and normalises in float32 and returns its
    input's dtype; parameters stay float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.99


def same_pads(size: int, kernel: int, stride: int = 1, dilation: int = 1):
    """``(lo, hi)`` padding of one spatial axis under TF "SAME"."""
    eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int = 1, dilation: int = 1,
             value: float = 0.0) -> torch.Tensor:
    """Pad NCHW ``x`` so that a VALID window op gives TF "SAME" output."""
    top, bottom = same_pads(x.shape[-2], kernel, stride, dilation)
    left, right = same_pads(x.shape[-1], kernel, stride, dilation)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``tf.layers.max_pooling2d(padding='same')``: pads with ``-inf``."""
    return F.max_pool2d(pad_same(x, window, stride, value=-math.inf), window, stride)


def avg_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax's ``nn.avg_pool(padding="SAME")``: the zero padding counts in the
    divisor (TF's ``average_pooling2d`` leaves it out), so on a 5x5 map of
    ones a 2x2 stride-2 window gives 0.5 on the edge and 0.25 in the corner."""
    return F.avg_pool2d(pad_same(x, window, stride), window, stride)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with TF "SAME" padding, glorot-uniform kernel, zero bias.

    ``dtype`` is the compute type (flax's ``nn.Conv(dtype=...)``): input and
    kernel are cast to it, and the bias is added after the convolution in it.
    The parameters stay float32."""

    def __init__(self, in_ch: int, filters: int, kernel: int, stride: int = 1,
                 dilation: int = 1, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, filters, kernel, stride=stride, dilation=dilation)
        self.compute_dtype = dtype
        with torch.no_grad():
            nn.init.xavier_uniform_(self.weight, generator=generator)
            self.bias.zero_()

    def reset_parameters(self):
        # nn.Conv2d's own init would draw from the global RNG; __init__ above
        # draws from the caller's generator instead
        pass

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt)
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        top, bottom = same_pads(x.shape[-2], k, s, d)
        left, right = same_pads(x.shape[-1], k, s, d)
        if (top, left) != (bottom, right):  # asymmetric: pad by hand
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        y = F.conv2d(x, self.weight.to(dt), None, self.stride, (top, left),
                     self.dilation)
        return y + self.bias.to(dt).view(1, -1, 1, 1)


class SameConvTranspose2d(nn.ConvTranspose2d):
    """flax's ``nn.ConvTranspose(filters, (k, k), strides=(s, s),
    padding="SAME")``: output ``size * stride``, lecun-normal kernel (normal
    truncated at +-2 std, std ``1/sqrt(k*k*in_ch)`` after the cut) drawn from
    the caller's generator, zero bias.

    flax does not flip the kernel (``lax.conv_transpose`` with
    ``transpose_kernel=False``) and torch's ``conv_transpose2d``, the gradient
    of a convolution, does: ``weight`` holds flax's kernel flipped in both
    spatial axes, ``[in, out, k, k]`` (``runtime/transfer.py`` converts).
    ``dtype`` is the compute type, cast as :class:`SameConv2d` does."""

    def __init__(self, in_ch: int, filters: int, kernel: int = 4, stride: int = 2,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        # lax's SAME padding of the stride-dilated input: lo before, hi after;
        # torch pads kernel-1-padding on both sides and output_padding after
        pad_len = kernel + stride - 2
        lo = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
        if pad_len - lo < lo:
            raise ValueError(f"lax's SAME padding of kernel {kernel}, stride {stride} "
                             f"pads less after than before; torch cannot")
        super().__init__(in_ch, filters, kernel, stride=stride, padding=kernel - 1 - lo,
                         output_padding=pad_len - 2 * lo)
        self.compute_dtype = dtype
        with torch.no_grad():
            std = math.sqrt(1.0 / (in_ch * kernel * kernel)) / TRUNC_NORMAL_STD
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            self.bias.zero_()

    def reset_parameters(self):
        # nn.ConvTranspose2d's own init would draw from the global RNG
        pass

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, self.stride,
                               self.padding, self.output_padding)
        return y + self.bias.to(dt).view(1, -1, 1, 1)


class Conv(nn.Module):
    """Conv(+bias) -> optional activation (no norm)."""

    def __init__(self, in_ch: int, filters: int, kernel: int, stride: int = 1,
                 dilation: int = 1, activation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = SameConv2d(in_ch, filters, kernel, stride, dilation, generator,
                               dtype)
        self.activation = activation

    def forward(self, x):
        x = self.conv(x)
        return self.activation(x) if self.activation is not None else x


class BatchNorm(nn.Module):
    """BatchNorm over channels (dim 1) with flax's semantics, epsilon 1e-3.

    Train mode (``module.train()``) normalises with the batch statistics,
    reduced in float32: the mean, and flax's fast biased variance
    ``max(0, E[x^2] - E[x]^2)``, which the output uses too. Each mean is a sum
    times ``1/n``, as XLA computes ``jnp.mean`` (``torch.mean`` divides by
    ``n``, and where a level holds a few values a channel, as at a 1x1 level
    of batch 2, ``E[x^2] - E[x]^2`` cancels and the last bit of the mean
    moves the gradient below it by ~0.3%). The forward pass
    also updates the running statistics, as flax's ``mutable=["batch_stats"]``
    does: ``r = 0.99 r + 0.01 batch`` for mean and var, with no gradient.
    Eval mode normalises with the running statistics. Either way the output is
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, returned in
    the input's dtype.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        x32 = x.float()
        if self.training:
            dims = [0, *range(2, x.dim())]
            inv_n = 1.0 / (x32.numel() // x32.shape[1])
            mean = torch.sum(x32, dims) * inv_n
            var = torch.clamp(torch.sum(x32 * x32, dims) * inv_n - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = (x32 - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class ConvBN(nn.Module):
    """Conv(+bias) -> BatchNorm -> optional activation, in ``dtype``."""

    def __init__(self, in_ch: int, filters: int, kernel: int, stride: int = 1,
                 dilation: int = 1, activation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = SameConv2d(in_ch, filters, kernel, stride, dilation, generator,
                               dtype)
        self.bn = BatchNorm(filters)
        self.activation = activation

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.activation(x) if self.activation is not None else x


class GroupNorm(nn.Module):
    """GroupNorm over NCHW channels with flax's ``nn.GroupNorm(num_groups,
    epsilon=1e-5, dtype=dtype)`` semantics: the channels split into
    ``groups`` contiguous groups, and each (image, group) is normalised by
    the mean and flax's fast biased variance ``max(0, E[x^2] - E[x]^2)``
    over its channels and positions, reduced in float32, each mean a sum
    times ``1/n`` as :class:`BatchNorm` takes it. The output is ``(x - mean)
    * (rsqrt(var + eps) * scale) + bias`` in float32, returned in ``dtype``
    (flax casts to the module's dtype, whatever the input's). No running
    statistics: train and eval mode compute the same."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % groups:
            raise ValueError(f"{groups} groups do not divide {channels} channels")
        self.groups, self.eps, self.compute_dtype = groups, eps, dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        n, c = x.shape[:2]
        xg = x.float().reshape(n, self.groups, -1)
        inv_n = 1.0 / xg.shape[-1]
        mean = torch.sum(xg, -1) * inv_n
        var = torch.clamp(torch.sum(xg * xg, -1) * inv_n - mean * mean, min=0.0)
        # each group's statistics over its channels by broadcasting, not
        # repeat_interleave, whose int form syncs the card with the host
        grouped = (n, self.groups, c // self.groups)
        mean = mean[..., None].expand(grouped).reshape(n, c)
        mul = (torch.rsqrt(var + self.eps)[..., None].expand(grouped).reshape(n, c)
               * self.scale)
        spatial = (1,) * (x.dim() - 2)
        y = ((x.float() - mean.view(n, c, *spatial)) * mul.view(n, c, *spatial)
             + self.bias.view(1, c, *spatial))
        return y.to(self.compute_dtype)


class BNActConv(nn.Module):
    """Pre-activation unit: norm -> activation -> SAME conv(+bias).

    ``norm`` is ``"bn"`` (:class:`BatchNorm`, module ``bn``) or ``"gn"``
    (:class:`GroupNorm` of 8 groups, module ``gn``: FCOS). The conv kernel is
    flax's ``variance_scaling(2.0, "fan_in", "truncated_normal")``, drawn from
    the caller's generator; the bias is 0, or ``bias_init_const`` (the
    class-prediction prior ``-log((1-pi)/pi)``). BatchNorm returns its
    input's dtype and the conv casts to ``dtype`` right after, so a float32
    input (the FPN's top-down sums) gives the same values as flax's
    BatchNorm(dtype=bfloat16) there.
    """

    def __init__(self, in_ch: int, filters: int, kernel: int, stride: int = 1,
                 activation: Optional[Callable] = torch.relu,
                 bias_init_const: Optional[float] = None, norm: str = "bn",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm == "bn":
            self.bn = BatchNorm(in_ch)
        elif norm == "gn":
            self.gn = GroupNorm(in_ch, dtype=dtype)
        else:
            raise ValueError(f"norm must be 'bn' or 'gn', got {norm!r}")
        self.norm = norm
        self.activation = activation
        self.conv = SameConv2d(in_ch, filters, kernel, stride, generator=generator,
                               dtype=dtype)
        he_truncated_normal_(self.conv.weight, generator)
        if bias_init_const is not None:
            with torch.no_grad():
                self.conv.bias.fill_(bias_init_const)

    def forward(self, x):
        x = (self.bn if self.norm == "bn" else self.gn)(x)
        if self.activation is not None:
            x = self.activation(x)
        return self.conv(x)


# the standard deviation of a unit normal truncated to [-2, 2]
TRUNC_NORMAL_STD = 0.87962566103423978


def he_truncated_normal_(weight: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``variance_scaling(2.0, "fan_in", "truncated_normal")`` drawn in
    place into an OIHW conv ``weight`` from the caller's generator: a normal
    truncated at +-2 std, std ``sqrt(2 / fan_in)`` after the cut."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(2.0 / fan_in) / TRUNC_NORMAL_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default kernel init, ``variance_scaling(1.0, "fan_in",
    "truncated_normal")``, drawn in place into an OIHW conv or ``[out, in]``
    dense ``weight`` from the caller's generator: a normal truncated at +-2
    std, std ``sqrt(1 / fan_in)`` after the cut, by its inverse CDF
    (``nn.init.trunc_normal_`` takes ~6 s on one CPU thread for the 49M
    weights of LH-RCNN's RoI head)."""
    std = math.sqrt(1.0 / weight[0].numel()) / TRUNC_NORMAL_STD
    lo = math.erf(-2.0 / math.sqrt(2.0))  # 2 * cdf(-2) - 1
    with torch.no_grad():
        weight.uniform_(lo, -lo, generator=generator).erfinv_()
        return weight.mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``tf.image.resize_bilinear`` with ``align_corners=False`` in TF1's rule,
    which has no half-pixel offset: ``src = dst * (in / out)``, on NCHW ``x``.

    The source positions and weights are float32 and the lerp multiplies the
    gathered values by them, so a bfloat16 input gives a float32 output, as
    in tpudet (bf16 times float32 promotes). Same size returns ``x`` itself.
    ``F.interpolate(align_corners=False)`` is another function (half-pixel).
    """
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    return bilinear_at(x, source_positions(out_h, h / out_h, x.device),
                       source_positions(out_w, w / out_w, x.device))


def source_positions(n: int, step: float, device) -> torch.Tensor:
    """``arange(n) * step`` in float32, the step rounded to float32 first (as
    a weakly typed Python float multiplies a float32 array in JAX)."""
    return torch.arange(n, dtype=torch.float32, device=device) * torch.tensor(
        step, dtype=torch.float32)


def bilinear_at(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of NCHW ``x`` at float32 source rows ``ys`` and
    columns ``xs``: the lerp multiplies the gathered values by float32
    weights, so a bfloat16 input gives a float32 output, as in tpudet."""
    h, w = x.shape[-2:]
    y0 = torch.clamp(torch.floor(ys), 0, h - 1).long()
    x0 = torch.clamp(torch.floor(xs), 0, w - 1).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0.float())[:, None]
    wx = xs - x0.float()
    # index_select, not x[..., idx]: its backward is an index_add, where
    # advanced indexing's sorts the indices first
    rows0, rows1 = x.index_select(-2, y0), x.index_select(-2, y1)
    top = rows0.index_select(-1, x0) * (1 - wx) + rows0.index_select(-1, x1) * wx
    bot = rows1.index_select(-1, x0) * (1 - wx) + rows1.index_select(-1, x1) * wx
    return top * (1 - wy) + bot * wy


class L2NormScale(nn.Module):
    """L2 normalisation over channels (norm clamped at 1e-12) times ONE learned
    scalar ``scale`` of shape ``[1]``.

    As in tpudet, the compute type is the input's: the norm is taken in
    float32, the normalised values are cast back to the input's dtype and then
    multiplied by the scale cast to that dtype."""

    def __init__(self, init: float = 20.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((1,), float(init)))

    def forward(self, x):
        x32 = x.float()
        norm = torch.sqrt(torch.sum(torch.square(x32), dim=1, keepdim=True))
        normed = (x32 / torch.clamp(norm, min=1e-12)).to(x.dtype)
        return normed * self.scale.to(x.dtype)
