"""Vision models — port of ``learningorchestra_tpu/models/vision.py``: the
MNIST CNN (BASELINE config 2), ResNet18/50 (config 5), VGG16 and
MobileNet, GroupNorm'd as in the reference.

Inputs are NHWC, as in the JAX API; the modules permute them to NCHW once
and run torch's convolutions there.  Parity with the flax modules:

- SAME padding as flax computes it (:class:`~ops.layers.Conv`): a strided
  or even-kernel SAME conv pads asymmetrically, more at the bottom/right;
  SAME max-pools pad with -inf; MnistCNN's average pools are VALID;
- GroupNorm epsilon 1e-6, groups ``min(32, C)`` for ResNet and
  ``gcd(32, C)`` for VGG and MobileNet;
- MnistCNN flattens NHWC before ``Dense_0``, so its (3136, 128) kernel
  carries unpermuted;
- ResNet's convs have no bias, the other models' do.

Submodules carry the flax tree's names (``Conv_0``, ``GroupNorm_1``,
``_BottleneckBlock_7``, ``stem_s2d``, ``Dense_0``), which is what
``convert.py`` maps by.  Like flax's, the modules are sized by the first
input they see (``build``, at the first ``fit`` or from a loaded state):
the input channels of the first conv, and MnistCNN's ``Dense_0`` from the
flattened size (3136 at 28x28).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from learningorchestra_tpu_torch.ops.layers import (
    Conv,
    Dense,
    GroupNorm,
    max_pool_same,
    remat_block,
)
from learningorchestra_tpu_torch.toolkit.registry import register
from learningorchestra_tpu_torch.train.neural import (
    SizedEstimator,
    SizedModule,
)

_MODULE = __name__


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _channels_of_input(x0) -> dict:
    return {"in_channels": x0.shape[-1] if x0.ndim == 4 else 1}


def _channels_of_tree(params: dict) -> dict:
    return {"in_channels": params["Conv_0"]["kernel"].shape[2]}


def _mnist_image(x):
    # Accept (B, 784) flat or (B, H, W) or (B, H, W, 1).
    if x.ndim == 2:
        return x.reshape(x.shape[0], 28, 28, 1)
    return x[..., None] if x.ndim == 3 else x


class _MnistCNN(SizedModule):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.num_classes = num_classes

    def build(self, flat_features: int) -> None:
        self.Conv_0 = Conv(1, 32, (3, 3))
        self.Conv_1 = Conv(32, 64, (3, 3))
        self.Dense_0 = Dense(int(flat_features), 128)
        self.Dense_1 = Dense(128, self.num_classes)
        self.built = True

    @staticmethod
    def dims_of_input(x0) -> dict:
        _, h, w, _ = _mnist_image(x0).shape
        return {"flat_features": (h // 4) * (w // 4) * 64}

    @staticmethod
    def dims_of_tree(params: dict) -> dict:
        return {"flat_features": params["Dense_0"]["kernel"].shape[0]}

    def forward(self, x):
        self._check_built()
        x = _mnist_image(x)
        x = F.avg_pool2d(torch.relu(self.Conv_0(_nchw(x))), 2)
        x = F.avg_pool2d(torch.relu(self.Conv_1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        return self.Dense_1(torch.relu(self.Dense_0(x)))


class _ResNetBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, filters: int, strides=(1, 1)):
        super().__init__()
        self.Conv_0 = Conv(in_channels, filters, (3, 3), strides,
                           use_bias=False)
        self.GroupNorm_0 = GroupNorm(min(32, filters), filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), use_bias=False)
        self.GroupNorm_1 = GroupNorm(min(32, filters), filters)
        # flax makes the projection where the residual's shape differs.
        self.project = in_channels != filters or tuple(strides) != (1, 1)
        if self.project:
            self.Conv_2 = Conv(in_channels, filters, (1, 1), strides,
                               use_bias=False)
            self.GroupNorm_2 = GroupNorm(min(32, filters), filters)

    def forward(self, x):
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = self.GroupNorm_2(self.Conv_2(x)) if self.project else x
        return torch.relu(y + residual)


class _BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides=(1, 1)):
        super().__init__()
        out = 4 * filters
        self.Conv_0 = Conv(in_channels, filters, (1, 1), use_bias=False)
        self.GroupNorm_0 = GroupNorm(min(32, filters), filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, use_bias=False)
        self.GroupNorm_1 = GroupNorm(min(32, filters), filters)
        self.Conv_2 = Conv(filters, out, (1, 1), use_bias=False)
        self.GroupNorm_2 = GroupNorm(min(32, out), out)
        self.project = in_channels != out or tuple(strides) != (1, 1)
        if self.project:
            self.Conv_3 = Conv(in_channels, out, (1, 1), strides,
                               use_bias=False)
            self.GroupNorm_3 = GroupNorm(min(32, out), out)

    def forward(self, x):
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = torch.relu(self.GroupNorm_1(self.Conv_1(y)))
        y = self.GroupNorm_2(self.Conv_2(y))
        residual = self.GroupNorm_3(self.Conv_3(x)) if self.project else x
        return torch.relu(y + residual)


def space_to_depth(x, block: int = 2):
    """[B, H, W, C] -> [B, H/block, W/block, C*block^2], each spatial
    block folded into channels (odd tails zero-padded)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % block, (-w) % block
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        h, w = h + pad_h, w + pad_w
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, c * block * block)


class _ResNet(SizedModule):
    dims_of_input = staticmethod(_channels_of_input)

    def __init__(self, stage_sizes: Sequence[int], block: type,
                 num_classes: int = 1000, width: int = 64,
                 remat: bool | str = False, s2d_stem: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.block = block
        self.num_classes = num_classes
        self.width = width
        self.remat = remat
        self.s2d_stem = s2d_stem
        remat_block(block, remat)  # reject a bad knob at construction

    def build(self, in_channels: int) -> None:
        in_channels = int(in_channels)
        w = self.width
        if self.s2d_stem:
            self.stem_s2d = Conv(4 * in_channels, w, (4, 4), use_bias=False)
        else:
            self.Conv_0 = Conv(in_channels, w, (7, 7), (2, 2),
                               use_bias=False)
        self.GroupNorm_0 = GroupNorm(min(32, w), w)
        block_cls = remat_block(self.block, self.remat)
        channels, idx = w, 0
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block_i in range(n_blocks):
                strides = (2, 2) if stage > 0 and block_i == 0 else (1, 1)
                filters = w * 2 ** stage
                # Names pinned to flax's auto-names, whatever remat is.
                setattr(self, f"{self.block.__name__}_{idx}",
                        block_cls(channels, filters, strides))
                channels = filters * self.block.expansion
                idx += 1
        self.n_blocks = idx
        self.Dense_0 = Dense(channels, self.num_classes)
        self.built = True

    @staticmethod
    def dims_of_tree(params: dict) -> dict:
        if "stem_s2d" in params:
            return {"in_channels": params["stem_s2d"]["kernel"].shape[2]
                    // 4}
        return _channels_of_tree(params)

    def forward(self, x):
        self._check_built()
        if x.dim() == 3:
            x = x[..., None]
        if self.s2d_stem:
            x = self.stem_s2d(_nchw(space_to_depth(x, 2)))
        else:
            x = self.Conv_0(_nchw(x))
        x = max_pool_same(torch.relu(self.GroupNorm_0(x)), 3, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block.__name__}_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))  # global average pool


@register(_MODULE)
class MnistCNN(SizedEstimator):
    def __init__(
        self,
        num_classes: int = 10,
        learning_rate: float = 1e-3,
        seed: int = 0,
        device="cuda",
    ):
        self.num_classes = num_classes
        super().__init__(
            _MnistCNN(num_classes=num_classes),
            loss="softmax_ce",
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )


@register(_MODULE)
class ResNet18(SizedEstimator):
    def __init__(
        self,
        num_classes: int = 1000,
        learning_rate: float = 1e-3,
        seed: int = 0,
        remat: bool | str = False,
        s2d_stem: bool = False,
        device="cuda",
    ):
        self.num_classes = num_classes
        self.remat = remat
        self.s2d_stem = s2d_stem
        super().__init__(
            _ResNet(stage_sizes=(2, 2, 2, 2), block=_ResNetBlock,
                    num_classes=num_classes, remat=remat,
                    s2d_stem=s2d_stem),
            loss="softmax_ce",
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )


@register(_MODULE)
class ResNet50(SizedEstimator):
    def __init__(
        self,
        num_classes: int = 1000,
        learning_rate: float = 1e-3,
        seed: int = 0,
        remat: bool | str = False,
        s2d_stem: bool = False,
        device="cuda",
    ):
        self.num_classes = num_classes
        self.remat = remat
        self.s2d_stem = s2d_stem
        super().__init__(
            _ResNet(stage_sizes=(3, 4, 6, 3), block=_BottleneckBlock,
                    num_classes=num_classes, remat=remat,
                    s2d_stem=s2d_stem),
            loss="softmax_ce",
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )


# -- VGG ---------------------------------------------------------------------


class _VGG(SizedModule):
    """VGG-16 layout (Simonyan & Zisserman config D), GroupNorm'd."""

    dims_of_input = staticmethod(_channels_of_input)
    dims_of_tree = staticmethod(_channels_of_tree)

    def __init__(self, num_classes: int,
                 stage_sizes: Sequence[int] = (2, 2, 3, 3, 3),
                 widths: Sequence[int] = (64, 128, 256, 512, 512)):
        super().__init__()
        self.num_classes = num_classes
        self.stage_sizes = tuple(stage_sizes)
        self.widths = tuple(widths)

    def build(self, in_channels: int) -> None:
        channels, i = int(in_channels), 0
        for blocks, width in zip(self.stage_sizes, self.widths):
            for _ in range(blocks):
                setattr(self, f"Conv_{i}", Conv(channels, width, (3, 3)))
                setattr(self, f"GroupNorm_{i}",
                        GroupNorm(math.gcd(32, width), width))
                channels, i = width, i + 1
        self.Dense_0 = Dense(channels, 1024)
        self.Dense_1 = Dense(1024, self.num_classes)
        self.built = True

    def forward(self, x):
        self._check_built()
        if x.dim() == 3:
            x = x[..., None]
        x, i = _nchw(x), 0
        for blocks in self.stage_sizes:
            for _ in range(blocks):
                x = getattr(self, f"GroupNorm_{i}")(
                    getattr(self, f"Conv_{i}")(x))
                x, i = torch.relu(x), i + 1
            # SAME pooling: 28x28 inputs must not shrink to nothing.
            x = max_pool_same(x, 2, 2)
        x = torch.relu(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(x)


@register(_MODULE)
class VGG16(SizedEstimator):
    def __init__(
        self,
        num_classes: int = 1000,
        learning_rate: float = 1e-3,
        seed: int = 0,
        device="cuda",
    ):
        self.num_classes = num_classes
        super().__init__(
            _VGG(num_classes=num_classes),
            loss="softmax_ce",
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )


# -- MobileNet ---------------------------------------------------------------


class _DepthwiseSeparable(nn.Module):
    """Depthwise (groups = C) + pointwise conv pair."""

    def __init__(self, channels: int, filters: int, strides=(1, 1)):
        super().__init__()
        self.Conv_0 = Conv(channels, channels, (3, 3), strides,
                           groups=channels)
        # gcd: the group count must divide the channel count.
        self.GroupNorm_0 = GroupNorm(math.gcd(32, channels), channels)
        self.Conv_1 = Conv(channels, filters, (1, 1))
        self.GroupNorm_1 = GroupNorm(math.gcd(32, filters), filters)

    def forward(self, x):
        x = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        return torch.relu(self.GroupNorm_1(self.Conv_1(x)))


class _MobileNet(SizedModule):
    """MobileNetV1 layout — depthwise-separable stacks."""

    dims_of_input = staticmethod(_channels_of_input)
    dims_of_tree = staticmethod(_channels_of_tree)

    def __init__(self, num_classes: int, width_multiplier: float = 1.0):
        super().__init__()
        self.num_classes = num_classes
        self.width_multiplier = width_multiplier

    def _w(self, c: int) -> int:
        return max(8, int(c * self.width_multiplier))

    def build(self, in_channels: int) -> None:
        w = self._w
        self.Conv_0 = Conv(int(in_channels), w(32), (3, 3), (2, 2))
        self.GroupNorm_0 = GroupNorm(math.gcd(32, w(32)), w(32))
        plan = [
            (w(64), (1, 1)), (w(128), (2, 2)), (w(128), (1, 1)),
            (w(256), (2, 2)), (w(256), (1, 1)), (w(512), (2, 2)),
            *([(w(512), (1, 1))] * 5),
            (w(1024), (2, 2)), (w(1024), (1, 1)),
        ]
        channels = w(32)
        for i, (filters, strides) in enumerate(plan):
            setattr(self, f"_DepthwiseSeparable_{i}",
                    _DepthwiseSeparable(channels, filters, strides))
            channels = filters
        self.n_blocks = len(plan)
        self.Dense_0 = Dense(channels, self.num_classes)
        self.built = True

    def forward(self, x):
        self._check_built()
        if x.dim() == 3:
            x = x[..., None]
        x = torch.relu(self.GroupNorm_0(self.Conv_0(_nchw(x))))
        for i in range(self.n_blocks):
            x = getattr(self, f"_DepthwiseSeparable_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


@register(_MODULE)
class MobileNet(SizedEstimator):
    def __init__(
        self,
        num_classes: int = 1000,
        width_multiplier: float = 1.0,
        learning_rate: float = 1e-3,
        seed: int = 0,
        device="cuda",
    ):
        self.num_classes = num_classes
        self.width_multiplier = width_multiplier
        super().__init__(
            _MobileNet(num_classes=num_classes,
                       width_multiplier=width_multiplier),
            loss="softmax_ce",
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )
