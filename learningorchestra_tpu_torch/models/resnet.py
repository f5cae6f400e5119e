"""ResNet-50 of the port (bottleneck v1.5: the stride in the 3x3), the
``resnet50`` layer kind of :mod:`.sequential_module`, as
:mod:`learningorchestra_tpu.models.resnet` builds it: a 7x7 stride-2
stem (pad 3), batch norm (momentum 0.9, flax's epsilon 1e-5), a 3x3
stride-2 ``"SAME"`` max pool (on 112 that pads (0, 1), with -inf), four
bottleneck stages (3/4/6/3 by default), the spatial mean and a dense
``head``. Channels-last throughout; the module names are flax's
(``stem_conv``, ``stem_bn``, ``stage{s}_block{b}`` with ``conv1..3``,
``bn1..3``, ``proj``, ``bn_proj``, and ``head``), so a flax tree maps
onto it by name.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from learningorchestra_tpu_torch.models.sequential_module import (
    BatchNorm, Conv, Dense, _flat_pads, _ncw, _nwc, same_pads)


def _norm(features: int) -> BatchNorm:
    return BatchNorm(features, momentum=0.9, epsilon=1e-5)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, filters: int, sizes: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), project: bool = False):
        super().__init__()
        self.conv1 = Conv(in_ch, filters, (1, 1), (1, 1), "SAME", sizes,
                          use_bias=False)
        self.bn1 = _norm(filters)
        self.conv2 = Conv(filters, filters, (3, 3), strides, "SAME", sizes,
                          use_bias=False)
        self.bn2 = _norm(filters)
        out = self.conv2.out_sizes
        self.conv3 = Conv(filters, filters * 4, (1, 1), (1, 1), "SAME", out,
                          use_bias=False)
        self.bn3 = _norm(filters * 4)
        self.has_proj = project or in_ch != filters * 4
        if self.has_proj:
            self.proj = Conv(in_ch, filters * 4, (1, 1), strides, "SAME",
                             sizes, use_bias=False)
            self.bn_proj = _norm(filters * 4)
        self.out_sizes = out

    def forward(self, x, train: bool = False,
                updates: Optional[Dict[str, torch.Tensor]] = None):
        y = torch.relu(self.bn1(self.conv1(x), train, updates))
        y = torch.relu(self.bn2(self.conv2(y), train, updates))
        y = self.bn3(self.conv3(y), train, updates)
        residual = x
        if self.has_proj:
            residual = self.bn_proj(self.proj(x), train, updates)
        return torch.relu(y + residual)


class ResNet50(nn.Module):
    """``(b, h, w, in_channels)`` -> ``(b, num_classes)`` logits (or the
    pooled ``(b, 2048)`` features without the top)."""

    def __init__(self, num_classes: int = 1000, include_top: bool = True,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 in_channels: int = 3, sizes: Tuple[int, int] = (224, 224)):
        super().__init__()
        self.stem_conv = Conv(in_channels, 64, (7, 7), (2, 2),
                              [(3, 3), (3, 3)], sizes, use_bias=False)
        self.stem_bn = _norm(64)
        hw = self.stem_conv.out_sizes
        self._pool_pads = [same_pads(n, 3, 2) for n in hw]
        hw = tuple(-(-n // 2) for n in hw)
        self.stage_sizes = tuple(int(s) for s in stage_sizes)
        ch, filters = 64, 64
        for stage, blocks in enumerate(self.stage_sizes):
            for block in range(blocks):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                b = Bottleneck(ch, filters, hw, strides, project=block == 0)
                self.add_module(f"stage{stage}_block{block}", b)
                hw, ch = b.out_sizes, filters * 4
            filters *= 2
        self.include_top = include_top
        if include_top:
            self.head = Dense(ch, num_classes)
        self.out_features = num_classes if include_top else ch

    def forward(self, x, train: bool = False,
                updates: Optional[Dict[str, torch.Tensor]] = None):
        x = torch.relu(self.stem_bn(self.stem_conv(x), train, updates))
        xc = F.pad(_ncw(x), _flat_pads(self._pool_pads),
                   value=float("-inf"))
        x = _nwc(F.max_pool2d(xc, 3, 2))
        for stage, blocks in enumerate(self.stage_sizes):
            for block in range(blocks):
                x = getattr(self, f"stage{stage}_block{block}")(
                    x, train, updates)
        x = x.mean(dim=(1, 2))
        if self.include_top:
            x = self.head(x)
        return x
