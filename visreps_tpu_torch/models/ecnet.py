"""ECTiedNet, the weight-tied expansion-contraction CNN, with named
activation taps (port of ``visreps_tpu/models/ecnet.py:20-141``).

One ``ECBlock`` (1×1 expand → GroupNorm + SiLU → dilated depthwise 3×3
→ divisive normalisation → 1×1 contract → GroupNorm, layer-scale
residual) runs ``n_iters`` times with the SAME weights and a per-call
dilation. Its depthwise kernel is a parameter of its own (``dw_weight``,
(C, 1, 3, 3)) applied with ``F.conv2d(groups=C, dilation=d,
padding=d)``. Downsampling is a fixed binomial blur at stride 2, after
the stem and after the middle block. GroupNorm eps is Flax's 1e-6
(torch's default is 1e-5).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from visreps_tpu_torch.models.layers import dropout, he_normal_fan_out_, lecun_normal_

ECNET_TAPS = {
    "stem": ("stem",),
    **{f"block{i}": (f"block{i}",) for i in range(1, 9)},
    "fc1": ("fc1_pre", "fc1_post"),
    "fc2": ("fc2_pre", "fc2_post"),
    "head": ("head",),
}


def gn_groups_for(channels: int, max_groups: int = 16) -> int:
    """Largest divisor of channels not exceeding max_groups."""
    for g in range(min(max_groups, channels), 0, -1):
        if channels % g == 0:
            return g
    return 1


def _group_norm(channels: int, max_groups: int) -> nn.GroupNorm:
    return nn.GroupNorm(gn_groups_for(channels, max_groups), channels, eps=1e-6)


def divisive_norm(x: torch.Tensor, eps: float = 1e-3, kernel: int = 3) -> torch.Tensor:
    """Local gain control: y = x / (eps + avg_pool(|x|, k)), zero padding
    counted in the average."""
    denom = F.avg_pool2d(x.abs(), kernel, stride=1, padding=kernel // 2, count_include_pad=True)
    return x / (denom + eps)


def blur_pool(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Anti-aliased downsampling: depthwise [1,2,1]⊗[1,2,1]/16, padding 1."""
    k1 = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
    k2 = torch.outer(k1, k1) / 16.0
    c = x.shape[1]
    return F.conv2d(x, k2.expand(c, 1, 3, 3), stride=stride, padding=1, groups=c)


class ECBlock(nn.Module):
    """Expand → dilated depthwise → contract with a layer-scale residual."""

    def __init__(self, channels: int, expansion: int = 6, max_gn_groups: int = 16,
                 layer_scale_init: float = 1e-3):
        super().__init__()
        cexp = channels * expansion
        self.layer_scale_init = layer_scale_init
        self.conv_expand = nn.Conv2d(channels, cexp, 1, bias=False)
        self.gn1 = _group_norm(cexp, max_gn_groups)
        self.dw_weight = nn.Parameter(torch.empty(cexp, 1, 3, 3))
        self.dw_bias = nn.Parameter(torch.zeros(cexp))
        self.conv_contract = nn.Conv2d(cexp, channels, 1, bias=False)
        self.gn2 = _group_norm(channels, max_gn_groups)
        self.gamma = nn.Parameter(torch.full((1,), layer_scale_init))

    def forward(self, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
        out = F.silu(self.gn1(self.conv_expand(x)))
        out = F.conv2d(out, self.dw_weight, self.dw_bias, padding=dilation, dilation=dilation,
                       groups=out.shape[1])
        out = self.gn2(self.conv_contract(divisive_norm(out)))
        return x + self.gamma * out


class ECTiedNet(nn.Module):
    """Stem → ``n_iters`` calls of one ECBlock (dilation schedule, one
    mid blur pool) → global average → 4096 × 4096 MLP → classifier."""

    TAPS = ECNET_TAPS

    def __init__(self, num_classes: int = 1000, channels: int = 192, expansion: int = 1,
                 n_iters: int = 4, dilations: Sequence[int] = (1, 1, 2, 1, 2, 3),
                 mid_blurpool: bool = True, max_gn_groups: int = 16, dropout: float = 0.3):
        super().__init__()
        self.num_classes, self.channels, self.expansion = num_classes, channels, expansion
        self.n_iters, self.dilations = n_iters, tuple(dilations)
        self.mid_blurpool, self.max_gn_groups, self.dropout = mid_blurpool, max_gn_groups, dropout
        self.stem = nn.Conv2d(3, channels, 7, stride=2, padding=3, bias=False)
        self.stem_gn = _group_norm(channels, max_gn_groups)
        self.block = ECBlock(channels, expansion, max_gn_groups)
        self.fc1 = nn.Linear(channels, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.head = nn.Linear(4096, num_classes)

    def spec(self) -> dict:
        """The JAX package's ``module_spec`` of an ECTiedNet."""
        return {"class": "ECTiedNet", "num_classes": self.num_classes, "channels": self.channels,
                "expansion": self.expansion, "n_iters": self.n_iters,
                "dilations": self.dilations, "mid_blurpool": self.mid_blurpool,
                "max_gn_groups": self.max_gn_groups, "dropout": self.dropout}

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """He-normal fan_out convolutions (the depthwise kernel too), zero
        depthwise bias, layer scale 1e-3, unit GroupNorms, and Flax's
        default (lecun-normal, zero bias) dense layers and head."""
        for conv in (self.stem, self.block.conv_expand, self.block.dw_weight,
                     self.block.conv_contract):
            he_normal_fan_out_(getattr(conv, "weight", conv), gen)
        nn.init.zeros_(self.block.dw_bias)
        self.block.gamma.fill_(self.block.layer_scale_init)
        for gn in (self.stem_gn, self.block.gn1, self.block.gn2):
            gn.reset_parameters()
        for fc in (self.fc1, self.fc2, self.head):
            lecun_normal_(fc.weight, gen)
            nn.init.zeros_(fc.bias)

    def forward(self, x: torch.Tensor, capture: Sequence[str] = (),
                generator: torch.Generator | None = None):
        """x: (B, 3, H, W) → (logits, {tap: tensor}); training-mode
        dropout draws from ``generator``."""
        capture = frozenset(capture)
        taps: dict[str, torch.Tensor] = {}

        def tap(name, value):
            if name in capture:
                taps[name] = value

        x = blur_pool(self.stem_gn(self.stem(x)))
        tap("stem", x)
        for t in range(self.n_iters):
            x = self.block(x, dilation=self.dilations[t])  # the same weights every call
            if self.mid_blurpool and t == self.n_iters // 2 - 1:
                x = blur_pool(x)
            tap(f"block{t + 1}", x)
        x = x.mean(dim=(2, 3))
        for i in (1, 2):
            x = getattr(self, f"fc{i}")(x)
            tap(f"fc{i}_pre", x)
            x = F.relu(x)
            tap(f"fc{i}_post", x)
            if self.training:
                x = dropout(x, self.dropout, generator)
        x = self.head(x)
        tap("head", x)
        return x, taps
