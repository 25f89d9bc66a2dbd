"""ViT-B/16 with named activation taps (port of
``visreps_tpu/models/vit.py:21-91``), torchvision vit_b_16-equivalent.

Pre-LN encoder: LN → multi-head self-attention → residual, LN → MLP
(exact GELU) → residual, LayerNorm eps 1e-6; a learned class token in
front of the 14 × 14 patch tokens, learned position embeddings, a final
LN and the head on the class token. Attention is Flax's
``MultiHeadDotProductAttention`` written out in plain torch — separate
query/key/value/out projections, the query scaled by head_dim^-½, an
f32 matmul + softmax (the JAX package runs it as XLA, not a Pallas
kernel). Taps: ``patch_embed`` (the conv output, NCHW, flattened in
(H, W, C) order like every conv tap), ``block{1..12}`` ((B, 197, 768)
token-major) and ``head`` (the logits). Modules are named after the Flax
ones (``encoder_layer_{i}.self_attention.query``, ``mlp_0``, ``ln`` …).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from visreps_tpu_torch.models.layers import init_like_flax


class SelfAttention(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, nn.Linear(hidden_dim, hidden_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h = x.shape
        heads = self.num_heads

        def split(proj):  # (B, T, H) → (B, heads, T, head_dim)
            return proj(x).view(b, t, heads, h // heads).transpose(1, 2)

        q, k, v = split(self.query), split(self.key), split(self.value)
        weights = torch.softmax((q * (h // heads) ** -0.5) @ k.transpose(-2, -1), dim=-1)
        return self.out((weights @ v).transpose(1, 2).reshape(b, t, h))


class EncoderBlock(nn.Module):
    def __init__(self, hidden_dim: int = 768, num_heads: int = 12, mlp_dim: int = 3072):
        super().__init__()
        self.ln_1 = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.self_attention = SelfAttention(hidden_dim, num_heads)
        self.ln_2 = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.mlp_0 = nn.Linear(hidden_dim, mlp_dim)
        self.mlp_3 = nn.Linear(mlp_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attention(self.ln_1(x))
        return x + self.mlp_3(F.gelu(self.mlp_0(self.ln_2(x))))


class ViTBase(nn.Module):
    """ViT-B/16: 224 × 224 inputs → 197 tokens × 768 dims (other sizes
    through ``image_size``, ``patch_size`` and the widths)."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16, hidden_dim: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 image_size: int = 224):
        super().__init__()
        self.num_classes, self.patch_size, self.hidden_dim = num_classes, patch_size, hidden_dim
        self.num_layers, self.num_heads, self.mlp_dim = num_layers, num_heads, mlp_dim
        self.conv_proj = nn.Conv2d(3, hidden_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        n_tokens = (image_size // patch_size) ** 2 + 1
        self.pos_embedding = nn.Parameter(torch.zeros(1, n_tokens, hidden_dim))
        for i in range(num_layers):
            self.add_module(f"encoder_layer_{i}", EncoderBlock(hidden_dim, num_heads, mlp_dim))
        self.ln = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.head = nn.Linear(hidden_dim, num_classes)
        self.TAPS = {"patch_embed": ("patch_embed",),
                     **{f"block{i}": (f"block{i}",) for i in range(1, num_layers + 1)},
                     "head": ("head",)}

    def spec(self) -> dict:
        """The JAX package's ``module_spec`` of a ViTBase."""
        return {"class": "ViTBase", "num_classes": self.num_classes,
                "patch_size": self.patch_size, "hidden_dim": self.hidden_dim,
                "num_layers": self.num_layers, "num_heads": self.num_heads,
                "mlp_dim": self.mlp_dim}

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Flax's default init, xavier-uniform head, a zero class token
        and N(0, 0.02) position embeddings."""
        init_like_flax(self, gen, heads=("head",))
        nn.init.zeros_(self.cls_token)
        self.pos_embedding.normal_(0.0, 0.02, generator=gen)

    def forward(self, x: torch.Tensor, capture: Sequence[str] = (),
                generator: torch.Generator | None = None):
        """x: (B, 3, H, W) → (logits, {tap: tensor})."""
        capture = frozenset(capture)
        taps: dict[str, torch.Tensor] = {}

        def tap(name, value):
            if name in capture:
                taps[name] = value

        b = x.shape[0]
        x = self.conv_proj(x)
        tap("patch_embed", x)
        x = x.flatten(2).transpose(1, 2)  # (B, patches, hidden), row-major patches
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1) + self.pos_embedding
        for i in range(self.num_layers):
            x = getattr(self, f"encoder_layer_{i}")(x)
            tap(f"block{i + 1}", x)
        x = self.head(self.ln(x)[:, 0])
        tap("head", x)
        return x, taps
