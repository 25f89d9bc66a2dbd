"""CLIP ViT-L/14 vision tower and DINOv2-L/14 (port of
``visreps_tpu/models/hf_vit.py``), with the tap contract of every other
family: ``forward(x, capture=())`` returns ``(out, {tap: tensor})`` for
the taps ``patch_embed`` (the patch conv's NCHW output, flattened in
(H, W, C) order by the extractor), ``block1..N`` ((B, tokens, hidden),
token-major), ``pooled`` and ``embed``.

  * CLIP: patch conv (no bias) → [CLS | patches] + learned positions →
    pre-LN → N × (LN → MHSA → residual, LN → QuickGELU MLP → residual) →
    post-LN on CLS (``pooled``) → optional projection without bias
    (``embed``). LN eps 1e-5.
  * DINOv2: patch conv (bias) → [CLS | patches] + positions → N × (LN →
    MHSA → LayerScale → residual, LN → exact-GELU MLP → LayerScale →
    residual) → final LN; ``pooled`` = ``embed`` = the CLS row. LN eps 1e-6.

Attention is written out in plain torch as the JAX package writes it
(XLA there, no Pallas kernel): separate q/k/v/out projections, q·kᵀ
divided by √head_dim after the product, f32 softmax. Parameters are
named after the Flax ones (``patch``, ``class_embedding`` /
``cls_token``, ``pos_embedding``, ``pre_ln``, ``block{i}.attn.{q,k,v,out}``,
``ln1``/``ln2`` or ``norm1``/``norm2``, ``fc1``, ``fc2``, ``ls1``, ``ls2``,
``post_ln`` / ``final_ln``, ``projection``), so ``models/convert.py``
carries JAX trees across name for name.

Weights (``load_tower``), in the JAX package's order: the converted-tower
pickle the JAX package writes (``VISREPS_TOWER_CACHE``; read with
``pickle``, no JAX), then a HuggingFace snapshot on disk (a local
directory, or the hub cache) read from its ``config.json`` and weights
file without ``transformers``; otherwise ``pretrained=True`` raises and
``pretrained=False`` gives the seeded init.
"""
from __future__ import annotations

import json
import math
import os
import pickle
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.layers import init_like_flax

CLIP_HF_ID = "openai/clip-vit-large-patch14"
DINOV2_HF_ID = "facebook/dinov2-large"
# HF config defaults for what the weights do not show (a saved config.json
# leaves out values equal to its class's defaults).
_HF_DEFAULTS = {"clip": {"num_attention_heads": 12, "layer_norm_eps": 1e-5},
                "dinov2": {"num_attention_heads": 12, "layer_norm_eps": 1e-6}}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MHSA(nn.Module):
    """Multi-head self-attention with separate q/k/v/out projections."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("q", "k", "v", "out"):
            self.add_module(name, nn.Linear(hidden, hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h = x.shape
        d = h // self.heads

        def split(proj):  # (B, T, H) → (B, heads, T, d)
            return proj(x).view(b, t, self.heads, d).transpose(1, 2)

        q, k, v = split(self.q), split(self.k), split(self.v)
        attn = torch.softmax((q @ k.transpose(-2, -1)) / math.sqrt(d), dim=-1)
        return self.out((attn @ v).transpose(1, 2).reshape(b, t, h))


class CLIPBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, eps: float = 1e-5):
        super().__init__()
        self.ln1 = nn.LayerNorm(hidden, eps=eps)
        self.attn = MHSA(hidden, heads)
        self.ln2 = nn.LayerNorm(hidden, eps=eps)
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class DINOv2Block(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, eps: float = 1e-6):
        super().__init__()
        self.ls1 = nn.Parameter(torch.ones(hidden))
        self.ls2 = nn.Parameter(torch.ones(hidden))
        self.norm1 = nn.LayerNorm(hidden, eps=eps)
        self.attn = MHSA(hidden, heads)
        self.norm2 = nn.LayerNorm(hidden, eps=eps)
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1 * self.attn(self.norm1(x))
        return x + self.ls2 * self.fc2(F.gelu(self.fc1(self.norm2(x))))


def _tower_taps(num_layers: int) -> dict:
    return {"patch_embed": ("patch_embed",),
            **{f"block{i}": (f"block{i}",) for i in range(1, num_layers + 1)},
            "pooled": ("pooled",), "embed": ("embed",)}


class _Tower(nn.Module):
    """What both towers share: the patch conv, the token sequence with its
    class row and positions, the blocks and the tap bookkeeping."""

    CLS = ""  # the class-token parameter's name

    def __init__(self, hidden: int, num_layers: int, heads: int, mlp_dim: int, patch: int,
                 eps: float, image_size: int, conv_bias: bool, block):
        super().__init__()
        self.hidden, self.num_layers, self.heads = hidden, num_layers, heads
        self.mlp_dim, self.patch_size, self.eps = mlp_dim, patch, eps
        self.patch = nn.Conv2d(3, hidden, patch, stride=patch, bias=conv_bias)
        n_tokens = (image_size // patch) ** 2 + 1
        self.pos_embedding = nn.Parameter(torch.zeros(n_tokens, hidden))
        for i in range(1, num_layers + 1):
            self.add_module(f"block{i}", block(hidden, heads, mlp_dim, eps))
        self.TAPS = _tower_taps(num_layers)

    def module_kwargs(self) -> dict:
        """The JAX module's fields (the converted-tower pickle's
        ``module_kwargs``)."""
        return {"hidden": self.hidden, "num_layers": self.num_layers, "heads": self.heads,
                "mlp_dim": self.mlp_dim, "patch": self.patch_size, "eps": self.eps}

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Flax's init families: lecun-normal (truncated) conv and dense
        kernels, zero biases, unit LayerNorm scales and LayerScales, and
        N(0, 0.02) class token and positions."""
        init_like_flax(self, gen, heads=())
        for name, p in self.named_parameters():
            if name.endswith(("ls1", "ls2")):
                nn.init.ones_(p)
        getattr(self, self.CLS).normal_(0.0, 0.02, generator=gen)
        self.pos_embedding.normal_(0.0, 0.02, generator=gen)

    def _tokens(self, x: torch.Tensor, tap) -> torch.Tensor:
        b = x.shape[0]
        x = self.patch(x)
        tap("patch_embed", x)
        x = x.flatten(2).transpose(1, 2)  # (B, patches, hidden), row-major patches
        cls = getattr(self, self.CLS).reshape(1, 1, -1).expand(b, 1, -1)
        return torch.cat([cls, x], dim=1) + self.pos_embedding

    def _blocks(self, x: torch.Tensor, tap) -> torch.Tensor:
        for i in range(1, self.num_layers + 1):
            x = getattr(self, f"block{i}")(x)
            tap(f"block{i}", x)
        return x


def _tapper(capture: Sequence[str]):
    capture = frozenset(capture)
    taps: dict[str, torch.Tensor] = {}

    def tap(name, value):
        if name in capture:
            taps[name] = value

    return tap, taps


class CLIPVisionTower(_Tower):
    """CLIP vision transformer (ViT-L/14 defaults, 768-d projection)."""

    CLS = "class_embedding"

    def __init__(self, hidden: int = 1024, num_layers: int = 24, heads: int = 16,
                 mlp_dim: int = 4096, patch: int = 14, eps: float = 1e-5,
                 projection_dim: int | None = 768, image_size: int = 224):
        super().__init__(hidden, num_layers, heads, mlp_dim, patch, eps, image_size,
                         conv_bias=False, block=CLIPBlock)
        self.class_embedding = nn.Parameter(torch.zeros(hidden))
        self.pre_ln = nn.LayerNorm(hidden, eps=eps)
        self.post_ln = nn.LayerNorm(hidden, eps=eps)
        self.projection_dim = projection_dim
        if projection_dim:
            self.projection = nn.Linear(hidden, projection_dim, bias=False)

    def module_kwargs(self) -> dict:
        return {**super().module_kwargs(), "projection_dim": self.projection_dim}

    def forward(self, x: torch.Tensor, capture: Sequence[str] = ()):
        """x: (B, 3, H, W) → (embedding or pooled CLS, {tap: tensor})."""
        tap, taps = _tapper(capture)
        x = self._blocks(self.pre_ln(self._tokens(x, tap)), tap)
        out = self.post_ln(x[:, 0])
        tap("pooled", out)
        if self.projection_dim:
            out = self.projection(out)
            tap("embed", out)
        return out, taps


class DINOv2Tower(_Tower):
    """DINOv2 backbone (ViT-L/14 defaults)."""

    CLS = "cls_token"

    def __init__(self, hidden: int = 1024, num_layers: int = 24, heads: int = 16,
                 mlp_dim: int = 4096, patch: int = 14, eps: float = 1e-6,
                 image_size: int = 224):
        super().__init__(hidden, num_layers, heads, mlp_dim, patch, eps, image_size,
                         conv_bias=True, block=DINOv2Block)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.final_ln = nn.LayerNorm(hidden, eps=eps)

    def forward(self, x: torch.Tensor, capture: Sequence[str] = ()):
        """x: (B, 3, H, W) → (final-LN CLS row, {tap: tensor})."""
        tap, taps = _tapper(capture)
        x = self.final_ln(self._blocks(self._tokens(x, tap), tap))
        pooled = x[:, 0]
        tap("pooled", pooled)
        tap("embed", pooled)
        return pooled, taps


# ─────────────────── HF weight converters ────────────────────
def _f32(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(t), dtype=torch.float32)


def _copy(state: dict, ours: str, sd: Mapping, theirs: str, bias: bool = True) -> None:
    state[f"{ours}.weight"] = _f32(sd[f"{theirs}.weight"])
    if bias:
        state[f"{ours}.bias"] = _f32(sd[f"{theirs}.bias"])


def _n_layers(sd: Mapping, prefix: str) -> int:
    return len({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})


def convert_clip_vision(sd: Mapping, num_layers: int | None = None) -> dict:
    """HF CLIPVisionModel / CLIPModel state dict → CLIPVisionTower state
    dict (torch layouts on both sides: every entry is a rename)."""
    pfx = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""
    num_layers = num_layers or _n_layers(sd, f"{pfx}encoder.layers.")
    state: dict[str, torch.Tensor] = {
        "patch.weight": _f32(sd[f"{pfx}embeddings.patch_embedding.weight"]),
        "class_embedding": _f32(sd[f"{pfx}embeddings.class_embedding"]).reshape(-1),
        "pos_embedding": _f32(sd[f"{pfx}embeddings.position_embedding.weight"]),
    }
    _copy(state, "pre_ln", sd, f"{pfx}pre_layrnorm")
    for i in range(1, num_layers + 1):
        lp, bp = f"{pfx}encoder.layers.{i - 1}", f"block{i}"
        _copy(state, f"{bp}.ln1", sd, f"{lp}.layer_norm1")
        _copy(state, f"{bp}.ln2", sd, f"{lp}.layer_norm2")
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("out", "out_proj")):
            _copy(state, f"{bp}.attn.{ours}", sd, f"{lp}.self_attn.{theirs}")
        _copy(state, f"{bp}.fc1", sd, f"{lp}.mlp.fc1")
        _copy(state, f"{bp}.fc2", sd, f"{lp}.mlp.fc2")
    _copy(state, "post_ln", sd, f"{pfx}post_layernorm")
    if "visual_projection.weight" in sd:
        _copy(state, "projection", sd, "visual_projection", bias=False)
    return state


def convert_dinov2(sd: Mapping, num_layers: int | None = None) -> dict:
    """HF Dinov2Model state dict → DINOv2Tower state dict."""
    num_layers = num_layers or _n_layers(sd, "encoder.layer.")
    cls = _f32(sd["embeddings.cls_token"])
    state: dict[str, torch.Tensor] = {
        "cls_token": cls,
        "pos_embedding": _f32(sd["embeddings.position_embeddings"]).reshape(-1, cls.shape[-1]),
    }
    _copy(state, "patch", sd, "embeddings.patch_embeddings.projection")
    for i in range(1, num_layers + 1):
        lp, bp = f"encoder.layer.{i - 1}", f"block{i}"
        _copy(state, f"{bp}.norm1", sd, f"{lp}.norm1")
        _copy(state, f"{bp}.norm2", sd, f"{lp}.norm2")
        for ours, theirs in (("q", "attention.attention.query"),
                             ("k", "attention.attention.key"),
                             ("v", "attention.attention.value"),
                             ("out", "attention.output.dense")):
            _copy(state, f"{bp}.attn.{ours}", sd, f"{lp}.{theirs}")
        _copy(state, f"{bp}.fc1", sd, f"{lp}.mlp.fc1")
        _copy(state, f"{bp}.fc2", sd, f"{lp}.mlp.fc2")
        state[f"{bp}.ls1"] = _f32(sd[f"{lp}.layer_scale1.lambda1"])
        state[f"{bp}.ls2"] = _f32(sd[f"{lp}.layer_scale2.lambda1"])
    _copy(state, "final_ln", sd, "layernorm")
    return state


def _config_value(config: Mapping, kind: str, key: str):
    return config.get(key, _HF_DEFAULTS[kind][key])


def tower_from_hf_clip(config: Mapping, sd: Mapping) -> CLIPVisionTower:
    """A CLIPVisionModel or CLIPModel's ``config.json`` dict and state
    dict → CLIPVisionTower holding its weights, at the image size its
    position table fits. Widths, depth and patch come from the weights;
    heads and LN eps from the config (HF defaults where it leaves them
    out)."""
    config = config.get("vision_config", config)
    state = convert_clip_vision(sd)
    hidden, _, patch, _ = state["patch.weight"].shape
    proj = state["projection.weight"].shape[0] if "projection.weight" in state else None
    n_tokens = state["pos_embedding"].shape[0]
    tower = CLIPVisionTower(
        hidden=hidden, num_layers=_n_layers(state, "block"),
        heads=_config_value(config, "clip", "num_attention_heads"),
        mlp_dim=state["block1.fc1.weight"].shape[0], patch=patch,
        eps=_config_value(config, "clip", "layer_norm_eps"), projection_dim=proj,
        image_size=int(round(math.sqrt(n_tokens - 1))) * patch)
    tower.load_state_dict(state)
    return tower


def tower_from_hf_dinov2(config: Mapping, sd: Mapping, image_size: int = 224) -> DINOv2Tower:
    """A Dinov2Model's ``config.json`` dict and state dict → DINOv2Tower at
    ``image_size``, its position grid resampled to that size (the MLP
    width is read off the weights: HF sizes it from ``mlp_ratio``)."""
    state = convert_dinov2(sd)
    hidden, _, patch, _ = state["patch.weight"].shape
    state["pos_embedding"] = interpolate_positions(state["pos_embedding"],
                                                   (image_size // patch) ** 2)
    tower = DINOv2Tower(
        hidden=hidden, num_layers=_n_layers(state, "block"),
        heads=_config_value(config, "dinov2", "num_attention_heads"),
        mlp_dim=state["block1.fc1.weight"].shape[0], patch=patch,
        eps=_config_value(config, "dinov2", "layer_norm_eps"), image_size=image_size)
    tower.load_state_dict(state)
    return tower


def interpolate_positions(pos, n_patches: int) -> torch.Tensor:
    """Resample the patch-position grid (T, H) to ``n_patches`` positions,
    the CLS row kept: bicubic with antialiasing, as ``jax.image.resize``
    does it (HF DINOv2 is pretrained at 518 px, a 37 × 37 grid; 224 px
    needs 16 × 16)."""
    pos = torch.as_tensor(pos, dtype=torch.float32)
    if pos.shape[0] - 1 == n_patches:
        return pos
    src = int(round(math.sqrt(pos.shape[0] - 1)))
    dst = int(round(math.sqrt(n_patches)))
    grid = pos[1:].reshape(src, src, -1).permute(2, 0, 1)[None]
    grid = F.interpolate(grid, size=(dst, dst), mode="bicubic", align_corners=False,
                         antialias=True)
    return torch.cat([pos[:1], grid[0].permute(1, 2, 0).reshape(dst * dst, -1)])


# ───────────────────────── loaders ───────────────────────────
def converted_tower_cache_dir() -> str:
    """Directory of converted tower weights (the JAX package's pickles;
    ``VISREPS_TOWER_CACHE`` overrides it)."""
    return os.environ.get("VISREPS_TOWER_CACHE", os.path.expanduser("~/.cache/visreps_towers"))


def _kind(name: str) -> str:
    return "clip" if "clip" in name.lower() else "dinov2"


def _converted_cache_path(kind: str, image_size: int) -> str:
    return os.path.join(converted_tower_cache_dir(), f"{kind}_{image_size}px.pkl")


def _hub_cache_dir() -> Path:
    if os.environ.get("HF_HUB_CACHE") or os.environ.get("HUGGINGFACE_HUB_CACHE"):
        return Path(os.environ.get("HF_HUB_CACHE") or os.environ["HUGGINGFACE_HUB_CACHE"])
    home = os.environ.get("HF_HOME") or os.path.expanduser("~/.cache/huggingface")
    return Path(home) / "hub"


def hf_snapshot_dir(name: str) -> Path | None:
    """The directory holding ``config.json`` and the weights of tower
    ``name``: ``name`` itself when it is a local directory, else the hub
    cache's snapshot of its HF id (the ``-large`` tower when ``name``
    has no ``/``, as in the JAX package), at ``refs/main``. None when
    there is none."""
    if os.path.isdir(name):
        return Path(name)
    hf_id = name if "/" in name else (CLIP_HF_ID if _kind(name) == "clip" else DINOV2_HF_ID)
    repo = _hub_cache_dir() / f"models--{hf_id.replace('/', '--')}"
    ref = repo / "refs" / "main"
    snaps = sorted((repo / "snapshots").glob("*")) if (repo / "snapshots").is_dir() else []
    snap = repo / "snapshots" / ref.read_text().strip() if ref.is_file() else (
        snaps[-1] if snaps else None)
    if snap is None or not (snap / "config.json").is_file() or _weights_file(snap) is None:
        return None
    return snap


def _weights_file(snap: Path) -> Path | None:
    try:
        import safetensors.torch  # noqa: F401

        names = ("model.safetensors", "pytorch_model.bin")
    except ImportError:
        names = ("pytorch_model.bin",)
    return next((snap / n for n in names if (snap / n).is_file()), None)


def read_hf_snapshot(snap: Path) -> tuple[dict, dict]:
    """(config.json as a dict, state dict) of an HF snapshot directory,
    without ``transformers``: ``model.safetensors`` where ``safetensors``
    imports, else ``pytorch_model.bin`` through ``torch.load``."""
    path = _weights_file(snap)
    if path is None:
        raise FileNotFoundError(f"no readable weights file in {snap}")
    if path.suffix == ".safetensors":
        from safetensors.torch import load_file

        sd = load_file(str(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return json.loads((snap / "config.json").read_text()), sd


def converted_tower_available(name: str, image_size: int = 224) -> bool:
    """True iff ``load_tower(pretrained=True)`` finds weights on disk: the
    converted-tower pickle or an HF snapshot."""
    return (os.path.exists(_converted_cache_path(_kind(name), image_size))
            or hf_snapshot_dir(name) is not None)


def _from_converted(payload: dict, kind: str, image_size: int) -> nn.Module:
    from visreps_tpu_torch.models.convert import params_from_jax

    kwargs = dict(payload["module_kwargs"])
    cls = CLIPVisionTower if kind == "clip" else DINOv2Tower
    tower = cls(**kwargs, image_size=image_size)
    tower.load_state_dict(params_from_jax(payload["params"]))
    return tower


def _write_converted(tower: nn.Module, path: str) -> None:
    """The JAX package's pickle of a converted tower (numpy Flax tree and
    module fields), so either package reads it next time."""
    from visreps_tpu_torch.models.convert import params_to_jax

    params, _ = params_to_jax(tower.state_dict())
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"params": params, "module_kwargs": tower.module_kwargs()}, f)
    except OSError:
        pass  # the cache only saves the conversion next time


def load_tower(name: str, pretrained: bool = True, image_size: int = 224,
               device: str | torch.device | None = None) -> nn.Module:
    """``'clip-vit-l14'`` | ``'dinov2-l14'`` (or an HF id or snapshot
    directory; "clip" in the name picks CLIP, anything else DINOv2) → the
    tower in eval mode on ``device`` (CUDA unless ``"cpu"`` is asked for).

    With ``pretrained`` the weights come from the converted-tower pickle,
    else from an HF snapshot on disk (then written to the pickle); with
    neither it raises. ``pretrained=False`` gives the ViT-L/14 tower's
    seeded init (``torch.Generator().manual_seed(0)``, on the CPU).
    """
    device = resolve_device(device)
    kind = _kind(name)
    if not pretrained:
        tower = CLIPVisionTower(image_size=image_size) if kind == "clip" else DINOv2Tower(
            image_size=image_size)
        tower.init_weights(torch.Generator().manual_seed(0))
        return tower.to(device).eval()
    cache_path = _converted_cache_path(kind, image_size)
    if os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            tower = _from_converted(pickle.load(f), kind, image_size)
        rprint(f"  Loaded converted {kind} tower: {cache_path}", style="success")
    else:
        snap = hf_snapshot_dir(name)
        if snap is None:
            raise FileNotFoundError(
                f"No weights for {name!r}: neither {cache_path} nor an HF snapshot on disk "
                "(set VISREPS_TOWER_CACHE or HF_HUB_CACHE)")
        config, sd = read_hf_snapshot(snap)
        tower = (tower_from_hf_clip(config, sd) if kind == "clip"
                 else tower_from_hf_dinov2(config, sd, image_size))
        rprint(f"  Imported HF {kind} tower: {snap}", style="success")
        _write_converted(tower, cache_path)
    return tower.to(device).eval()
