"""Shared neural building blocks, dense subset: parameter specs, RMSNorm,
RoPE, GQA attention, the gated MLP, embedding/head and the LM loss.

Mirror of ``src/repro/models/layers.py``. Everything is functional
(params are plain dicts of tensors) and keeps the reference's layout:
weights are ``(d_in, d_out)`` for ``x @ W``, and per-layer parameters
stack on a leading layer axis. Attention is the masked-softmax path of
the reference's ``_sdpa`` in plain PyTorch; the flash-attention kernel
(taken by the reference only under its ``pallas`` backend at
seq % 128 == 0) is not ported yet (ROADMAP B7). Matrix products are
``torch.matmul`` in fp32, as the reference leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.models import base as B


# ---------------------------------------------------------------------------
# parameter specs: one definition -> params (+ logical axis labels)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} disagree")


def _collect(spec: dict[str, Any]) -> dict[str, ParamDef]:
    flat: dict[str, ParamDef] = {}

    def rec(node, path):
        if isinstance(node, ParamDef):
            flat[path] = node
        else:
            for k, v in node.items():
                rec(v, f"{path}/{k}" if path else k)

    rec(spec, "")
    return flat


def _rebuild(spec: dict[str, Any], arrays: dict[str, Any], path: str = "") -> Any:
    if isinstance(spec, ParamDef):
        return arrays[path]
    return {k: _rebuild(v, arrays, f"{path}/{k}" if path else k) for k, v in spec.items()}


def build_params(generator: torch.Generator, spec: dict[str, Any],
                 dtype: torch.dtype, device: Any) -> dict[str, Any]:
    """Initialise every parameter of ``spec`` in sorted path order with the
    reference's initialisers (normal * scale, zeros, ones). The draws come
    from ``generator`` (on ``device``) and do not reproduce ``jax.random``
    bits; parity tests carry the reference's weights across instead."""
    arrays: dict[str, torch.Tensor] = {}
    for path, pd in sorted(_collect(spec).items()):
        if pd.init == "zeros":
            arr = torch.zeros(pd.shape, dtype=dtype, device=device)
        elif pd.init == "ones":
            arr = torch.ones(pd.shape, dtype=dtype, device=device)
        else:
            arr = torch.randn(pd.shape, generator=generator, dtype=torch.float32,
                              device=device)
            arr.mul_(pd.scale)
            arr = arr.to(dtype)
        arrays[path] = arr
    return _rebuild(spec, arrays)


def param_shapes(spec: dict[str, Any]) -> dict[str, tuple[int, ...]]:
    """``{dotted.name: shape}`` of every parameter in ``spec`` — the flat
    state-dict names :func:`repro_torch.utils.trees.flatten_state_dict`
    gives the built params."""
    return {p.replace("/", "."): pd.shape for p, pd in _collect(spec).items()}


def stacked(pd: ParamDef, num: int) -> ParamDef:
    """Prepend a stacked-layer dim."""
    return ParamDef((num,) + pd.shape, (B.LAYER,) + pd.axes, pd.init, pd.scale)


def stack_spec(spec: dict[str, Any], num: int) -> dict[str, Any]:
    if isinstance(spec, ParamDef):
        return stacked(spec, num)
    return {k: stack_spec(v, num) for k, v in spec.items()}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.to(torch.float32))).to(dtype)


def norm_spec(d: int) -> ParamDef:
    return ParamDef((d,), (B.EMBED,), init="zeros")


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin of shape positions.shape + (head_dim//2,)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exponent)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, n, head_dim); cos/sin: (..., S, half) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # add head axis
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    d, qf, kvf = cfg.d_model, cfg.q_feat, cfg.kv_feat
    spec: dict[str, Any] = {
        "wq": ParamDef((d, qf), (B.EMBED, B.Q_FEAT)),
        "wk": ParamDef((d, kvf), (B.EMBED, B.KV_FEAT)),
        "wv": ParamDef((d, kvf), (B.EMBED, B.KV_FEAT)),
        "wo": ParamDef((qf, d), (B.Q_FEAT, B.EMBED)),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamDef((qf,), (B.Q_FEAT,), init="zeros")
        spec["bk"] = ParamDef((kvf,), (B.KV_FEAT,), init="zeros")
        spec["bv"] = ParamDef((kvf,), (B.KV_FEAT,), init="zeros")
    return spec


def _project_qkv(x: torch.Tensor, p: dict[str, torch.Tensor], cfg: B.ModelConfig,
                 positions: torch.Tensor):
    bsz, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(bsz, s, cfg.num_heads, hd)
    k = k.reshape(bsz, s, cfg.num_kv_heads, hd)
    v = v.reshape(bsz, s, cfg.num_kv_heads, hd)
    if cfg.use_rope:
        cos, sin = rope_table(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
          cfg: B.ModelConfig) -> torch.Tensor:
    """q: (b,s,H,hd); k,v: (b,t,KV,hd); mask: (s,t) bool, True = attend."""
    bsz, s, H, hd = q.shape
    KV = cfg.num_kv_heads
    G = H // KV
    qg = q.reshape(bsz, s, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask, scores, torch.tensor(-1e30, dtype=torch.float32,
                                                    device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(bsz, s, H * hd)


def attn_forward(x: torch.Tensor, p: dict[str, torch.Tensor], cfg: B.ModelConfig, *,
                 causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Training attention over a full sequence (masked softmax)."""
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(x, p, cfg, positions)
    i = torch.arange(s, device=x.device)[:, None]
    j = torch.arange(s, device=x.device)[None, :]
    mask = (j <= i) if causal else torch.ones((s, s), dtype=torch.bool, device=x.device)
    if window is not None:
        mask = mask & (i - j < window)
    out = _sdpa(q, k, v, mask, cfg)
    return out @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# MLP, embeddings / head
# ---------------------------------------------------------------------------

def mlp_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), (B.EMBED, B.MLP)),
        "w_up": ParamDef((d, f), (B.EMBED, B.MLP)),
        "w_down": ParamDef((f, d), (B.MLP, B.EMBED)),
    }


def mlp_forward(x: torch.Tensor, p: dict[str, torch.Tensor]) -> torch.Tensor:
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (torch.nn.functional.silu(g) * u) @ p["w_down"].to(x.dtype)


def embed_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    return {
        "embedding": ParamDef((cfg.vocab_size, cfg.d_model), (B.VOCAB, B.EMBED), scale=1.0),
        "lm_head": ParamDef((cfg.d_model, cfg.vocab_size), (B.EMBED, B.VOCAB)),
        "final_norm": norm_spec(cfg.d_model),
    }


def embed_tokens(tokens: torch.Tensor, p: dict[str, torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    # the reference's row gather; F.embedding's backward sums repeated
    # tokens in index order (deterministic), where ``weight[tokens]``
    # backs off to parallel atomic adds on the CPU
    return torch.nn.functional.embedding(tokens, p["embedding"].to(dtype))


def lm_logits(x: torch.Tensor, p: dict[str, torch.Tensor]) -> torch.Tensor:
    x = rms_norm(x, p["final_norm"])
    return x @ p["lm_head"].to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   z_loss: float = 0.0) -> torch.Tensor:
    """Cross-entropy with optional z-loss; labels < 0 are masked."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
