"""Plain PyTorch reference of the decoder block the port runs for the
dense configurations: parameter layout, seeded weights, forward pass and
loss.

It follows the block as the configuration file states it (RMSNorm with
a ``1 + scale`` gain, rotary embeddings over the whole head, grouped
keys and values, a SiLU-gated MLP, an untied head, cross-entropy with a
z-loss) in float32, written from the equations and not from the port's
code: no kernel, no cache, no sharding hook. ``precision="tf32"`` rounds
both operands of every matrix product to TF32 (10 mantissa bits, round
to nearest), in the forward and in the backward: the control that a
correct comparison has to reject.

Stacked parameters keep the layer axis first (``blocks.attn.wq`` is
``(layers, d_model, heads * head_dim)``), the flat names the wire carries.
"""
from __future__ import annotations

import math
from typing import Any

import torch


def param_specs(cfg: dict[str, Any]) -> dict[str, tuple[tuple[int, ...], str]]:
    """``{flat name: (shape, init)}`` in sorted name order; ``init`` is
    ``"zeros"`` or ``"normal:<scale>"``."""
    L, d, f, v = cfg["num_layers"], cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    hd = cfg["head_dim"]
    qf, kvf = cfg["num_heads"] * hd, cfg["num_kv_heads"] * hd
    scale = cfg["init_scale"]
    w = f"normal:{scale}"
    specs = {
        "embed.embedding": ((v, d), f"normal:{cfg['embedding_init_scale']}"),
        "embed.lm_head": ((d, v), w),
        "embed.final_norm": ((d,), "zeros"),
        "blocks.attn_norm": ((L, d), "zeros"),
        "blocks.attn.wq": ((L, d, qf), w),
        "blocks.attn.wk": ((L, d, kvf), w),
        "blocks.attn.wv": ((L, d, kvf), w),
        "blocks.attn.wo": ((L, qf, d), w),
        "blocks.mlp_norm": ((L, d), "zeros"),
        "blocks.mlp.w_gate": ((L, d, f), w),
        "blocks.mlp.w_up": ((L, d, f), w),
        "blocks.mlp.w_down": ((L, f, d), w),
    }
    return dict(sorted(specs.items()))


def param_count(cfg: dict[str, Any]) -> int:
    return sum(math.prod(shape) for shape, _ in param_specs(cfg).values())


def train_flops_per_step(cfg: dict[str, Any], batch: int, seq: int) -> float:
    """Model FLOPs of one training step: the matrix products of the
    forward pass (2 m n k each) times 3 for the forward and the backward,
    with no recompute. Per token and layer: the q, k, v, o and the three
    MLP projections, the attention scores and the weighted sum over the
    whole ``seq x seq`` square the masked softmax computes; and the head.
    The embedding lookup, norms, softmax and the optimizer are not
    counted."""
    d, f, v, L = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"], cfg["num_layers"]
    hd = cfg["head_dim"]
    qf, kvf = cfg["num_heads"] * hd, cfg["num_kv_heads"] * hd
    tokens = batch * seq
    per_token_layer = 2 * (d * qf + 2 * d * kvf + qf * d + 3 * d * f) + 2 * 2 * seq * qf
    forward = tokens * (L * per_token_layer + 2 * d * v)
    return 3.0 * forward


def make_weights(cfg: dict[str, Any], seed: int, device: Any) -> dict[str, torch.Tensor]:
    """The round-0 global weights from ``seed``: one ``randn`` draw on
    ``device`` for every normal-initialised parameter (in sorted name
    order), scaled in place, zeros for the norms. The tensors are views
    of one buffer; the same seed gives the same numbers on the same
    device."""
    specs = param_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = {n: s for n, s in specs.items() if s[1] != "zeros"}
    total = sum(math.prod(shape) for shape, _ in normal.values())
    buf = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out: dict[str, torch.Tensor] = {}
    at = 0
    for name, (shape, init) in specs.items():
        if init == "zeros":
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        out[name] = buf[at:at + n].view(shape).mul_(float(init.split(":")[1]))
        at += n
    return out


# -- TF32 control ---------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with 10 mantissa bits (ties away from
    zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return a @ b
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    raise ValueError(f"unknown precision {precision!r}")


# -- forward ----------------------------------------------------------------

def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    inv = torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)
    return x * inv * (1.0 + gain)


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, s, heads, hd); rotates the pairs (i, i + hd/2) by
    ``pos * theta^(-i / (hd/2))``."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv_freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv_freq
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(x: torch.Tensor, wq, wk, wv, wo, cfg: dict[str, Any],
              precision: str) -> torch.Tensor:
    bsz, s, _ = x.shape
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = matmul(x, wq, precision).view(bsz, s, H, hd)
    k = matmul(x, wk, precision).view(bsz, s, KV, hd)
    v = matmul(x, wv, precision).view(bsz, s, KV, hd)
    q, k = rotary(q, cfg["rope_theta"]), rotary(k, cfg["rope_theta"])
    rep = H // KV
    q = q.transpose(1, 2)                                           # b H s hd
    k = k.transpose(1, 2).repeat_interleave(rep, dim=1)
    v = v.transpose(1, 2).repeat_interleave(rep, dim=1)
    scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = matmul(torch.softmax(scores, dim=-1), v, precision)      # b H s hd
    return matmul(out.transpose(1, 2).reshape(bsz, s, H * hd), wo, precision)


def logits(params: dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict[str, Any],
           precision: str = "fp32") -> torch.Tensor:
    eps = cfg["norm_eps"]
    x = torch.nn.functional.embedding(tokens, params["embed.embedding"])
    layers = {n: params[n].unbind(0) for n in params if n.startswith("blocks.")}
    for i in range(cfg["num_layers"]):
        def p(name):
            return layers[name][i]
        h = rms_norm(x, p("blocks.attn_norm"), eps)
        x = x + attention(h, p("blocks.attn.wq"), p("blocks.attn.wk"), p("blocks.attn.wv"),
                          p("blocks.attn.wo"), cfg, precision)
        h = rms_norm(x, p("blocks.mlp_norm"), eps)
        gate = torch.nn.functional.silu(matmul(h, p("blocks.mlp.w_gate"), precision))
        up = matmul(h, p("blocks.mlp.w_up"), precision)
        x = x + matmul(gate * up, p("blocks.mlp.w_down"), precision)
    x = rms_norm(x, params["embed.final_norm"], eps)
    return matmul(x, params["embed.lm_head"], precision)


def loss(params: dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict[str, Any],
         precision: str = "fp32") -> torch.Tensor:
    """Mean next-token cross-entropy plus ``z_loss * logsumexp^2``."""
    z = logits(params, tokens, cfg, precision)[:, :-1]
    target = tokens[:, 1:]
    lse = torch.logsumexp(z, dim=-1)
    gold = torch.gather(z, -1, target[..., None])[..., 0]
    return (lse - gold + cfg["z_loss"] * lse.square()).mean()
