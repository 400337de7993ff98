"""Mixture-of-Experts layer: top-k router with capacity-based einsum
dispatch and a load-balance auxiliary loss.

Mirror of ``src/repro/models/moe.py``. Token groups are sequence chunks of
``GROUP_T`` tokens; capacity per group is
``ceil(GROUP_T * k / E * capacity_factor)``. Tokens over capacity are
dropped (their residual passes through): the Switch/GShard formulation.
Decode calls :func:`moe_forward` on one token, which gives one group of
one token and capacity ``ceil(k / E * capacity_factor)``, as the
reference does.

Ties: ``jax.lax.top_k`` returns the lower index first, so the iterative
top-1 is ``torch.argmax`` (the first maximum) and the top-k of the aux
loss a stable descending sort; ``torch.topk`` does not specify its tie
order.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import base as B
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef

#: tokens per routing group (the reference's value; capacity and the
#: (T, E, C) dispatch tensor scale linearly with it)
GROUP_T = 256


def moe_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDef((d, e), (B.EMBED, B.EXPERT)),
        "w_gate": ParamDef((e, d, f), (B.EXPERT, B.EMBED, B.MLP)),
        "w_up": ParamDef((e, d, f), (B.EXPERT, B.EMBED, B.MLP)),
        "w_down": ParamDef((e, f, d), (B.EXPERT, B.MLP, B.EMBED)),
    }


def _dispatch_tensors(gates: torch.Tensor, k: int, capacity: int) -> torch.Tensor:
    """gates: (G, T, E) softmax probs -> combine (G, T, E, C).

    Iterative top-k: slot j picks the best remaining expert per token (the
    first on ties); positions within an expert's buffer come from a
    cumulative count over the tokens, carried across slots; a position
    at or past ``capacity`` is dropped."""
    G, T, E = gates.shape
    remaining = gates
    combine = torch.zeros((G, T, E, capacity), dtype=gates.dtype, device=gates.device)
    fill = torch.zeros((G, E), dtype=torch.int32, device=gates.device)
    slots = torch.arange(capacity, device=gates.device)
    for _ in range(k):
        idx_j = torch.argmax(remaining, dim=-1)                        # (G,T)
        gate_j = torch.gather(remaining, -1, idx_j[..., None])[..., 0]
        onehot = F.one_hot(idx_j, E).to(torch.int32)                    # (G,T,E)
        pos_in_expert = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot + fill[:, None, :]
        pos = torch.sum(pos_in_expert * onehot, dim=-1)                 # (G,T)
        keep = pos < capacity
        # jax.nn.one_hot: a position past the buffer is an all-zero row
        pos_oh = (pos[..., None] == slots).to(gates.dtype)             # (G,T,C)
        combine = combine + (
            gate_j[..., None, None]
            * onehot.to(gates.dtype)[..., None]
            * pos_oh[:, :, None, :]
            * keep[..., None, None].to(gates.dtype)
        )
        fill = fill + torch.sum(onehot, dim=1, dtype=torch.int32)
        remaining = remaining * (1 - onehot.to(gates.dtype))
    return combine


def load_balance_loss(gates: torch.Tensor, k: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e mean_prob_e * mean_topk_frac_e."""
    G, T, E = gates.shape
    mean_prob = torch.mean(gates, dim=1)                               # (G,E)
    topk_idx = torch.sort(gates, dim=-1, descending=True, stable=True).indices[..., :k]
    frac = torch.mean(
        torch.sum(F.one_hot(topk_idx, E).to(gates.dtype), dim=2), dim=1) / k
    return E * torch.mean(torch.sum(mean_prob * frac, dim=-1))


def moe_forward(x: torch.Tensor, p: dict[str, torch.Tensor],
                cfg: B.ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (batch, seq, d) -> (output, aux_loss). Routing is per
    ``GROUP_T``-token sequence chunk (decode: one group of the live
    tokens); raises ``ValueError`` when ``batch * seq`` is no multiple of
    the group, where the reference asserts."""
    bsz, s, d = x.shape
    k = cfg.experts_per_token
    E = cfg.num_experts
    group_t = min(GROUP_T, s)
    if (bsz * s) % group_t:
        raise ValueError(f"{bsz} x {s} tokens do not split into groups of {group_t}")
    G = bsz * s // group_t
    xg = x.reshape(G, group_t, d)
    capacity = int(math.ceil(group_t * k / E * cfg.moe_capacity_factor))

    router_logits = xg @ p["router"].to(xg.dtype)
    gates = torch.softmax(router_logits.to(torch.float32), dim=-1)
    combine = _dispatch_tensors(gates, k, capacity).to(x.dtype)
    dispatch = (combine > 0).to(x.dtype)

    weights = [p[name].to(x.dtype) for name in ("w_gate", "w_up", "w_down")]
    if L.is_sharded(xg) and group_t > 1 and L.splits(G, B.BATCH):
        y = _experts_on_shards(dispatch, combine, xg, weights)
    else:
        y = _experts(dispatch, combine, xg, *weights)
    aux = load_balance_loss(gates, k)
    return y.reshape(bsz, s, d), aux


def _experts(dispatch: torch.Tensor, combine: torch.Tensor, xg: torch.Tensor,
             w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Dispatch each group's tokens to the experts' buffers, run the gated
    experts and combine: (G,T,E,C) masks, xg (G,T,d) -> (G,T,d)."""
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    g = torch.einsum("gecd,edf->gecf", xe, w_gate)
    u = torch.einsum("gecd,edf->gecf", xe, w_up)
    ye = torch.einsum("gecf,efd->gecd", F.silu(g) * u, w_down)
    return torch.einsum("gtec,gecd->gtd", combine, ye)


def _experts_on_shards(dispatch: torch.Tensor, combine: torch.Tensor, xg: torch.Tensor,
                       weights: list[torch.Tensor]) -> torch.Tensor:
    """:func:`_experts` on a mesh whose batch axes split the groups:
    groups over ``data`` and experts over ``model`` (expert parallelism),
    the tokens replicated over ``model`` and each expert's weights
    gathered whole (FSDP's gather of ``d``). Each device then runs its
    experts on its groups with no communication (DTensor's own lowering
    would flatten the groups and experts, both sharded, which torch 2.11
    refuses); the combine sums over the experts, so the output is a
    partial sum over the mesh dims that split them. Groups that do not
    split, and groups of one token (decode), stay with DTensor's
    lowering, which flattens no two sharded dims there and keeps the
    weights' FSDP shards: gathering whole experts to run one token a
    group would repeat them on every ``data`` rank or move more weight
    than activations."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dispatch, combine = (L.constrain(t, (B.BATCH, None, B.EXPERT, None))
                         for t in (dispatch, combine))
    xg = L.constrain(xg, (B.BATCH, None, None))
    weights = [L.constrain(w, (B.EXPERT, None, None)) for w in weights]
    out = tuple(Shard(0) if p == Shard(0) else Partial() if p == Shard(2) else Replicate()
                for p in combine.placements)
    return L.on_local_shards(_experts, out, dispatch, combine, xg, *weights)
