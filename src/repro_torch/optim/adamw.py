"""AdamW with decoupled weight decay and global-norm clipping.

Mirror of ``src/repro/optim/adamw.py``, written out step by step as the
reference does it (b2 = 0.95, the decay inside ``delta``, clipping by the
global norm), not ``torch.optim.AdamW``, whose arithmetic differs. The
port updates parameters, moments and (for the clip) gradients **in
place** — the reference returns new arrays — so a full-width step needs
no second copy of the model or its optimizer state. Params are a nested
or flat dict of fp32 tensors; the moments mirror its structure.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.utils.trees import tree_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _zeros_like_tree(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v, dtype) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=dtype, device=tree.device)


def adamw_init(params: Any, state_dtype: torch.dtype = torch.float32) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=_zeros_like_tree(params, state_dtype),
        v=_zeros_like_tree(params, state_dtype),
    )


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor],
                        max_norm: float) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place so their global L2 norm is at most
    ``max_norm``; returns them and the norm before clipping."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    gnorm = torch.sqrt(total)
    scale = torch.clamp(torch.full_like(gnorm, max_norm) / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


@torch.no_grad()
def adamw_update(
    params: Any,
    grads: Any,
    state: AdamWState,
    lr: float | torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: Optional[float] = 1.0,
) -> tuple[Any, AdamWState, dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``params``, the moments and the step
    count in ``state`` are updated, and both are returned (the same
    objects). ``grads`` has ``params``' structure (or is the list of
    gradients in ``tree_leaves(params)`` order); the clip overwrites it.
    ``lr`` is a Python float or a 0-dim fp32 tensor on the parameters'
    device (a schedule's value), which is used as it is: no copy, no
    host sync."""
    p_leaves = tree_leaves(params)
    g_leaves = list(grads) if isinstance(grads, (list, tuple)) else tree_leaves(grads)
    m_leaves, v_leaves = tree_leaves(state.m), tree_leaves(state.v)
    device = p_leaves[0].device
    if max_grad_norm is not None:
        g_leaves, gnorm = clip_by_global_norm(g_leaves, max_grad_norm)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=device)
    state.step.add_(1)
    step = state.step
    f32 = dict(dtype=torch.float32, device=device)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, **f32), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, **f32), stepf)
    lr_t = lr if isinstance(lr, torch.Tensor) else torch.tensor(lr, **f32)
    for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        g32 = g.to(torch.float32)
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(torch.square(g32) * (1 - b2))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        delta.add_(p.to(torch.float32) * weight_decay)
        p.sub_((lr_t * delta).to(p.dtype))
    return params, state, {"grad_norm": gnorm}
