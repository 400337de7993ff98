"""Plain reference of a client's local training: the synthetic token
stream the traffic names, AdamW, and the loop over local steps.

The token stream is the federation's synthetic corpus, restated here
from its definition: a Markov chain over the vocabulary in which each
token has ``branching`` successors drawn from a seeded table; a batch is
keyed by ``round * local_steps + step``, so it is a pure function of the
seed, the client's mode and the key. ``partition`` ``iid`` gives every
client mode 0 of one table; ``dirichlet`` draws each client's mode as
the argmax of a Dirichlet(alpha) sample over ``num_modes`` modes.

AdamW: gradients clipped to a global L2 norm of ``max_grad_norm``, then
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` with the bias
corrections of step ``t``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from fedbench import reference

ADAMW = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "max_grad_norm": 1.0}


def client_modes(traffic: dict[str, Any], seed: int) -> list[tuple[int, int]]:
    """``(num_modes, mode)`` of each client."""
    n = traffic["clients"]
    if traffic["partition"] == "iid":
        return [(1, 0)] * n
    if traffic["partition"] != "dirichlet":
        raise ValueError(f"unknown partition {traffic['partition']!r}")
    modes = traffic.get("num_modes", 4)
    rng = np.random.default_rng(seed)
    return [(modes, int(np.argmax(rng.dirichlet([traffic["alpha"]] * modes))))
            for _ in range(n)]


def tokens_at(vocab: int, seq: int, seed: int, num_modes: int, mode: int,
              batch: int, key: int, branching: int = 4) -> np.ndarray:
    """One keyed batch of the Markov stream: (batch, seq) int64."""
    table = np.random.default_rng(seed).integers(0, vocab, size=(num_modes, vocab, branching))
    succ = table[mode % num_modes]
    rng = np.random.default_rng((seed + 977 * mode + 1, int(key)))
    toks = np.empty((batch, seq), np.int64)
    toks[:, 0] = rng.integers(0, vocab, batch)
    choice = rng.integers(0, branching, (batch, seq))
    for t in range(1, seq):
        toks[:, t] = succ[toks[:, t - 1], choice[:, t]]
    return toks


@torch.no_grad()
def adamw_step(params: list[torch.Tensor], grads: list[torch.Tensor], m: list[torch.Tensor],
               v: list[torch.Tensor], step: int, lr: float) -> None:
    h = ADAMW
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
    clip = min(1.0, h["max_grad_norm"] / max(float(norm), 1e-9))
    bc1 = 1.0 - h["b1"] ** step
    bc2 = 1.0 - h["b2"] ** step
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g * clip
        mi.mul_(h["b1"]).add_(g, alpha=1.0 - h["b1"])
        vi.mul_(h["b2"]).addcmul_(g, g, value=1.0 - h["b2"])
        upd = (mi / bc1) / (torch.sqrt(vi / bc2) + h["eps"]) + h["weight_decay"] * p
        p.sub_(lr * upd)


def train_client(start: dict[str, torch.Tensor], cfg: dict[str, Any],
                 traffic: dict[str, Any], seed: int, mode: tuple[int, int],
                 precision: str = "fp32", rows: int | None = None) -> dict[str, Any]:
    """One client's local steps from the decoded downlink ``start`` (left
    unchanged). Returns the trained parameters, the loss of every step
    and each leaf's gradient norm at step 1. ``rows`` keeps only the
    first rows of every batch (a fault the check must catch)."""
    names = sorted(start)
    params = {n: start[n].detach().clone().requires_grad_(True) for n in names}
    leaves = [params[n] for n in names]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    device = leaves[0].device
    losses: list[float] = []
    first_grad: dict[str, float] = {}
    steps = traffic["local_steps"]
    model = reference.load(cfg)
    for step in range(steps):
        toks = tokens_at(cfg["vocab_size"], traffic["seq"], seed, mode[0], mode[1],
                         traffic["batch"], step)[:rows]   # round 0: key = step
        loss = model.loss(params, torch.from_numpy(toks).to(device), cfg, precision)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if step == 0:
            first_grad = {n: float(torch.linalg.vector_norm(g, dtype=torch.float64))
                          for n, g in zip(names, grads)}
        adamw_step(leaves, list(grads), m, v, step + 1, traffic["lr"])
        del grads, loss
    return {"params": {n: params[n].detach() for n in names}, "losses": losses,
            "first_grad_norm": first_grad}
