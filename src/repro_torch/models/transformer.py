"""Decoder-only transformer, dense family.

Mirror of ``src/repro/models/transformer.py`` (``DecoderLM``) for
``family == "dense"``: one block = RMSNorm -> GQA attention -> residual,
RMSNorm -> gated MLP -> residual. Per-layer parameters stay **stacked**
on a leading layer axis (``blocks.attn.wq`` is (L, d, q_feat)), exactly
as the reference's ``lax.scan`` consumes them, so flat names and wire
bytes match; the forward walks the layers in a Python loop over
``unbind`` views (one backward ``stack`` per parameter, no per-layer
full-size gradient buffers). MoE, VLM prefixes and the decode cache wait
for later slices (ROADMAP A12).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import base as B
from repro_torch.models import layers as L


def _block_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    return {
        "attn_norm": L.norm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "mlp_norm": L.norm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg),
    }


def _block_forward(x: torch.Tensor, bp: dict[str, Any], cfg: B.ModelConfig, *,
                   window: Optional[int]) -> torch.Tensor:
    h = L.attn_forward(L.rms_norm(x, bp["attn_norm"]), bp["attn"], cfg,
                       causal=True, window=window)
    x = x + h
    h = L.mlp_forward(L.rms_norm(x, bp["mlp_norm"]), bp["mlp"])
    return x + h


def _unbind_tree(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _unbind_tree(v) for k, v in node.items()}
    return node.unbind(0)


def _layer(unbound: Any, i: int) -> Any:
    if isinstance(unbound, dict):
        return {k: _layer(v, i) for k, v in unbound.items()}
    return unbound[i]


class DecoderLM:
    """Dense decoder LM over a nested dict of parameters."""

    def __init__(self, cfg: B.ModelConfig) -> None:
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to repro_torch yet (ROADMAP A12)")
        self.cfg = cfg
        self._spec = {
            "embed": L.embed_spec(cfg),
            "blocks": L.stack_spec(_block_spec(cfg), cfg.num_layers),
        }

    # -- params ------------------------------------------------------------
    def init(self, seed: int, device: Any) -> dict[str, Any]:
        """Seeded init on ``device`` (a ``torch.Generator`` there)."""
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return L.build_params(gen, self._spec, self.cfg.param_dtype, device)

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        """Flat ``{dotted.name: shape}`` of the parameters."""
        return L.param_shapes(self._spec)

    # -- forward / loss ------------------------------------------------------
    def forward(self, params: dict[str, Any], tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = L.embed_tokens(tokens, params["embed"], cfg.activ_dtype)
        unbound = _unbind_tree(params["blocks"])
        for i in range(cfg.num_layers):
            x = _block_forward(x, _layer(unbound, i), cfg, window=cfg.sliding_window)
        logits = L.lm_logits(x, params["embed"])
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        return logits, aux

    def loss(self, params: dict[str, Any],
             batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        cfg = self.cfg
        logits, aux = self.forward(params, batch["tokens"])
        lm = L.causal_lm_loss(logits[:, :-1], batch["labels"][:, 1:], cfg.z_loss)
        total = lm + cfg.aux_loss_coef * aux
        return total, {"lm_loss": lm, "aux_loss": aux}
