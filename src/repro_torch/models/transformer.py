"""Decoder-only transformer: the dense, MoE and VLM-backbone families.

Mirror of ``src/repro/models/transformer.py`` (``DecoderLM``): one block =
RMSNorm -> GQA attention -> residual, RMSNorm -> gated MLP (or, for
``moe``, the routed experts of ``models/moe.py``) -> residual; the MoE
aux loss is summed over layers. The VLM family is the same decoder
consuming stub patch embeddings as a prefix of the token embeddings
(``patches`` in ``forward``, ``loss`` and ``prefill``). Per-layer
parameters stay **stacked** on a leading layer axis (``blocks.attn.wq``
is (L, d, q_feat)), exactly as the reference's ``lax.scan`` consumes
them, so flat names and wire bytes match; the forward walks the layers
in a Python loop over ``unbind`` views (one backward ``stack`` per
parameter, no per-layer full-size gradient buffers). Serving:
``prefill`` runs the prompt through :func:`layers.sdpa_or_flash` and
returns the last position's logits and a cache; ``decode_step`` adds
one token, writing the stacked (layer-first) cache in place.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import base as B
from repro_torch.models import layers as L
from repro_torch.models import moe as M

FAMILIES = ("dense", "moe", "vlm")


def _block_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    spec: dict[str, Any] = {
        "attn_norm": L.norm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "mlp_norm": L.norm_spec(cfg.d_model),
    }
    if cfg.family == "moe":
        spec["moe"] = M.moe_spec(cfg)
    else:
        spec["mlp"] = L.mlp_spec(cfg)
    return spec


def _ffn(x: torch.Tensor, bp: dict[str, Any],
         cfg: B.ModelConfig) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's second half on the normed ``x``: the gated MLP, or the
    routed experts and their aux loss."""
    xin = L.rms_norm(x, bp["mlp_norm"])
    if cfg.family == "moe":
        return M.moe_forward(xin, bp["moe"], cfg)
    return L.mlp_forward(xin, bp["mlp"]), None


def _block_forward(x: torch.Tensor, bp: dict[str, Any], cfg: B.ModelConfig, *,
                   window: Optional[int]) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = L.attn_forward(L.rms_norm(x, bp["attn_norm"]), bp["attn"], cfg,
                       causal=True, window=window)
    x = x + h
    h, aux = _ffn(x, bp, cfg)
    return x + h, aux


def _block_decode(x: torch.Tensor, bp: dict[str, Any], cache: dict[str, torch.Tensor],
                  pos: int, cfg: B.ModelConfig, *,
                  window: Optional[int]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    h, cache = L.attn_decode(L.rms_norm(x, bp["attn_norm"]), bp["attn"], cache, pos, cfg,
                             window=window)
    x = x + h
    h, _ = _ffn(x, bp, cfg)
    return x + h, cache


def _unbind_tree(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _unbind_tree(v) for k, v in node.items()}
    return node.unbind(0)


def _layer(unbound: Any, i: int) -> Any:
    if isinstance(unbound, dict):
        return {k: _layer(v, i) for k, v in unbound.items()}
    return unbound[i]


def _embed(params: dict[str, Any], tokens: torch.Tensor, patches: Optional[torch.Tensor],
           cfg: B.ModelConfig) -> tuple[torch.Tensor, int]:
    """Token embeddings, with ``patches`` (b, n, d) prefixed when given;
    returns them and the prefix length."""
    x = L.embed_tokens(tokens, params["embed"], cfg.activ_dtype)
    if patches is None:
        return x, 0
    return torch.cat([patches.to(cfg.activ_dtype), x], dim=1), patches.shape[1]


class DecoderLM:
    """Decoder LM (dense | moe | vlm) over a nested dict of parameters."""

    def __init__(self, cfg: B.ModelConfig) -> None:
        if cfg.family not in FAMILIES:
            raise ValueError(f"DecoderLM builds families {FAMILIES}, not {cfg.family!r}")
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

    def param_axes(self) -> dict[str, Any]:
        """Each parameter's logical axes, in the parameters' structure."""
        return L.build_axes(self._spec)

    # -- forward / loss ------------------------------------------------------
    def forward(self, params: dict[str, Any], tokens: torch.Tensor,
                patches: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Logits of the token positions (the patch prefix's are dropped)
        and the aux loss summed over layers (0 but for ``moe``). Each
        block is rematerialised under ``cfg.remat`` when training."""
        cfg = self.cfg
        x, n_prefix = _embed(params, tokens, patches, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        unbound = _unbind_tree(params["blocks"])

        def block(x, bp):
            return _block_forward(x, bp, cfg, window=cfg.sliding_window)

        for i in range(cfg.num_layers):
            x, a = L.remat_block(cfg, block, x, _layer(unbound, i))
            if a is not None:
                aux = aux + a
        logits = L.lm_logits(x[:, n_prefix:], params["embed"])
        return logits, aux

    def loss(self, params: dict[str, Any],
             batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        cfg = self.cfg
        logits, aux = self.forward(params, batch["tokens"], batch.get("patches"))
        lm = L.causal_lm_loss(logits[:, :-1], batch["labels"][:, 1:], cfg.z_loss)
        total = lm + cfg.aux_loss_coef * aux
        return total, {"lm_loss": lm, "aux_loss": aux}

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device: Any) -> dict[str, torch.Tensor]:
        """Zeroed decode cache, stacked over layers: k, v (L, batch, T, kv_feat)
        with T = max_len, or min(window, max_len) plus the absolute
        positions ``pos`` (L, batch, T) for a sliding-window model."""
        cfg = self.cfg
        window = cfg.sliding_window
        if window is not None:
            one = L.init_window_cache(cfg, batch, min(window, max_len), cfg.activ_dtype, device)
        else:
            one = L.init_full_cache(cfg, batch, max_len, cfg.activ_dtype, device)
        return {k: v.unsqueeze(0).repeat((cfg.num_layers,) + (1,) * v.ndim)
                for k, v in one.items()}

    def cache_axes(self) -> dict[str, Any]:
        """Logical axes of the decode cache (mirrors :meth:`init_cache`)."""
        axes = {"k": (B.LAYER, B.BATCH, B.SEQ, B.KV_FEAT),
                "v": (B.LAYER, B.BATCH, B.SEQ, B.KV_FEAT)}
        if self.cfg.sliding_window is not None:
            axes["pos"] = (B.LAYER, B.BATCH, B.SEQ)
        return axes

    def prefill(self, params: dict[str, Any], tokens: torch.Tensor,
                patches: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Run the full prompt (after the ``patches`` prefix, if any),
        returning last-position logits (b, 1, vocab) and a cache sized to
        prefix + prompt (decode continues from pos = S)."""
        cfg = self.cfg
        window = cfg.sliding_window
        x, _ = _embed(params, tokens, patches, cfg)
        bsz, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        w = s if window is None else min(window, s)
        unbound = _unbind_tree(params["blocks"])
        ks, vs = [], []
        for i in range(cfg.num_layers):
            bp = _layer(unbound, i)
            xin = L.rms_norm(x, bp["attn_norm"])
            q, k, v = L._project_qkv(xin, bp["attn"], cfg, positions)
            out = L.sdpa_or_flash(q, k, v, cfg, causal=True, window=window)
            x = x + out @ bp["attn"]["wo"].to(x.dtype)
            x = x + _ffn(x, bp, cfg)[0]
            ks.append(k.reshape(bsz, s, cfg.kv_feat)[:, s - w:].to(cfg.activ_dtype))
            vs.append(v.reshape(bsz, s, cfg.kv_feat)[:, s - w:].to(cfg.activ_dtype))
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if window is not None:
            pos = torch.arange(s - w, s, dtype=torch.int32, device=x.device)
            cache["pos"] = pos.expand(cfg.num_layers, bsz, w).contiguous()
        logits = L.lm_logits(x[:, -1:], params["embed"])
        return logits, cache

    def decode_step(self, params: dict[str, Any], cache: dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """One new token for the whole batch: tokens (b, 1) at position
        ``pos`` -> logits (b, 1, vocab). ``cache`` is updated in place
        (each layer writes through a view of the stacked tensors) and
        returned."""
        cfg = self.cfg
        x = L.embed_tokens(tokens, params["embed"], cfg.activ_dtype)
        unbound = _unbind_tree(params["blocks"])
        for i in range(cfg.num_layers):
            layer_cache = {name: t[i] for name, t in cache.items()}
            x, _ = _block_decode(x, _layer(unbound, i), layer_cache, pos, cfg,
                                 window=cfg.sliding_window)
        logits = L.lm_logits(x, params["embed"])
        return logits, cache
