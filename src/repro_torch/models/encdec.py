"""Whisper-style encoder-decoder backbone [arXiv:2212.04356].

Mirror of ``src/repro/models/encdec.py``. The modality frontend (mel
spectrogram + conv feature extractor) is a stub: callers pass
precomputed frame embeddings of shape (batch, encoder_seq, d_model). The
transformer itself: a bidirectional encoder (non-causal attention; at
whisper's 1,500 frames, no multiple of 128, the masked softmax) and a
causal decoder with cross-attention, whose self-attention prefills
through :func:`layers.sdpa_or_flash`. Positions are sinusoidal: prefill
adds the float64 table of :func:`layers.sinusoidal_positions`, decode the
fp32 value at its position (:func:`_sinusoid_at`), two computations, as
in the reference.

Serving as the reference's: ``prefill`` returns self-attention caches
sized to the prompt, and ``generate`` does no replay for this class, so
each decode step past the prompt writes its key and value into the
cache's last slot (the clamp of ``lax.dynamic_update_slice``; ROADMAP
C11).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import base as B
from repro_torch.models import layers as L
from repro_torch.models.ssm import _stack_states
from repro_torch.models.transformer import _layer, _unbind_tree


def _enc_block_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    return {
        "attn_norm": L.norm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "mlp_norm": L.norm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg),
    }


def _dec_block_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    return {
        "self_norm": L.norm_spec(cfg.d_model),
        "self_attn": L.attention_spec(cfg),
        "cross_norm": L.norm_spec(cfg.d_model),
        "cross_attn": L.attention_spec(cfg),
        "mlp_norm": L.norm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg),
    }


def _sinusoid_at(pos: int, d: int, dtype: torch.dtype, device: Any) -> torch.Tensor:
    """The sinusoidal position of ``pos`` in fp32, (1, 1, d)."""
    half = d // 2
    dim = torch.arange(half, dtype=torch.float32, device=device)
    base = torch.full((), 10000.0, dtype=torch.float32, device=device)
    ang = torch.full((), pos, dtype=torch.float32, device=device) / torch.pow(base, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :].to(dtype)


class EncDecModel:
    """Encoder-decoder LM over a nested dict of parameters."""

    def __init__(self, cfg: B.ModelConfig) -> None:
        if cfg.family != "encdec":
            raise ValueError(f"EncDecModel builds family 'encdec', not {cfg.family!r}")
        if not (cfg.encoder_layers > 0 and cfg.encoder_seq > 0):
            raise ValueError("encdec needs encoder_layers > 0 and encoder_seq > 0")
        self.cfg = cfg
        self._spec = {
            "embed": L.embed_spec(cfg),
            "enc_blocks": L.stack_spec(_enc_block_spec(cfg), cfg.encoder_layers),
            "enc_norm": L.norm_spec(cfg.d_model),
            "dec_blocks": L.stack_spec(_dec_block_spec(cfg), cfg.num_layers),
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

    # -- encoder ---------------------------------------------------------------
    def encode(self, params: dict[str, Any], frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, d) stub embeddings -> encoder memory."""
        cfg = self.cfg
        x = frames.to(cfg.activ_dtype)
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype, x.device)[None]

        def block(x, bp):
            x = x + L.attn_forward(L.rms_norm(x, bp["attn_norm"]), bp["attn"], cfg,
                                   causal=False)
            return x + L.mlp_forward(L.rms_norm(x, bp["mlp_norm"]), bp["mlp"])

        unbound = _unbind_tree(params["enc_blocks"])
        for i in range(cfg.encoder_layers):
            x = L.remat_block(cfg, block, x, _layer(unbound, i))
        return L.rms_norm(x, params["enc_norm"])

    # -- decoder ---------------------------------------------------------------
    def _dec_block(self, x: torch.Tensor, bp: dict[str, Any], memory: torch.Tensor
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """One decoder layer over the prompt -> (x, its decode cache)."""
        cfg = self.cfg
        bsz, s, _ = x.shape
        xin = L.rms_norm(x, bp["self_norm"])
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = L._project_qkv(xin, bp["self_attn"], cfg, positions)
        out = L.sdpa_or_flash(q, k, v, cfg, causal=True, window=None)
        x = x + out @ bp["self_attn"]["wo"].to(x.dtype)
        h, (ck, cv) = L.cross_attn_forward(L.rms_norm(x, bp["cross_norm"]), memory,
                                           bp["cross_attn"], cfg)
        x = x + h
        x = x + L.mlp_forward(L.rms_norm(x, bp["mlp_norm"]), bp["mlp"])
        kvf = cfg.kv_feat
        cache = {
            "self_k": k.reshape(bsz, s, kvf).to(cfg.activ_dtype),
            "self_v": v.reshape(bsz, s, kvf).to(cfg.activ_dtype),
            "cross_k": ck.to(cfg.activ_dtype),
            "cross_v": cv.to(cfg.activ_dtype),
        }
        return x, cache

    def _decoder(self, params: dict[str, Any], tokens: torch.Tensor, frames: torch.Tensor,
                 collect_cache: bool) -> tuple[torch.Tensor, list[dict[str, torch.Tensor]]]:
        """The decoder over the prompt -> (x, each layer's cache if
        ``collect_cache``). Without caches each block is rematerialised
        under ``cfg.remat`` when training."""
        cfg = self.cfg
        memory = self.encode(params, frames)
        x = L.embed_tokens(tokens, params["embed"], cfg.activ_dtype)
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
        unbound = _unbind_tree(params["dec_blocks"])
        caches = []
        for i in range(cfg.num_layers):
            bp = _layer(unbound, i)
            if collect_cache:
                x, cache = self._dec_block(x, bp, memory)
                caches.append(cache)
            else:
                x = L.remat_block(cfg, lambda x, bp, m: self._dec_block(x, bp, m)[0],
                                  x, bp, memory)
        return x, caches

    def forward(self, params: dict[str, Any], tokens: torch.Tensor,
                frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x, _ = self._decoder(params, tokens, frames, collect_cache=False)
        logits = L.lm_logits(x, params["embed"])
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss(self, params: dict[str, Any],
             batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        logits, aux = self.forward(params, batch["tokens"], batch["frames"])
        lm = L.causal_lm_loss(logits[:, :-1], batch["labels"][:, 1:], self.cfg.z_loss)
        return lm, {"lm_loss": lm, "aux_loss": aux}

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device: Any) -> dict[str, torch.Tensor]:
        """Zeroed decode cache stacked over decoder layers: self_k, self_v
        (L, batch, max_len, kv_feat) and cross_k, cross_v (L, batch,
        encoder_seq, KV, hd)."""
        cfg = self.cfg
        kvf, hd, dt = cfg.kv_feat, cfg.resolved_head_dim, cfg.activ_dtype
        n = cfg.num_layers
        self_shape = (n, batch, max_len, kvf)
        cross_shape = (n, batch, cfg.encoder_seq, cfg.num_kv_heads, hd)
        return {name: torch.zeros(shape, dtype=dt, device=device)
                for name, shape in (("self_k", self_shape), ("self_v", self_shape),
                                    ("cross_k", cross_shape), ("cross_v", cross_shape))}

    def cache_axes(self) -> dict[str, Any]:
        """Logical axes of the decode cache (mirrors :meth:`init_cache`)."""
        Lx, Bx = B.LAYER, B.BATCH
        return {"self_k": (Lx, Bx, B.SEQ, B.KV_FEAT), "self_v": (Lx, Bx, B.SEQ, B.KV_FEAT),
                "cross_k": (Lx, Bx, B.SEQ, None, None), "cross_v": (Lx, Bx, B.SEQ, None, None)}

    def prefill(self, params: dict[str, Any], tokens: torch.Tensor,
                frames: torch.Tensor) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Encode ``frames`` and run the decoder prompt, returning the last
        position's logits (B,1,vocab) and the cache: self-attention keys
        and values sized to the prompt, the projected memory for
        cross-attention."""
        x, caches = self._decoder(params, tokens, frames, collect_cache=True)
        return L.lm_logits(x[:, -1:], params["embed"]), _stack_states(caches)

    def decode_step(self, params: dict[str, Any], cache: dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """tokens (B,1) at ``pos`` -> logits (B,1,vocab). The self-attention
        cache is written in place (a position past it lands in its last
        slot) and ``cache`` returned."""
        cfg = self.cfg
        x = L.embed_tokens(tokens, params["embed"], cfg.activ_dtype)
        x = x + _sinusoid_at(pos, cfg.d_model, x.dtype, x.device)
        unbound = _unbind_tree(params["dec_blocks"])
        for i in range(cfg.num_layers):
            bp = _layer(unbound, i)
            self_cache = {"k": cache["self_k"][i], "v": cache["self_v"][i]}
            h, _ = L.attn_decode(L.rms_norm(x, bp["self_norm"]), bp["self_attn"], self_cache,
                                 pos, cfg)
            x = x + h
            h, _ = L.cross_attn_forward(L.rms_norm(x, bp["cross_norm"]), None, bp["cross_attn"],
                                        cfg, kv=(cache["cross_k"][i], cache["cross_v"][i]))
            x = x + h
            x = x + L.mlp_forward(L.rms_norm(x, bp["mlp_norm"]), bp["mlp"])
        return L.lm_logits(x, params["embed"]), cache
