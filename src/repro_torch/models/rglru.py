"""Griffin-style hybrid blocks: RG-LRU recurrence + local attention, 1:2
attention:recurrent ratio [arXiv:2402.19427] (RecurrentGemma).

Mirror of ``src/repro/models/rglru.py``. RG-LRU (Real-Gated Linear
Recurrent Unit):

    r_t = sigmoid(W_a x_t)                    (recurrence gate)
    i_t = sigmoid(W_x x_t)                    (input gate)
    log a_t = -c * softplus(Lambda) * r_t     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The diagonal linear recurrence runs as the reference's
``jax.lax.associative_scan``, written out in torch ops with JAX's own
odd/even recursion (O(log S) depth, parallel across batch and width);
it is no Pallas kernel in the reference, so plain torch ops serve here.

Block layout per layer (Griffin): a temporal block (RG-LRU *or* local
MQA) with residual, then a gated-GeLU MLP with residual. The layer
pattern (``cfg.block_pattern``, e.g. rglru, rglru, attn) repeats as
``n_super`` super-blocks, whose parameters stack on a leading axis under
the reference's names (``blocks.0_rglru...``); the remaining layers run
as an unstacked ``tail``. Local attention prefills through
:func:`layers.sdpa_or_flash` (the flash kernel for CUDA tensors at
lengths that are multiples of 128) with the window ``cfg.local_window``.

Numerics as the reference's: ``jax.nn.gelu`` defaults to its tanh
approximation (``F.gelu(..., approximate="tanh")``), and
``jax.nn.softplus`` is ``logaddexp(x, 0)`` with no threshold (torch's
``softplus`` switches to x above 20).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import base as B
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef
from repro_torch.models.ssm import _causal_conv, _stack_states
from repro_torch.models.transformer import _layer, _unbind_tree

CONV_K = 4
RGLRU_C = 8.0


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def _gates_to_ab(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                 lam: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's multiplier a and input b = sqrt(1 - a^2) (i x), fp32."""
    log_a = -RGLRU_C * _softplus(lam.to(torch.float32)) * r.to(torch.float32)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (
        i.to(torch.float32) * x.to(torch.float32))
    return a, b


def _combine(a1, b1, a2, b2):
    """(a1, b1) then (a2, b2): the linear recurrence's associative step."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of :func:`_combine` over dim 1, by the recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan those, then
    fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _associative_scan(*_combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2],
                                         a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x, r, i: (B,S,W); lam: (W,). Returns (h (B,S,W), h_last (B,W)), fp32.
    A carried state ``h0`` (B,W) enters as the reference folds it in: added
    to the first step's input as a_1 h0, with a_1 zeroed for the scan."""
    a, b = _gates_to_ab(x, r, i, lam)
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.to(torch.float32)
        a = a.clone()
        a[:, 0] = 0.0
    _, h = _associative_scan(a, b)
    return h, h[:, -1]


def rglru_step(h_prev: torch.Tensor, x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               lam: torch.Tensor) -> torch.Tensor:
    """One decode step. h_prev, x, r, i: (B,W)."""
    a, b = _gates_to_ab(x, r, i, lam)
    return a * h_prev.to(torch.float32) + b


# ---------------------------------------------------------------------------
# recurrent temporal block
# ---------------------------------------------------------------------------

def rec_block_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    w = cfg.rglru_width or cfg.d_model
    return {
        "norm": L.norm_spec(d),
        "w_in": ParamDef((d, w), (B.EMBED, B.STATE)),
        "w_gate_branch": ParamDef((d, w), (B.EMBED, B.STATE)),
        "conv_w": ParamDef((CONV_K, w), (None, B.STATE)),
        "w_r": ParamDef((w, w), (B.STATE, B.STATE)),
        "b_r": ParamDef((w,), (B.STATE,), init="zeros"),
        "w_i": ParamDef((w, w), (B.STATE, B.STATE)),
        "b_i": ParamDef((w,), (B.STATE,), init="zeros"),
        "lam": ParamDef((w,), (B.STATE,), init="ones", scale=1.0),
        "w_out": ParamDef((w, d), (B.STATE, B.EMBED)),
    }


def _rec_in(x: torch.Tensor, p: dict[str, torch.Tensor], conv_prev: Optional[torch.Tensor]):
    """RMSNorm, the two branches, the causal conv and the gates:
    (u, r, i, gelu gate, conv state)."""
    dtype = x.dtype
    xin = L.rms_norm(x, p["norm"])
    u = xin @ p["w_in"].to(dtype)
    gate = _gelu(xin @ p["w_gate_branch"].to(dtype))
    u, conv_new = _causal_conv(u, p["conv_w"], conv_prev)
    r = torch.sigmoid(u @ p["w_r"].to(dtype) + p["b_r"].to(dtype))
    i = torch.sigmoid(u @ p["w_i"].to(dtype) + p["b_i"].to(dtype))
    return u, r, i, gate, conv_new


def rec_block_forward(x: torch.Tensor, p: dict[str, torch.Tensor], cfg: B.ModelConfig,
                      state: Optional[dict[str, torch.Tensor]] = None
                      ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """state: None (train) or {conv (B,K-1,W), h (B,W)} for streaming.
    Returns (out, new_state)."""
    u, r, i, gate, conv_new = _rec_in(x, p, state["conv"] if state is not None else None)
    h, h_last = rglru_scan(u, r, i, p["lam"], state["h"] if state is not None else None)
    y = h.to(x.dtype) * gate
    # h_last is a view of h: cloned so that the state does not keep h alive
    return x + y @ p["w_out"].to(x.dtype), {"conv": conv_new, "h": h_last.clone()}


def rec_block_decode(x: torch.Tensor, p: dict[str, torch.Tensor],
                     state: dict[str, torch.Tensor],
                     cfg: B.ModelConfig) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """x: (B,1,d) -> (out, the next {conv, h})."""
    u, r, i, gate, conv_new = _rec_in(x, p, state["conv"])
    h = rglru_step(state["h"], u[:, 0], r[:, 0], i[:, 0], p["lam"])
    y = h[:, None].to(x.dtype) * gate
    return x + y @ p["w_out"].to(x.dtype), {"conv": conv_new, "h": h}


def rec_init_state(cfg: B.ModelConfig, batch: int, device: Any) -> dict[str, torch.Tensor]:
    w = cfg.rglru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, CONV_K - 1, w), dtype=cfg.activ_dtype, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# MLP block (gated GeLU) and the attention temporal block
# ---------------------------------------------------------------------------

def mlp_block_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    return {"norm": L.norm_spec(cfg.d_model), "mlp": L.mlp_spec(cfg)}


def mlp_block_forward(x: torch.Tensor, p: dict[str, Any], cfg: B.ModelConfig) -> torch.Tensor:
    h = L.rms_norm(x, p["norm"])
    g = h @ p["mlp"]["w_gate"].to(x.dtype)
    u = h @ p["mlp"]["w_up"].to(x.dtype)
    return x + (_gelu(g) * u) @ p["mlp"]["w_down"].to(x.dtype)


def attn_block_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    return {"norm": L.norm_spec(cfg.d_model), "attn": L.attention_spec(cfg)}


# ---------------------------------------------------------------------------
# Griffin model (pattern-stacked hybrid)
# ---------------------------------------------------------------------------

class GriffinModel:
    """RG-LRU + local-attention hybrid LM over a nested dict of parameters."""

    def __init__(self, cfg: B.ModelConfig) -> None:
        if cfg.family != "hybrid":
            raise ValueError(f"GriffinModel builds family 'hybrid', not {cfg.family!r}")
        if not cfg.block_pattern:
            raise ValueError("hybrid needs cfg.block_pattern")
        self.cfg = cfg
        pat = cfg.block_pattern
        self.n_super = cfg.num_layers // len(pat)
        self.tail_pattern = pat[: cfg.num_layers % len(pat)]

        def layer_spec(kind: str) -> dict[str, Any]:
            temporal = rec_block_spec(cfg) if kind == "rglru" else attn_block_spec(cfg)
            return {"temporal": temporal, "mlp_block": mlp_block_spec(cfg)}

        super_spec = {f"{i}_{k}": layer_spec(k) for i, k in enumerate(pat)}
        self._spec: dict[str, Any] = {
            "embed": L.embed_spec(cfg),
            "blocks": L.stack_spec(super_spec, self.n_super),
        }
        if self.tail_pattern:
            self._spec["tail"] = {f"{i}_{k}": layer_spec(k)
                                  for i, k in enumerate(self.tail_pattern)}

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

    def _groups(self, params: dict[str, Any]):
        """Each super-block in order, then the tail: (super-block index,
        or None for the tail, and its layers as (key, kind, layer
        params))."""
        unbound = _unbind_tree(params["blocks"])
        for s in range(self.n_super):
            bp = _layer(unbound, s)
            yield s, [(f"{i}_{kind}", kind, bp[f"{i}_{kind}"])
                      for i, kind in enumerate(self.cfg.block_pattern)]
        if self.tail_pattern:
            yield None, [(f"{i}_{kind}", kind, params["tail"][f"{i}_{kind}"])
                         for i, kind in enumerate(self.tail_pattern)]

    # -- layer application helpers -------------------------------------------
    def _apply_layer(self, x: torch.Tensor, kind: str, lp: dict[str, Any]):
        """One layer over a full sequence -> (x, its decode state)."""
        cfg = self.cfg
        if kind == "rglru":
            x, state = rec_block_forward(x, lp["temporal"], cfg)
        else:
            xin = L.rms_norm(x, lp["temporal"]["norm"])
            bsz, s, _ = xin.shape
            positions = torch.arange(s, device=x.device)[None, :]
            q, k, v = L._project_qkv(xin, lp["temporal"]["attn"], cfg, positions)
            out = L.sdpa_or_flash(q, k, v, cfg, causal=True, window=cfg.local_window)
            x = x + out @ lp["temporal"]["attn"]["wo"].to(x.dtype)
            w = min(cfg.local_window, s)
            kvf = cfg.kv_feat
            pos = torch.arange(s - w, s, dtype=torch.int32, device=x.device)
            state = {
                "k": k.reshape(bsz, s, kvf)[:, s - w:].to(cfg.activ_dtype),
                "v": v.reshape(bsz, s, kvf)[:, s - w:].to(cfg.activ_dtype),
                "pos": pos.expand(bsz, w).contiguous(),
            }
        return mlp_block_forward(x, lp["mlp_block"], cfg), state

    def _apply_layer_decode(self, x: torch.Tensor, kind: str, lp: dict[str, Any],
                            st: dict[str, torch.Tensor], pos: int) -> torch.Tensor:
        """One layer on one token; writes the layer's state ``st`` in place."""
        cfg = self.cfg
        if kind == "rglru":
            x, new = rec_block_decode(x, lp["temporal"], st, cfg)
            st["conv"].copy_(new["conv"])
            st["h"].copy_(new["h"])
        else:
            h, _ = L.attn_decode(L.rms_norm(x, lp["temporal"]["norm"]), lp["temporal"]["attn"],
                                 st, pos, cfg, window=cfg.local_window)
            x = x + h
        return mlp_block_forward(x, lp["mlp_block"], cfg)

    # -- training -------------------------------------------------------------
    def forward(self, params: dict[str, Any], tokens: torch.Tensor,
                patches: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Logits and a zero aux loss; ``patches`` is unused, as in the
        reference. Each super-block (not the tail) is rematerialised
        under ``cfg.remat`` when training, as the reference's scan body."""
        del patches
        x = L.embed_tokens(tokens, params["embed"], self.cfg.activ_dtype)

        def run(x, layers):
            for _key, kind, lp in layers:
                x, _ = self._apply_layer(x, kind, lp)
            return x

        for s, layers in self._groups(params):
            x = run(x, layers) if s is None else L.remat_block(self.cfg, run, x, layers)
        logits = L.lm_logits(x, params["embed"])
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss(self, params: dict[str, Any],
             batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        logits, aux = self.forward(params, batch["tokens"])
        lm = L.causal_lm_loss(logits[:, :-1], batch["labels"][:, 1:], self.cfg.z_loss)
        return lm, {"lm_loss": lm, "aux_loss": aux}

    # -- serving ---------------------------------------------------------------
    def _layer_state(self, kind: str, batch: int, max_len: int,
                     device: Any) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        if kind == "rglru":
            return rec_init_state(cfg, batch, device)
        return L.init_window_cache(cfg, batch, min(cfg.local_window, max_len),
                                   cfg.activ_dtype, device)

    def init_cache(self, batch: int, max_len: int, device: Any) -> dict[str, Any]:
        """Zeroed decode state: ``blocks`` {key: state stacked over the
        super-blocks} and ``tail`` {key: state}; an RG-LRU layer's state is
        {conv (B,K-1,W), h (B,W) fp32}, an attention layer's a window cache
        of min(local_window, max_len) slots."""
        pat = self.cfg.block_pattern
        one = {f"{i}_{k}": self._layer_state(k, batch, max_len, device)
               for i, k in enumerate(pat)}
        cache: dict[str, Any] = {"blocks": _stack_states([one] * self.n_super)}
        if self.tail_pattern:
            cache["tail"] = {f"{i}_{k}": self._layer_state(k, batch, max_len, device)
                             for i, k in enumerate(self.tail_pattern)}
        return cache

    def cache_axes(self) -> dict[str, Any]:
        """Logical axes of the decode state (mirrors :meth:`init_cache`)."""
        def layer_axes(kind: str, with_layer: bool) -> dict[str, tuple]:
            pre = (B.LAYER,) if with_layer else ()
            if kind == "rglru":
                return {"conv": pre + (B.BATCH, None, B.STATE), "h": pre + (B.BATCH, B.STATE)}
            return {"k": pre + (B.BATCH, B.SEQ, B.KV_FEAT), "v": pre + (B.BATCH, B.SEQ, B.KV_FEAT),
                    "pos": pre + (B.BATCH, B.SEQ)}

        pat = self.cfg.block_pattern
        axes: dict[str, Any] = {"blocks": {f"{i}_{k}": layer_axes(k, True)
                                           for i, k in enumerate(pat)}}
        if self.tail_pattern:
            axes["tail"] = {f"{i}_{k}": layer_axes(k, False)
                            for i, k in enumerate(self.tail_pattern)}
        return axes

    def prefill(self, params: dict[str, Any], tokens: torch.Tensor,
                patches: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, dict[str, Any]]:
        """Run the prompt, returning the last position's logits (B,1,vocab)
        and the decode state after it: each RG-LRU layer's conv state and
        h, each attention layer's last min(window, S) keys and values with
        their positions. ``patches`` is unused, as in the reference."""
        del patches
        x = L.embed_tokens(tokens, params["embed"], self.cfg.activ_dtype)
        stacked: list[dict[str, Any]] = [{} for _ in range(self.n_super)]
        tail: dict[str, Any] = {}
        for s, layers in self._groups(params):
            for key, kind, lp in layers:
                x, state = self._apply_layer(x, kind, lp)
                (tail if s is None else stacked[s])[key] = state
        cache: dict[str, Any] = {"blocks": _stack_states(stacked)}
        if self.tail_pattern:
            cache["tail"] = tail
        return L.lm_logits(x[:, -1:], params["embed"]), cache

    def decode_step(self, params: dict[str, Any], cache: dict[str, Any],
                    tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict[str, Any]]:
        """One token for the whole batch: tokens (B,1) at ``pos`` -> logits
        (B,1,vocab). ``cache`` is updated in place (each layer writes
        through views of the stacked tensors) and returned."""
        x = L.embed_tokens(tokens, params["embed"], self.cfg.activ_dtype)
        for s, layers in self._groups(params):
            for key, kind, lp in layers:
                if s is None:
                    st = cache["tail"][key]
                else:
                    st = {name: t[s] for name, t in cache["blocks"][key].items()}
                x = self._apply_layer_decode(x, kind, lp, st, pos)
        return L.lm_logits(x, params["embed"]), cache
