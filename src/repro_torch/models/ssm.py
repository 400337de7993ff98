"""xLSTM (sLSTM + mLSTM blocks) [arXiv:2405.04517].

Mirror of ``src/repro/models/ssm.py``: plain functions on tensors plus
:class:`XLSTMModel`, with the reference's parameter layout (``x @ W``,
``W`` as (d_in, d_out)), stacked over the (mLSTM, sLSTM) super-blocks
under the reference's dotted names.

mLSTM — matrix-memory LSTM with exponential gating, in three forms the
tests hold to one another: ``mlstm_step`` (decode), ``mlstm_parallel``
(quadratic) and ``mlstm_chunkwise`` (intra-chunk quadratic, inter-chunk
recurrent; training and prefill).

sLSTM — scalar-memory LSTM with block-diagonal (per-head) recurrent
weights; sequential by nature. ``forward`` and ``loss`` run it as a cell
loop (they carry gradients). ``prefill`` runs it through the sLSTM-scan
wrapper (``kernels/slstm_scan.py``) at any length: on a CUDA tensor that
launches the hand-written kernel, on a CPU tensor it runs the plain
version. The wrapper returns h and the final state, which prefill keeps
as the decode cache; with tracing on, the span ``kernel.slstm_scan`` times
each recurrence.

The sLSTM state carries the reference's sharding hint (``L.constrain``,
a no-op outside the dry run's sharding context). Exponential gates are
stabilised with a running max ``m``, as in the paper's appendix.

The dry run (``launch/dryrun.py``) counts a step on ``meta`` tensors, where
a loop of one step a token is too slow to run in full: inside
:func:`cut_time_loops` the time loops here (the sLSTM cells, the sLSTM
scan, the mLSTM chunks) run only their first few steps on meta tensors.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.models import base as B
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef
from repro_torch.models.transformer import _layer, _unbind_tree
from repro_torch.obs import trace as obs_trace

GATES = ("z", "i", "f", "o")

#: a time loop of more steps than this may be cut (:func:`cut_time_loops`)
CUT_ABOVE = 5
#: the steps a cut loop runs, unless its trip count is given a longer run
CUT_STEPS = 3
_cut: Optional[tuple[dict[int, int], list[int]]] = None


class _CutTimeLoops:
    def __init__(self, longer: Optional[dict[int, int]]) -> None:
        self.longer, self.cut = longer or {}, []

    def __enter__(self) -> list[int]:
        global _cut
        _cut = (self.longer, self.cut)
        return self.cut

    def __exit__(self, *exc: Any) -> None:
        global _cut
        _cut = None


def cut_time_loops(longer: Optional[dict[int, int]] = None) -> _CutTimeLoops:
    """A context inside which a time loop over meta tensors of n >
    :data:`CUT_ABOVE` steps runs its first :data:`CUT_STEPS`, or
    ``longer[n]``; it yields the list of the trip counts it cut, one entry
    a loop. Its outputs keep their full length: the steps left out are the
    last step's shapes again (a meta tensor holds no values). Loops over
    data always run in full."""
    return _CutTimeLoops(longer)


def _loop_steps(n: int, x: torch.Tensor) -> int:
    """How many of a time loop's ``n`` steps over ``x`` to run."""
    if _cut is None or x.device.type != "meta" or n <= CUT_ABOVE:
        return n
    _cut[1].append(n)
    return _cut[0].get(n, CUT_STEPS)


# ---------------------------------------------------------------------------
# mLSTM core math (per batch x head; feature dim hd)
# ---------------------------------------------------------------------------

def mlstm_step(state: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
               q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logi: torch.Tensor, logf: torch.Tensor):
    """One decode step. state = (C (...,hd,hd), n (...,hd), m (...,));
    q, k, v: (..., hd); logi, logf: (...,) per-head scalars."""
    C, n, m = state
    m_new = torch.maximum(logf + m, logi)
    a = torch.exp(logf + m - m_new)[..., None, None]
    b = torch.exp(logi - m_new)[..., None, None]
    C_new = a * C + b * (k[..., :, None] * v[..., None, :])
    n_new = a[..., 0] * n + b[..., 0] * k
    num = torch.einsum("...h,...hv->...v", q, C_new)
    den = torch.abs(torch.einsum("...h,...h->...", q, n_new))
    den = torch.maximum(den, torch.exp(-m_new))[..., None]
    return (C_new, n_new, m_new), num / den


def mlstm_parallel(q, k, v, logi, logf):
    """Quadratic form. q, k, v: (B,H,S,hd); logi, logf: (B,H,S)."""
    S = q.shape[2]
    Fc = torch.cumsum(logf, dim=-1)
    D = Fc[..., :, None] - Fc[..., None, :] + logi[..., None, :]
    tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    D = torch.where(tri, D, -math.inf)
    m = torch.amax(D, dim=-1)
    E = torch.exp(D - m[..., None])
    scores = torch.einsum("bhsd,bhtd->bhst", q, k) * E
    den = torch.maximum(torch.abs(scores.sum(-1)), torch.exp(-m))
    return torch.einsum("bhst,bhtd->bhsd", scores, v) / den[..., None]


def mlstm_chunkwise(q, k, v, logi, logf, chunk: int = 256,
                    state: Optional[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None):
    """Chunked parallel mLSTM. q, k, v: (B,H,S,hd); logi, logf: (B,H,S).
    Returns (h (B,H,S,hd), final state (C, n, m)); S must be a multiple
    of ``chunk``. The state starts at m = -inf, as the reference's."""
    Bsz, H, S, hd = q.shape
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    if state is None:
        C = torch.zeros((Bsz, H, hd, hd), dtype=torch.float32, device=q.device)
        n = torch.zeros((Bsz, H, hd), dtype=torch.float32, device=q.device)
        m_prev = torch.full((Bsz, H), -math.inf, dtype=torch.float32, device=q.device)
    else:
        C, n, m_prev = state
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    hs = []
    n_chunks = S // chunk
    steps = _loop_steps(n_chunks, q)
    for start in range(0, steps * chunk, chunk):
        sl = slice(start, start + chunk)
        qt, kt, vt, li, lf = q[:, :, sl], k[:, :, sl], v[:, :, sl], logi[..., sl], logf[..., sl]
        Lt = torch.cumsum(lf, dim=-1)                       # inclusive
        b_tot = Lt[..., -1]
        # intra-chunk decay D_tj = L_t - L_j + logi_j (t >= j)
        D = Lt[..., :, None] - Lt[..., None, :] + li[..., None, :]
        D = torch.where(tri, D, -math.inf)
        m_intra = torch.amax(D, dim=-1)
        # the carried state enters at weight L_t + m_prev
        m_t = torch.maximum(m_intra, Lt + m_prev[..., None])
        w_inter = torch.exp(Lt + m_prev[..., None] - m_t)
        E = torch.exp(D - m_t[..., None])
        scores = torch.einsum("bhsd,bhtd->bhst", qt, kt) * E
        num = (torch.einsum("bhst,bhtd->bhsd", scores, vt)
               + w_inter[..., None] * torch.einsum("bhsd,bhdv->bhsv", qt, C))
        den = scores.sum(-1) + w_inter * torch.einsum("bhsd,bhd->bhs", qt, n)
        den = torch.maximum(torch.abs(den), torch.exp(-m_t))
        hs.append(num / den[..., None])
        # the state at the end of the chunk
        w_state = b_tot[..., None] - Lt + li                # b - L_j + logi_j
        m_new = torch.maximum(b_tot + m_prev, torch.amax(w_state, dim=-1))
        decay_C = torch.exp(b_tot + m_prev - m_new)[..., None, None]
        wk = torch.exp(w_state - m_new[..., None])
        C = decay_C * C + torch.einsum("bhtd,bht,bhtv->bhdv", kt, wk, vt)
        n = decay_C[..., 0] * n + torch.einsum("bhtd,bht->bhd", kt, wk)
        m_prev = m_new
    hs += hs[-1:] * (n_chunks - steps)   # a cut loop repeats its last chunk
    return torch.cat(hs, dim=2), (C, n, m_prev)


# ---------------------------------------------------------------------------
# mLSTM block (up-proj, causal conv, qkv, gates, out-gate, down-proj)
# ---------------------------------------------------------------------------

CONV_K = 4  # causal depthwise conv kernel width (the paper's conv4)


def _mlstm_dims(cfg: B.ModelConfig) -> tuple[int, int, int]:
    d_inner = 2 * cfg.d_model
    H = cfg.num_heads
    return d_inner, H, d_inner // H


def mlstm_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    d_inner, H, _hd = _mlstm_dims(cfg)
    return {
        "norm": L.norm_spec(d),
        "w_up": ParamDef((d, 2 * d_inner), (B.EMBED, B.MLP)),        # [x_m | z]
        "conv_w": ParamDef((CONV_K, d_inner), (None, B.MLP)),
        "wq": ParamDef((d_inner, d_inner), (B.MLP, B.Q_FEAT)),
        "wk": ParamDef((d_inner, d_inner), (B.MLP, B.Q_FEAT)),
        "wv": ParamDef((d_inner, d_inner), (B.MLP, B.Q_FEAT)),
        "w_i": ParamDef((d_inner, H), (B.MLP, None)),
        "b_i": ParamDef((H,), (None,), init="zeros"),
        "w_f": ParamDef((d_inner, H), (B.MLP, None)),
        "b_f": ParamDef((H,), (None,), init="zeros"),
        "out_norm": ParamDef((d_inner,), (B.MLP,), init="zeros"),
        "w_down": ParamDef((d_inner, d), (B.MLP, B.EMBED)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B,S,D); w: (K,D); prev: (B,K-1,D) state.
    Returns (y, new_prev)."""
    K = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    return y, xp[:, -(K - 1):].contiguous()


def _mlstm_project(xm: torch.Tensor, p: dict[str, torch.Tensor], cfg: B.ModelConfig):
    """Shared q/k/v/gate projections. xm: (B,S,d_inner) post-conv input."""
    _d_inner, H, hd = _mlstm_dims(cfg)
    Bsz, S, _ = xm.shape
    q = xm @ p["wq"].to(xm.dtype) / math.sqrt(hd)
    k = xm @ p["wk"].to(xm.dtype) / math.sqrt(hd)
    v = xm @ p["wv"].to(xm.dtype)

    def heads(t):
        return L.constrain_for_heads(t, H).reshape(Bsz, S, H, hd).transpose(1, 2)

    logi = xm @ p["w_i"].to(xm.dtype) + p["b_i"].to(xm.dtype)
    logf = F.logsigmoid((xm @ p["w_f"].to(xm.dtype)).to(torch.float32)
                        + p["b_f"].to(torch.float32))
    return (heads(q).to(torch.float32), heads(k).to(torch.float32),
            heads(v).to(torch.float32), logi.transpose(1, 2).to(torch.float32),
            logf.transpose(1, 2))


def _mlstm_in(x: torch.Tensor, p: dict[str, torch.Tensor], prev=None):
    """RMSNorm, up-projection and causal conv: (silu(conv(x_m)), z, conv state)."""
    xin = L.rms_norm(x, p["norm"])
    up = xin @ p["w_up"].to(x.dtype)
    xm_raw, z = up.chunk(2, dim=-1)
    xm, conv_state = _causal_conv(xm_raw, p["conv_w"], prev)
    return F.silu(xm), z, conv_state


def _mlstm_out(x: torch.Tensor, h: torch.Tensor, z: torch.Tensor,
               p: dict[str, torch.Tensor]) -> torch.Tensor:
    """h: (B,S,d_inner) -> residual + down-projection of the gated, normed h."""
    h = L.rms_norm(h.to(x.dtype), p["out_norm"]) * F.silu(z)
    return x + h @ p["w_down"].to(x.dtype)


def mlstm_block_forward(x: torch.Tensor, p: dict[str, Any], cfg: B.ModelConfig,
                        chunk: int = 256) -> torch.Tensor:
    d_inner, _H, _hd = _mlstm_dims(cfg)
    Bsz, S, _ = x.shape
    xm, z, _ = _mlstm_in(x, p)
    q, k, v, logi, logf = _mlstm_project(xm, p, cfg)
    c = min(chunk, S)
    if S % c != 0:
        c = S  # tiny smoke shapes: a single chunk
    h, _ = mlstm_chunkwise(q, k, v, logi, logf, chunk=c)
    return _mlstm_out(x, h.transpose(1, 2).reshape(Bsz, S, d_inner), z, p)


def mlstm_init_state(cfg: B.ModelConfig, batch: int, device: Any) -> dict[str, torch.Tensor]:
    d_inner, H, hd = _mlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, H, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, H), -1e30, dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, d_inner), dtype=cfg.activ_dtype, device=device),
    }


def mlstm_block_decode(x: torch.Tensor, p: dict[str, Any], state: dict[str, torch.Tensor],
                       cfg: B.ModelConfig) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """x: (B,1,d)."""
    d_inner, _H, _hd = _mlstm_dims(cfg)
    Bsz = x.shape[0]
    xm, z, conv_new = _mlstm_in(x, p, state["conv"])
    q, k, v, logi, logf = _mlstm_project(xm, p, cfg)      # (B,H,1,hd) / (B,H,1)
    (C, n, m), h = mlstm_step((state["C"], state["n"], state["m"]), q[:, :, 0], k[:, :, 0],
                              v[:, :, 0], logi[:, :, 0], logf[:, :, 0])
    out = _mlstm_out(x, h.reshape(Bsz, 1, d_inner), z, p)
    return out, {"C": C, "n": n, "m": m, "conv": conv_new}


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, block-diagonal recurrence, post-FFN)
# ---------------------------------------------------------------------------

def _slstm_dims(cfg: B.ModelConfig) -> tuple[int, int]:
    H = cfg.num_heads
    return H, cfg.d_model // H


def slstm_spec(cfg: B.ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    H, hd = _slstm_dims(cfg)
    f_in = int(round(4 * d / 3 / 64)) * 64  # pf 4/3, rounded to lanes
    gates = {
        name: {
            "w": ParamDef((d, d), (B.EMBED, B.Q_FEAT)),
            "r": ParamDef((H, hd, hd), (None, None, None)),
            "b": ParamDef((d,), (B.Q_FEAT,), init="zeros"),
        }
        for name in GATES
    }
    return {
        "norm": L.norm_spec(d),
        **gates,
        "out_norm": ParamDef((d,), (B.EMBED,), init="zeros"),
        "ffn_norm": L.norm_spec(d),
        "ffn": {
            "w_gate": ParamDef((d, f_in), (B.EMBED, B.MLP)),
            "w_up": ParamDef((d, f_in), (B.EMBED, B.MLP)),
            "w_down": ParamDef((f_in, d), (B.MLP, B.EMBED)),
        },
    }


def slstm_gate_x(xin: torch.Tensor, p: dict[str, Any],
                 cfg: B.ModelConfig) -> dict[str, torch.Tensor]:
    """The input projections, one product per gate over the whole
    sequence, outside the time loop. xin: (B,S,d) -> {name: (B,S,H,hd)}."""
    H, hd = _slstm_dims(cfg)
    Bsz, S, _ = xin.shape
    return {name: L.constrain_for_heads(xin @ p[name]["w"].to(xin.dtype)
                                        + p[name]["b"].to(xin.dtype), H)
            .reshape(Bsz, S, H, hd) for name in GATES}


def _slstm_cell(state: dict[str, torch.Tensor], gx_t: dict[str, torch.Tensor],
                p: dict[str, Any]) -> dict[str, torch.Tensor]:
    """state: {c, n, h, m}, each (B,H,hd); gx_t: {name: (B,H,hd)} input
    projections of one step; only the recurrent part runs here."""
    h_prev = state["h"]
    dtype = gx_t["z"].dtype

    def gate(name):
        gh = torch.einsum("bhk,hkl->bhl", h_prev.to(dtype), p[name]["r"].to(dtype))
        return (gx_t[name] + gh).to(torch.float32)

    z = torch.tanh(gate("z"))
    o = torch.sigmoid(gate("o"))
    logi = gate("i")
    logf = F.logsigmoid(gate("f"))
    m_new = torch.maximum(logf + state["m"], logi)
    i_s = torch.exp(logi - m_new)
    f_s = torch.exp(logf + state["m"] - m_new)
    c = f_s * state["c"] + i_s * z
    n = f_s * state["n"] + i_s
    h = o * c / torch.clamp(n, min=1e-6)
    # the state stays batch-sharded under a sharding context (the reference's hint)
    return {name: L.constrain(t, (B.BATCH, None, None))
            for name, t in (("c", c), ("n", n), ("h", h), ("m", m_new))}


def slstm_init_state(cfg: B.ModelConfig, batch: int, device: Any) -> dict[str, torch.Tensor]:
    H, hd = _slstm_dims(cfg)

    def zeros():
        return torch.zeros((batch, H, hd), dtype=torch.float32, device=device)

    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full((batch, H, hd), -1e30, dtype=torch.float32, device=device)}


def _slstm_cells(gx: dict[str, torch.Tensor], p: dict[str, Any], cfg: B.ModelConfig
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The cell loop over the sequence: gx {name: (B,S,H,hd)} -> h (B,S,H,hd)
    and the final state."""
    Bsz, S = gx["z"].shape[:2]
    state = slstm_init_state(cfg, Bsz, gx["z"].device)
    hs = []
    steps = _loop_steps(S, gx["z"])
    for t in range(steps):
        state = _slstm_cell(state, {name: g[:, t] for name, g in gx.items()}, p)
        hs.append(state["h"])
    hs += hs[-1:] * (S - steps)          # a cut loop repeats its last h
    return torch.stack(hs, dim=1), state


def _slstm_scan(gx: dict[str, torch.Tensor], p: dict[str, Any], cfg: B.ModelConfig
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The recurrence through the kernel: the four gates' inputs stacked as
    (B,S,4,d) in order z, i, f, o and their r as (4,H,hd,hd) -> h (B,S,d)
    and the final state. The whole sequence is one chunk: the kernel walks
    it in one launch at any length."""
    H, _hd = _slstm_dims(cfg)
    Bsz, S = gx["z"].shape[:2]
    gx4 = torch.stack([gx[name] for name in GATES], dim=2).reshape(Bsz, S, 4, cfg.d_model)
    r4 = torch.stack([p[name]["r"].to(torch.float32) for name in GATES])
    steps = _loop_steps(S, gx4)
    if steps == S:
        h, (c, n, h_last, m) = slstm_scan(gx4, r4, num_heads=H, chunk=S)
    else:   # a cut loop: the first steps, then an h of the full length in place of theirs
        h, (c, n, h_last, m) = slstm_scan(gx4[:, :steps], r4, num_heads=H, chunk=steps)
        del h
        h = gx4.new_empty((Bsz, S, cfg.d_model), dtype=torch.float32)
    return h, {"c": c, "n": n, "h": h_last, "m": m}


def _slstm_out(x: torch.Tensor, h: torch.Tensor, p: dict[str, Any]) -> torch.Tensor:
    """Residual of the normed h, then the gated FFN with its residual."""
    x = x + L.rms_norm(h.to(x.dtype), p["out_norm"])
    hh = L.rms_norm(x, p["ffn_norm"])
    g = hh @ p["ffn"]["w_gate"].to(x.dtype)
    u = hh @ p["ffn"]["w_up"].to(x.dtype)
    return x + (F.silu(g) * u) @ p["ffn"]["w_down"].to(x.dtype)


def slstm_block_forward(x: torch.Tensor, p: dict[str, Any], cfg: B.ModelConfig) -> torch.Tensor:
    Bsz, S, d = x.shape
    gx = slstm_gate_x(L.rms_norm(x, p["norm"]), p, cfg)
    h, _ = _slstm_cells(gx, p, cfg)
    return _slstm_out(x, h.reshape(Bsz, S, d), p)


def slstm_block_decode(x: torch.Tensor, p: dict[str, Any], state: dict[str, torch.Tensor],
                       cfg: B.ModelConfig) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    Bsz, _, d = x.shape
    gx = slstm_gate_x(L.rms_norm(x, p["norm"]), p, cfg)
    new = _slstm_cell(state, {name: g[:, 0] for name, g in gx.items()}, p)
    return _slstm_out(x, new["h"].reshape(Bsz, 1, d), p), new


# ---------------------------------------------------------------------------
# xLSTM model: (mLSTM, sLSTM) super-blocks
# ---------------------------------------------------------------------------

def _stack_states(states: list[dict[str, Any]]) -> dict[str, Any]:
    return {k: _stack_states([s[k] for s in states]) if isinstance(states[0][k], dict)
            else torch.stack([s[k] for s in states]) for k in states[0]}


class XLSTMModel:
    """xLSTM LM over a nested dict of parameters stacked over super-blocks."""

    def __init__(self, cfg: B.ModelConfig) -> None:
        if cfg.family != "ssm":
            raise ValueError(f"XLSTMModel builds family 'ssm', not {cfg.family!r}")
        if cfg.num_layers % 2:
            raise ValueError("an xLSTM super-block is (mLSTM, sLSTM): num_layers must be even")
        self.cfg = cfg
        self.n_super = cfg.num_layers // 2
        super_spec = {"mlstm": mlstm_spec(cfg), "slstm": slstm_spec(cfg)}
        self._spec = {
            "embed": L.embed_spec(cfg),
            "blocks": L.stack_spec(super_spec, self.n_super),
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
    def forward(self, params: dict[str, Any],
                tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = L.embed_tokens(tokens, params["embed"], cfg.activ_dtype)

        def block(x, bp):
            x = mlstm_block_forward(x, bp["mlstm"], cfg)
            return slstm_block_forward(x, bp["slstm"], cfg)

        unbound = _unbind_tree(params["blocks"])
        for i in range(self.n_super):
            x = L.remat_block(cfg, block, x, _layer(unbound, i))
        logits = L.lm_logits(x, params["embed"])
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss(self, params: dict[str, Any],
             batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        logits, aux = self.forward(params, batch["tokens"])
        lm = L.causal_lm_loss(logits[:, :-1], batch["labels"][:, 1:], self.cfg.z_loss)
        return lm, {"lm_loss": lm, "aux_loss": aux}

    # -- serving (O(1) state, no KV cache) -----------------------------------
    def init_cache(self, batch: int, max_len: int, device: Any) -> dict[str, Any]:
        """Zeroed recurrent state, stacked over super-blocks: ``mlstm``
        {C, n, m, conv} and ``slstm`` {c, n, h, m}. ``max_len`` is unused:
        the state does not grow with the sequence."""
        del max_len
        one = {"mlstm": mlstm_init_state(self.cfg, batch, device),
               "slstm": slstm_init_state(self.cfg, batch, device)}
        return _stack_states([one] * self.n_super)

    def cache_axes(self) -> dict[str, Any]:
        """Logical axes of the recurrent state (mirrors :meth:`init_cache`)."""
        Lx, Bx, ST = B.LAYER, B.BATCH, B.STATE
        return {
            "mlstm": {"C": (Lx, Bx, None, ST, None), "n": (Lx, Bx, None, ST),
                      "m": (Lx, Bx, None), "conv": (Lx, Bx, None, B.MLP)},
            "slstm": {name: (Lx, Bx, None, ST) for name in ("c", "n", "h", "m")},
        }

    def prefill(self, params: dict[str, Any],
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict[str, Any]]:
        """Run the prompt, returning the last position's logits (B,1,vocab)
        and the recurrent state after it. The sLSTM recurrence goes
        through the scan wrapper (the kernel for a CUDA tensor)."""
        cfg = self.cfg
        x = L.embed_tokens(tokens, params["embed"], cfg.activ_dtype)
        Bsz, S, d = x.shape
        d_inner = 2 * d
        unbound = _unbind_tree(params["blocks"])
        states = []
        for i in range(self.n_super):
            bp = _layer(unbound, i)
            mp, sp = bp["mlstm"], bp["slstm"]
            # chunkwise mLSTM with its final state
            xm, z, conv_state = _mlstm_in(x, mp)
            q, k, v, logi, logf = _mlstm_project(xm, mp, cfg)
            c = 256 if S % 256 == 0 else S
            h, (C, n, m) = mlstm_chunkwise(q, k, v, logi, logf, chunk=c)
            x = _mlstm_out(x, h.transpose(1, 2).reshape(Bsz, S, d_inner), z, mp)
            mlstm_state = {"C": C, "n": n, "m": m, "conv": conv_state}
            # sLSTM recurrence with its final state (input projections hoisted)
            xin = L.rms_norm(x, sp["norm"])
            gx = slstm_gate_x(xin, sp, cfg)
            with obs_trace.span("kernel.slstm_scan", "model", batch=Bsz, steps=S):
                h, slstm_state = _slstm_scan(gx, sp, cfg)
            x = _slstm_out(x, h.reshape(Bsz, S, d), sp)
            states.append({"mlstm": mlstm_state, "slstm": slstm_state})
        logits = L.lm_logits(x[:, -1:], params["embed"])
        return logits, _stack_states(states)

    def decode_step(self, params: dict[str, Any], cache: dict[str, Any],
                    tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict[str, Any]]:
        """One token for the whole batch: tokens (B,1) -> logits (B,1,vocab)
        and the next state (a new tree; ``cache`` is not written).
        ``pos`` is unused: the recurrent state carries no positions."""
        del pos
        cfg = self.cfg
        x = L.embed_tokens(tokens, params["embed"], cfg.activ_dtype)
        unbound = _unbind_tree(params["blocks"])
        states = []
        for i in range(self.n_super):
            bp = _layer(unbound, i)
            st = _layer(cache, i)
            x, m_new = mlstm_block_decode(x, bp["mlstm"], st["mlstm"], cfg)
            x, s_new = slstm_block_decode(x, bp["slstm"], st["slstm"], cfg)
            states.append({"mlstm": m_new, "slstm": s_new})
        return L.lm_logits(x, params["embed"]), _stack_states(states)
