"""Shared neural building blocks: parameter specs, RMSNorm and LayerNorm,
RoPE and sinusoidal positions, GQA attention with its decode caches,
cross-attention (enc-dec), the gated MLP, embedding/head and the LM loss.

Mirror of ``src/repro/models/layers.py``. Everything is functional
(params are plain dicts of tensors) and keeps the reference's layout:
weights are ``(d_in, d_out)`` for ``x @ W``, and per-layer parameters
stack on a leading layer axis. Full-sequence attention
(:func:`sdpa_or_flash`) takes the hand-written flash-attention kernel
for CUDA tensors when both lengths are multiples of 128 — the
reference's routing under its ``pallas`` backend, a CUDA tensor standing
in for that backend — and the masked softmax ``_sdpa`` otherwise. The
kernel is forward-only, as the reference's is. Matrix products are
``torch.matmul`` in fp32, as the reference leaves them to XLA.

Every parameter's logical sharding axes come from the spec that builds
it (:func:`build_axes`). Under a sharding context
(:func:`set_sharding_context`, which the dry run installs over a
``DeviceMesh``) :func:`constrain` redistributes DTensor activations to
the placements those axes map to; without one it is a no-op.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.kernels.flash_attention import (
    DEFAULT_BLOCK_K,
    DEFAULT_BLOCK_Q,
    flash_attention,
)
from repro_torch.models import base as B
from repro_torch.peft.lowrank import LowRankDelta
from repro_torch.utils.trees import numpy_dtype


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


def build_axes(spec: dict[str, Any]) -> Any:
    """The logical axes of every parameter of ``spec``, in its structure:
    a model's ``param_axes()``."""
    if isinstance(spec, ParamDef):
        return spec.axes
    return {k: build_axes(v) for k, v in spec.items()}


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


def remat_block(cfg: B.ModelConfig, fn: Any, *args: Any) -> Any:
    """``fn(*args)``, one block of a model's layer loop. With
    ``cfg.remat`` and autograd recording, its activations are recomputed
    in the backward instead of kept (the reference's
    ``jax.checkpoint(body)``); the values are the same either way. The
    blocks draw no random numbers, so no RNG state is stashed."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# activation-sharding context (set by the dry run; a no-op otherwise)
# ---------------------------------------------------------------------------

_SHARD_CTX: Optional[tuple[Any, dict[str, tuple[str, ...]]]] = None


def set_sharding_context(mesh: Any, rules: Optional[dict[str, tuple[str, ...]]]) -> None:
    """Install (a ``DeviceMesh``, logical -> mesh-axis rules) so model code
    can constrain its activations; ``set_sharding_context(None, None)``
    removes it. Without a context every constraint is a no-op, as in the
    reference."""
    global _SHARD_CTX
    _SHARD_CTX = None if mesh is None else (mesh, rules)


def _mesh_axis_size(axis: str) -> int:
    if _SHARD_CTX is None:
        return 1
    mesh, rules = _SHARD_CTX
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[m] for m in rules.get(axis, ()) if m in sizes)


def constrain(x: torch.Tensor, axes: tuple[Optional[str], ...]) -> torch.Tensor:
    """Redistribute a DTensor activation to the placements its logical
    ``axes`` map to under the context's rules (divisibility-safe, as the
    reference's ``with_sharding_constraint``). A plain tensor, or no
    context, passes through."""
    if _SHARD_CTX is None:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import placements, spec_for

    if not isinstance(x, DTensor):
        return x
    mesh, rules = _SHARD_CTX
    target = placements(spec_for(x.shape, axes, mesh, rules), mesh)
    return x if tuple(x.placements) == target else x.redistribute(mesh, target)


def _qkv_axes(cfg: B.ModelConfig, s: int) -> Optional[tuple[tuple, tuple, tuple]]:
    """The reference's choice of attention parallelism by divisibility, as
    logical axes of q, k, v (b, s, heads, hd): heads over ``model`` when
    both head counts divide; otherwise q over the sequence with k/v
    replicated over ``model`` (context parallelism); at one query (decode)
    heads or nothing. None without a sharding context."""
    model_sz = _mesh_axis_size(B.Q_FEAT)
    if model_sz <= 1:
        return None
    if cfg.num_heads % model_sz == 0 and cfg.num_kv_heads % model_sz == 0:
        return ((B.BATCH, None, B.Q_FEAT, None), (B.BATCH, None, B.KV_FEAT, None),
                (B.BATCH, None, B.KV_FEAT, None))
    rest = (B.BATCH, None, None, None)
    if s > 1 and s % model_sz == 0:
        return (B.BATCH, B.Q_FEAT, None, None), rest, rest       # q seq-sharded
    return rest, rest, rest


def heads_axis(num_heads: int) -> Optional[str]:
    """The logical axis of a dim of ``num_heads`` heads (or of their
    features, heads outermost): ``Q_FEAT`` (over ``model``) where the
    ``model`` axis divides the head count, else None (replicated)."""
    return B.Q_FEAT if num_heads % _mesh_axis_size(B.Q_FEAT) == 0 else None


def constrain_for_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``x`` (b, s, features), placed so its features split into
    ``num_heads``: where the ``model`` axis does not divide the head count,
    the features are replicated (DTensor cannot split a dim sharded
    unevenly); a no-op otherwise, and without a sharding context."""
    if heads_axis(num_heads) is not None:
        return x
    return constrain(x, (B.BATCH,) + (None,) * (x.ndim - 1))


def constrain_heads_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cfg: B.ModelConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (b, s, heads, hd) constrained by :func:`_qkv_axes`."""
    axes = _qkv_axes(cfg, q.shape[1])
    if axes is None:
        return q, k, v
    q, k, v = (constrain(t, a) for t, a in zip((q, k, v), axes))
    return q, k, v


def splits(n: int, axis: str) -> bool:
    """Whether a dim of ``n`` along logical ``axis`` splits over its mesh
    axes under the sharding context (divisibility-safe, as
    :func:`constrain` places it); False without a context."""
    if _SHARD_CTX is None:
        return False
    from repro_torch.launch.sharding import spec_for

    mesh, rules = _SHARD_CTX
    return spec_for((n,), (axis,), mesh, rules)[0] is not None


def is_sharded(x: Any) -> bool:
    """True under a sharding context for a DTensor ``x``: the model code
    takes its mesh path (:func:`on_local_shards`) only then."""
    if _SHARD_CTX is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous. A local shard's
    gradient comes back wrapped in its DTensor's global (contiguous)
    layout; a transposed local gradient under it makes the backward's
    next view fail ("view size is not compatible", whisper-small's train
    step on 2 x 16 x 16)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> torch.Tensor:
        return grad.contiguous()


def on_local_shards(fn: Any, out_placements: Any, *args: Any) -> Any:
    """``fn(*args)`` run on each device's local shards, as DTensor's
    ``local_map`` runs it: every DTensor among ``args`` goes in as its
    local tensor (plain tensors go in as they are, replicated), and each
    tensor leaf of ``fn``'s result becomes a DTensor placed by the
    matching entry of ``out_placements`` (a placements tuple, or a tree of
    them shaped like the result). For a computation that needs no
    communication once its inputs are placed, e.g. attention with the
    batch over ``data`` and heads (or the query's sequence) over
    ``model``: DTensor would otherwise lower it op by op, and torch 2.11
    refuses the ``bmm`` lowering of an einsum that flattens two sharded
    dims. An input replicated over a mesh dim that splits another input
    takes a partial gradient on that dim, since each device's shard
    contributes its share."""
    from torch.distributed.tensor import DTensor, Partial
    from torch.utils import _pytree as pytree

    dtensors = [a for a in args if isinstance(a, DTensor)]
    if any(p.is_partial() for a in dtensors for p in a.placements):
        raise ValueError("on_local_shards needs its inputs reduced: a partial local shard "
                         "is not the input's value")
    mesh = dtensors[0].device_mesh
    split = {i for a in dtensors for i, p in enumerate(a.placements) if p.is_shard()}

    def local(a: Any) -> Any:
        if not isinstance(a, DTensor):
            return a
        grads = tuple(Partial() if i in split and p.is_replicate() else p
                      for i, p in enumerate(a.placements))
        # contiguous both ways: DTensor wraps a local gradient in the
        # input's global layout, so the two must agree
        return _ContiguousGrad.apply(a.contiguous().to_local(grad_placements=grads))

    def place(t: torch.Tensor, placements: tuple) -> torch.Tensor:
        # the global shape and a contiguous layout given: inferred from a
        # local shard with a dim of size 1, DTensor's strides are wrong
        shape = list(t.shape)
        for p, n in zip(placements, mesh.shape):
            if p.is_shard():
                shape[p.dim] *= n
        stride = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * shape[d + 1]
        return DTensor.from_local(t.contiguous(), mesh, placements, run_check=False,
                                  shape=torch.Size(shape), stride=tuple(stride))

    out = fn(*(local(a) for a in args))
    leaves, spec = pytree.tree_flatten(out)
    placed = pytree.tree_leaves(out_placements, is_leaf=lambda t: isinstance(t, tuple)
                                and all(not isinstance(p, tuple) for p in t))
    if len(placed) != len(leaves):
        raise ValueError(f"{len(leaves)} outputs but {len(placed)} placements")
    return pytree.tree_unflatten([place(t, p) for t, p in zip(leaves, placed)], spec)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class _ReducePartial(torch.autograd.Function):
    """DTensor ``x`` with its partial sums reduced (all-reduce); the
    gradient passes back in the output's placements, replicated where
    ``x`` was partial. (DTensor's own redistribution would hand back a
    partial gradient, and every product of the backward would then run
    at full width on each device.)"""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import Replicate

        return x.redistribute(x.device_mesh, tuple(Replicate() if p.is_partial() else p
                                                   for p in x.placements))

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import Replicate

        target = tuple(Replicate() if p.is_partial() else p for p in grad.placements)
        return grad if tuple(grad.placements) == target else grad.redistribute(
            grad.device_mesh, target)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """On a mesh, ``x`` with every partial sum reduced (its shards kept):
    a norm's input, as XLA reduces a contraction's partial sum (the
    residual stream after a row-parallel product) before a non-linear op.
    Left to DTensor, torch 2.13 reduce-scatters it over the sequence
    instead, and the next product then flattens (batch, sequence) with
    both sharded. A no-op for a plain tensor and without a context."""
    if not is_sharded(x) or not any(p.is_partial() for p in x.placements):
        return x
    return _ReducePartial.apply(x)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x = reduce_partial(x)
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.to(torch.float32))).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x = reduce_partial(x)
    dtype = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(dtype)


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
    # torch.full builds the base on the device; torch.tensor would copy it
    # from the host, and that copy synchronises the stream
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
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
    axes = _qkv_axes(cfg, s)
    if axes is not None:   # on a mesh, place the flat features so the head split divides
        q, k, v = (constrain(t, a[:3]) for t, a in zip((q, k, v), axes))
    q = q.reshape(bsz, s, cfg.num_heads, hd)
    k = k.reshape(bsz, s, cfg.num_kv_heads, hd)
    v = v.reshape(bsz, s, cfg.num_kv_heads, hd)
    if cfg.use_rope:
        cos, sin = rope_table(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return constrain_heads_qkv(q, k, v, cfg)


def sinusoidal_positions(s: int, d: int, dtype: torch.dtype, device: Any) -> torch.Tensor:
    """Classic transformer sinusoidal table (whisper-style encoders),
    (s, d): computed in float64 numpy and then cast, as the reference's."""
    pos = np.arange(s)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table).to(device=device, dtype=dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """The masked softmax: q (b,s,H,hd); k,v (b,t,KV,hd); mask: True =
    attend, broadcast against the (b,KV,G,s,t) scores -> (b,s,H*hd)."""
    bsz, s, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(bsz, s, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(bsz, s, H * hd)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
          cfg: B.ModelConfig) -> torch.Tensor:
    """q: (b,s,H,hd); k,v: (b,t,KV,hd); mask: True = attend, broadcast
    against the (b,KV,G,s,t) scores — (s,t), or (b,1,1,1,t) from decode.

    On a mesh (a sharding context and DTensor inputs) q, k and v are
    placed by :func:`_qkv_axes` and each device attends over its own
    shards, with no communication: the batch splits over ``data`` and the
    heads, or q's sequence (then with the mask's rows), over ``model``. A
    sequence-sharded output is moved to features over ``model`` (heads
    outermost, as the heads-sharded case leaves it), so the output
    projection flattens (b, s) with only the batch sharded."""
    if not is_sharded(q):
        return _attend(q, k, v, mask)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    q, k, v = constrain_heads_qkv(q, k, v, cfg)
    mesh = _SHARD_CTX[0]
    seq_dims = [i for i, p in enumerate(q.placements) if p == Shard(1)]
    if isinstance(mask, DTensor):
        mask = constrain(mask, (B.BATCH,) + (None,) * (mask.ndim - 1))
    elif seq_dims and mask.shape[-2] > 1:   # each device keeps its queries' rows
        rows = tuple(Shard(mask.ndim - 2) if i in seq_dims else Replicate()
                     for i in range(mesh.ndim))
        mask = DTensor.from_local(mask, mesh, (Replicate(),) * mesh.ndim,
                                  run_check=False).redistribute(mesh, rows)
    out = on_local_shards(_attend, tuple(q.placements), q, k, v, mask)
    return constrain(out, (B.BATCH, None, B.Q_FEAT)) if seq_dims else out


def sdpa_or_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: B.ModelConfig, *,
                  causal: bool, window: Optional[int]) -> torch.Tensor:
    """Full-sequence attention; q (b,s,H,hd), k,v (b,t,KV,hd) -> (b,s,H*hd).

    Routes to the flash-attention kernel for CUDA tensors when
    ``s % 128 == 0`` and ``t % 128 == 0`` (the reference's condition,
    ``layers.py:276-280``), to the masked softmax otherwise. The kernel
    takes (B,heads,S,hd) contiguous tensors, so q, k and v are copied to
    that layout and the output copied back."""
    bsz, s, H, hd = q.shape
    t = k.shape[1]
    if q.device.type == "cuda" and s % DEFAULT_BLOCK_Q == 0 and t % DEFAULT_BLOCK_K == 0:
        out = flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), causal=causal, window=window)
        return out.transpose(1, 2).reshape(bsz, s, H * hd)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = (j <= i) if causal else torch.ones((s, t), dtype=torch.bool, device=q.device)
    if window is not None:
        mask = mask & (i - j < window)
    return _sdpa(q, k, v, mask, cfg)


def attn_forward(x: torch.Tensor, p: dict[str, torch.Tensor], cfg: B.ModelConfig, *,
                 causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Training / prefill attention over a full sequence."""
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = sdpa_or_flash(q, k, v, cfg, causal=causal, window=window)
    return out @ p["wo"].to(x.dtype)


# -- decode caches -------------------------------------------------------------

def init_full_cache(cfg: B.ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                    device: Any) -> dict[str, torch.Tensor]:
    kvf = cfg.kv_feat
    return {
        "k": torch.zeros((batch, max_len, kvf), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kvf), dtype=dtype, device=device),
    }


def init_window_cache(cfg: B.ModelConfig, batch: int, window: int, dtype: torch.dtype,
                      device: Any) -> dict[str, torch.Tensor]:
    kvf = cfg.kv_feat
    return {
        "k": torch.zeros((batch, window, kvf), dtype=dtype, device=device),
        "v": torch.zeros((batch, window, kvf), dtype=dtype, device=device),
        # absolute positions stored, -1 = empty
        "pos": torch.full((batch, window), -1, dtype=torch.int32, device=device),
    }


def attn_decode(x: torch.Tensor, p: dict[str, torch.Tensor], cache: dict[str, torch.Tensor],
                pos: int, cfg: B.ModelConfig, *,
                window: Optional[int] = None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token decode step. x: (b, 1, d); pos: the current index.

    Full cache: writes k/v at ``pos`` and attends over [0, pos]. Window
    cache: writes at ``pos % window`` (rolling) and attends over the
    stored absolute positions — O(window) memory for any context length.
    A write index past the cache is clamped to its last slot, as
    ``lax.dynamic_update_slice`` clamps it.

    Unlike the reference, which returns new arrays, this writes the new
    k/v (and position) into ``cache``'s tensors in place and returns the
    same dict.
    """
    bsz, one, _ = x.shape
    if one != 1:
        raise ValueError(f"decode takes one token per sequence, got {one}")
    hd = cfg.resolved_head_dim
    positions = torch.full((bsz, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(x, p, cfg, positions)
    kvf = cfg.kv_feat
    t = cache["k"].shape[1]
    slot = min(pos if window is None else pos % window, t - 1)
    cache["k"][:, slot] = k_new.reshape(bsz, kvf).to(cache["k"].dtype)
    cache["v"][:, slot] = v_new.reshape(bsz, kvf).to(cache["v"].dtype)
    if window is None:
        mask = (torch.arange(t, device=x.device) <= pos)[None, None, None, None, :]
    else:
        cache["pos"][:, slot] = pos
        pc = cache["pos"]
        valid = (pc >= 0) & (pc <= pos) & (pos - pc < window)
        mask = valid[:, None, None, None, :]                  # (b,1,1,1,w)
    k_all, v_all = cache["k"], cache["v"]
    axes = _qkv_axes(cfg, 1)
    if axes is not None:   # on a mesh, read the cache so the head split divides
        k_all, v_all = constrain(k_all, axes[1][:3]), constrain(v_all, axes[2][:3])
    k_all = k_all.reshape(bsz, t, cfg.num_kv_heads, hd).to(x.dtype)
    v_all = v_all.reshape(bsz, t, cfg.num_kv_heads, hd).to(x.dtype)
    out = _sdpa(q, k_all, v_all, mask, cfg)
    return out @ p["wo"].to(x.dtype), cache


# -- cross attention (enc-dec) --------------------------------------------------

def cross_attn_forward(x: torch.Tensor, memory: Optional[torch.Tensor],
                       p: dict[str, torch.Tensor], cfg: B.ModelConfig,
                       kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Decoder cross-attention. q from ``x`` (b,s,d); k/v from ``memory``
    (b,t,d), or from precomputed ``kv`` (decode path). No mask, no rope.
    Returns (out, (k, v)) so prefill can cache the projected memory."""
    bsz, s, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    # on a mesh, the features are placed so that the head split divides
    q = constrain_for_heads(x @ p["wq"].to(x.dtype), H).reshape(bsz, s, H, hd)
    if kv is None:
        t = memory.shape[1]
        k = constrain_for_heads(memory @ p["wk"].to(x.dtype), KV).reshape(bsz, t, KV, hd)
        v = constrain_for_heads(memory @ p["wv"].to(x.dtype), KV).reshape(bsz, t, KV, hd)
    else:
        k, v = kv
    mask = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k.to(x.dtype), v.to(x.dtype), mask, cfg)
    return out @ p["wo"].to(x.dtype), (k, v)


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
    x = torch.nn.functional.embedding(tokens, p["embedding"].to(dtype))
    # on a mesh a vocab-sharded table gives a masked partial sum, which
    # DTensor can reduce only once: reduce it, then place it as a (batch,
    # seq, embed) activation (no-ops outside a sharding context). In its
    # own step the reduction hands the gradient back replicated: the
    # residual stream's gradient can arrive as a plain partial sum, which
    # DTensor cannot turn into a masked one.
    return constrain(reduce_partial(x), (B.BATCH, None, B.EMBED))


def lm_logits(x: torch.Tensor, p: dict[str, torch.Tensor]) -> torch.Tensor:
    x = rms_norm(x, p["final_norm"])
    return x @ p["lm_head"].to(x.dtype)


# ---------------------------------------------------------------------------
# LoRA adapters (parameter-efficient payloads)
# ---------------------------------------------------------------------------

def _lora_eligible(pd: ParamDef, rank: int) -> bool:
    if len(pd.shape) != 2:
        return False
    m, n = pd.shape
    return rank <= min(m, n) and rank * (m + n) < m * n


def lora_adapter_spec(spec: dict[str, Any], rank: int) -> dict[str, Any]:
    """The adapter ParamDef tree for a base parameter spec: every
    eligible 2-D matrix (rank fits, factors beat the dense form) maps to
    an ``{"a", "b"}`` factor pair carrying the base spec's axes on its
    outer dims. ``b`` is zero-initialized, so a fresh adapter contributes
    an exactly-zero delta (standard LoRA init). Norms, biases and stacked
    (3-D) tensors are left out."""
    out: dict[str, Any] = {}
    for k, v in spec.items():
        if isinstance(v, ParamDef):
            if _lora_eligible(v, rank):
                m, n = v.shape
                out[k] = {
                    "a": ParamDef((m, rank), (v.axes[0], None)),
                    "b": ParamDef((rank, n), (None, v.axes[1]), init="zeros"),
                }
        else:
            sub = lora_adapter_spec(v, rank)
            if sub:
                out[k] = sub
    return out


def lora_adapter_params(
    generator: torch.Generator, spec: dict[str, Any], rank: int,
    dtype: torch.dtype = torch.float32, alpha: Optional[float] = None,
) -> dict[str, Any]:
    """Native-adapter mode: trainable LoRA pairs as a **flat** dict of
    :class:`~repro_torch.peft.lowrank.LowRankDelta` on ``generator``'s
    device, keyed by the base parameter's ``/``-joined path (the
    reference's keys). ``a`` is drawn from ``generator`` through
    :func:`build_params`; ``b`` is zeros. Clients put these straight into
    a Task Result payload: the ``lowrank`` wire kind and ``lora-fedavg``
    handle them as they do stage-decomposed deltas."""
    pairs = build_params(generator, lora_adapter_spec(spec, rank), dtype, generator.device)
    alpha_f = float(alpha) if alpha is not None else float(rank)
    out: dict[str, Any] = {}

    def walk(base_node: dict[str, Any], pair_node: dict[str, Any], path: str) -> None:
        for k, pair in pair_node.items():
            p = f"{path}/{k}" if path else k
            base = base_node[k]
            if isinstance(base, ParamDef):
                out[p] = LowRankDelta(pair["a"], pair["b"], alpha_f, rank,
                                      tuple(base.shape), numpy_dtype(pair["a"].dtype))
            else:
                walk(base, pair, p)

    walk(spec, pairs, "")
    return out


def merge_lora(params: dict[str, Any], adapters: dict[str, Any]) -> dict[str, Any]:
    """Fold adapter deltas into a flat base state dict:
    ``params[name] + (alpha/rank) * a @ b`` per adapter entry (on the base
    tensor's device), other entries untouched. The result dtype follows
    the base parameters."""
    out = dict(params)
    for name, delta in adapters.items():
        base = out[name]
        out[name] = base + delta.to_dense(base.device).to(base.dtype)
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   z_loss: float = 0.0) -> torch.Tensor:
    """Cross-entropy with optional z-loss; labels < 0 are masked."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None])
    # on a mesh, reduce a vocab-sharded gather's masked partial while it
    # still has its index's shape (a no-op outside a sharding context)
    gold = constrain(gold, (B.BATCH, None, None))[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
