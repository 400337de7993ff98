"""Single-program training driver (centralized, or one FL site's local
trainer). Mirror of ``src/repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 20 --batch 8 --seq 96 --smoke --device cpu

It runs on the card unless ``--device`` names another device, and raises
without CUDA; on CUDA it turns TF32 off, so training runs in fp32 like the
reference. ``make_train_step`` takes the loss and its gradients through
autograd, reads the schedule's lr at the optimizer's step *before* the
update (step 0 trains at lr 0, as the reference's does) and updates the
parameters in place (``optim/adamw.py``). ``train_loop`` has the
reference's cosine schedule (warmup ``max(steps // 10, 1)``), data (one
``SyntheticLMDataset.sample`` a step) and log line. With tracing on
(``obs.trace.activate`` with a tracer that synchronises), a span
``train.step`` covers each step.

Where training cannot go on the card (ROADMAP C13, reference-side and
mirrored): the flash-attention kernel has no gradient, as the
reference's Pallas kernel has none (``jax.grad`` through it fails).
``layers.sdpa_or_flash`` sends full-sequence attention to the kernel when
both lengths are multiples of 128, so at such a length a step on the
card raises ``NotImplementedError`` in the backward, as the reference's
training fails on its TPU at its default ``--seq 128``. For a VLM the
length counts the ``num_patches`` patch embeddings: 576 patches + 64 or
+ 192 tokens route to the kernel. Other lengths train through the
masked softmax.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import create_model
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.utils.device import disable_tf32, resolve_device
from repro_torch.utils.trees import params_from_flat, tree_leaves


def make_train_step(model: Any, schedule: Any):
    def train_step(params: Any, opt_state: Any, batch: dict[str, torch.Tensor]):
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        lr = schedule(opt_state.step)
        params, opt_state, info = adamw_update(params, list(grads), opt_state, lr)
        detached = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**detached, "loss": loss.detach(), **info}

    return train_step


def train_loop(
    cfg: Any,
    *,
    steps: int,
    batch_size: int,
    seq_len: int,
    lr: float = 3e-4,
    seed: int = 0,
    dataset: Optional[SyntheticLMDataset] = None,
    params: Optional[Any] = None,
    log_every: int = 10,
    extra_batch: Optional[dict[str, np.ndarray]] = None,
    device: Any = None,
) -> tuple[Any, list[float]]:
    """``steps`` AdamW steps of ``cfg``'s model on ``device``. ``params``
    is the model's nested tensors (trained in place), or a flat state
    dict of tensors or of numpy arrays (the reference's weights, through
    ``from_reference_state``); ``None`` draws them from ``seed``. Returns
    the parameters and the loss of each step."""
    device = resolve_device(device)
    if device.type == "cuda":
        disable_tf32()
    model = create_model(cfg)
    if params is None:
        params = model.init(seed, device)
    elif not any(isinstance(v, dict) for v in params.values()):
        params = params_from_flat(model, params, device)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt_state = adamw_init(params)
    schedule = cosine_schedule(lr, warmup_steps=max(steps // 10, 1), total_steps=steps)
    step_fn = make_train_step(model, schedule)
    dataset = dataset or SyntheticLMDataset(cfg.vocab_size, seq_len, seed=seed)
    extra = {k: torch.as_tensor(v, device=device) for k, v in (extra_batch or {}).items()}
    history = []
    for step in range(steps):
        batch = {k: torch.as_tensor(v, device=device).long()
                 for k, v in dataset.sample(batch_size).items()}
        batch.update(extra)
        t0 = time.time()
        with obs_trace.span("train.step", "train", step=step):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
        history.append(loss)
        if log_every and step % log_every == 0:
            print(f"step {step:4d} loss {loss:.4f} ({(time.time()-t0)*1e3:.0f} ms)")
    return params, history


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be present)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    extra = None
    if cfg.family == "encdec":
        extra = {"frames": np.zeros((args.batch, cfg.encoder_seq, cfg.d_model), np.float32)}
    if cfg.family == "vlm":
        extra = {"patches": np.zeros((args.batch, cfg.num_patches, cfg.d_model), np.float32)}
    _, history = train_loop(
        cfg,
        steps=args.steps,
        batch_size=args.batch,
        seq_len=args.seq,
        lr=args.lr,
        extra_batch=extra,
        device=args.device,
    )
    print(f"final loss: {history[-1]:.4f} (start {history[0]:.4f})")


if __name__ == "__main__":
    main()
