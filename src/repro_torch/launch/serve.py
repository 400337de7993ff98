"""Batched serving entry point: prefill a batch of prompts, then greedy-decode.

Mirror of ``src/repro/launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Runs on the card unless ``--device`` names another device; without CUDA
and without ``--device`` it raises. On the card a prompt whose length is
a multiple of 128 prefills through the flash-attention kernel (e.g.
``--arch llama3.2-1b --prompt-len 512``); decode steps attend over the
cache with the masked softmax. For ``--arch xlstm-125m`` a prompt of any
length runs each sLSTM layer's recurrence through the sLSTM-scan kernel
(e.g. ``--prompt-len 1024``), and decoding continues from the state the
prefill returns. Every architecture of ``--arch`` serves: the
encoder-decoder (``whisper-small``) is given zero frame embeddings and
the VLM (``phi-3-vision-4.2b``) zero patch embeddings, as the reference's
``main`` gives them.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import create_model
from repro_torch.models.transformer import DecoderLM
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.device import resolve_device


def _pick(logits: torch.Tensor, greedy: bool,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """logits (b, 1, vocab) -> next tokens (b, 1) int32. Greedy takes the
    first index of a tie, as ``jnp.argmax`` does."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits[:, 0].to(torch.float32), dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def generate(model: Any, params: dict[str, Any], prompts: torch.Tensor, *, gen_len: int,
             extra: Optional[dict[str, Any]] = None, greedy: bool = True,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompts: (B, P) integer tensor -> (B, P + gen_len) int32 tokens.

    The reference's algorithm: prefill the prompt (with ``extra``'s
    ``frames`` for an encoder-decoder, or ``patches`` for a VLM, as the
    prefill's third argument); for a full-attention ``DecoderLM`` discard
    the prefill's cache (sized to the prompt) and replay the prompt token
    by token into a (P + gen_len) cache; every other model decodes on
    from the prefill's cache or state. Two quirks of the reference follow,
    and are kept (ROADMAP C10, C11): a VLM's replay holds the text prompt
    only, so the patches never reach the decode cache and decode positions
    restart at 0; and an encoder-decoder's self-attention cache is sized
    to the prompt, so each decode step writes into its last slot (so does
    a window cache when the prompt is shorter than the window).
    ``greedy=False`` samples from the softmax with ``generator``, a
    ``torch.Generator`` on the prompts' device (its draws are not
    ``jax.random.categorical``'s). Runs under
    ``torch.inference_mode``. With tracing on, the spans ``serve.prefill``,
    ``serve.replay`` and ``serve.decode`` time the three phases."""
    if not greedy and generator is None:
        raise ValueError("greedy=False needs a torch.Generator")
    bsz, P = prompts.shape
    prompts = prompts.to(torch.int32)
    with torch.inference_mode():
        with obs_trace.span("serve.prefill", "serve", batch=bsz, prompt=P):
            if extra:
                frames = extra.get("frames")
                arg = frames if frames is not None else extra.get("patches")
                logits, cache = model.prefill(params, prompts, arg)
            else:
                logits, cache = model.prefill(params, prompts)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        if isinstance(model, DecoderLM) and model.cfg.sliding_window is None:
            with obs_trace.span("serve.replay", "serve", steps=P):
                cache = model.init_cache(bsz, P + gen_len, prompts.device)
                for t in range(P):
                    logits, cache = model.decode_step(params, cache, prompts[:, t:t + 1], t)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [prompts]
        with obs_trace.span("serve.decode", "serve", steps=max(gen_len - 1, 0)):
            for i in range(gen_len):
                out.append(tok)
                if i == gen_len - 1:
                    break
                logits, cache = model.decode_step(params, cache, tok, P + i)
                tok = _pick(logits, greedy, generator)
        return torch.cat(out, dim=1)


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be present)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.with_overrides(remat=False)
    model = create_model(cfg)
    params = model.init(0, device)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)
    extra = None
    if cfg.family == "encdec":
        extra = {"frames": torch.zeros((args.batch, cfg.encoder_seq, cfg.d_model),
                                       dtype=torch.float32, device=device)}
    if cfg.family == "vlm":
        extra = {"patches": torch.zeros((args.batch, cfg.num_patches, cfg.d_model),
                                        dtype=torch.float32, device=device)}
    t0 = time.time()
    tokens = generate(model, params, prompts, gen_len=args.gen, extra=extra)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"generated {tuple(tokens.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(tokens[0, -args.gen:].cpu().numpy())


if __name__ == "__main__":
    main()
