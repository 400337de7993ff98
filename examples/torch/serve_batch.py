"""Batched serving example on the PyTorch port: prefill + greedy decode
with a KV cache for a dense arch, and O(1)-state decode for the
recurrent archs — the serve path the decode_32k / long_500k dry-run
shapes count.

The models run at smoke width on ``--device`` (the card by default),
seeded through a ``torch.Generator``; xlstm-125m's prefill runs its
sLSTM layers through the hand-written scan kernel there. The prompts are
drawn with numpy from seed 0, as ``examples/serve_batch.py`` draws them.

    PYTHONPATH=src python examples/torch/serve_batch.py
    PYTHONPATH=src python examples/torch/serve_batch.py --device cpu
"""
import argparse
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import create_model
from repro_torch.utils.device import resolve_device

ARCHS = ("qwen1.5-0.5b", "xlstm-125m", "recurrentgemma-2b")
BATCH, PROMPT_LEN, GEN_LEN = 4, 16, 12


def build(arch: str) -> Any:
    """``arch``'s model at smoke width, remat off (the example serves)."""
    return create_model(get_smoke_config(arch).with_overrides(remat=False))


def serve(arch: str, device: Any, params: Optional[dict[str, Any]] = None) -> torch.Tensor:
    """Greedy-generate ``GEN_LEN`` tokens after seeded prompts for
    ``arch`` at smoke width, from ``params`` (default: ``model.init(0)``
    on ``device``); prints the reference's line and returns the tokens."""
    device = resolve_device(device)
    model = build(arch)
    cfg = model.cfg
    if params is None:
        params = model.init(0, device)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN)))
    prompts = prompts.to(device=device, dtype=torch.int32)
    t0 = time.time()
    out = generate(model, params, prompts, gen_len=GEN_LEN)
    head = out[0, PROMPT_LEN:PROMPT_LEN + 8].cpu().numpy()     # synchronises the card
    dt = time.time() - t0
    state_kind = {"ssm": "O(1) recurrent state", "hybrid": "O(window) hybrid state"}.get(
        cfg.family, "KV cache"
    )
    print(f"{arch:20s} [{state_kind:22s}] generated {out.shape[1]-PROMPT_LEN} tokens x "
          f"{out.shape[0]} seqs in {dt:.1f}s -> {head}")
    return out


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the models (default: cuda; cpu on request)")
    device = resolve_device(ap.parse_args(argv).device)
    for arch in ARCHS:
        serve(arch, device)


if __name__ == "__main__":
    main()
