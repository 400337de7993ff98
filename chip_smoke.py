#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out report.json]

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with nvcc (one compiler per source, in parallel, beside a small probe of the
tensor cores' mma.sync rates), reads the built library's SASS (``cuobjdump``)
for the redesigned kernels' mechanisms — tf32 and bf16 mma.sync and cp.async
in flash attention, the cluster barrier in the sLSTM scan — and holds each
kernel against
its plain PyTorch version on the card at the main paths' shapes, timing
both: quantize over one message's fused group, dequantize and the fold over
the largest item. Then it drives two full-width llama3.2-1b federated
rounds through ``repro_torch.fl.job``, each with two clients taking two
AdamW steps:

1. blockwise8 downlink, blockwise8 + crc32 uplink, streaming int8 fold
   (``quantized-fedavg``);
2. nf4 downlink, nf4 + crc32 uplink, dense ``fedavg`` on the server
   (``examples/jobs/wire_pipeline.json`` at full width, ``zlib`` left out).

For each round it zeroes the launch counters, reads them after, and checks
that every kernel of that path launched as often as the path implies, that
losses and weights are finite and that every tensor moved. Smoke-width
federations of both paths on the card agree with the same federations on
the CPU (``wire_pipeline.json`` as it stands, ``zlib`` and 2 rounds).

Then the paper's filter form of two-way quantization
(``examples/jobs/legacy_quantized.json``: a QuantizeFilter at both egress
points, a DequantizeFilter at both ingress points, dense ``fedavg``): one
full-width round in ``container`` and one in ``regular`` transmission
from the same weights, counters zeroed before each (one B1 launch per item
per egress, one B2 per item per ingress), bitwise-equal final weights and
a larger MemoryMeter peak for regular; the spec at smoke width on the card
against the CPU, and ``python -m repro_torch.fl.job`` on the spec file.
Then the async runtime (``repro_torch.runtime``) at full width:
``examples/jobs/streaming_aggregation.json`` with qwen1.5-0.5b at its
published widths (FedBuff, 3 clients, 6 tasks, buffer 2, 3 in flight, a
hetero fiber/lte network, nf4 downlink with per-layer rules, blockwise8 +
crc32 uplink folded at each completion instant; ``zlib`` dropped), the
counters zeroed before and checked after against the launches the path
implies (B1 twice a dispatch, B4 a downlink, B5 a downlinked nf4 item,
B2 an uplinked item, no B3), with 6 completions and 3 model updates;
both async example specs as they stand at smoke width on the card
against the CPU (fixed updates identical, trained within the stated
bound); secure aggregation's masked grids and mean card vs CPU; and
``python -m repro_torch.fl.job`` on ``streaming_aggregation.json``.
Then the LoRA plane: every full-width llama3.2-1b item the ``lora`` stage
decomposes checked (the uplink encoded twice to the same bytes, canonical
signs, the kept singular values against a float64 eigensolve of the
item's Gram matrix, fidelity against the discarded singular mass, the
SVD time of each); ``examples/jobs/lora_federation.json`` at full width
(4 clients, 2 rounds, as it stands) — both of these at 2 of the model's
16 layers (``LORA_LAYERS``: time) — the counters zeroed before and
checked after (one B4 and one B5 a leftover item an uplink, nothing
else), with the factor bytes the shapes imply and the merge time of each
item, then B4 and B5 bitwise against their plain versions on the very
values the path quantized; the spec as it stands card vs CPU with two
forms of fixed updates (Gaussian, and with a well-separated rank-8 part)
and through ``python -m repro_torch.fl.job``; and ``topk`` and ``bf16``
on one full-width item,
card vs CPU bitwise (and what torch's own card cast gives for NaNs).
Then the paper's Table II on the card (the full-width state through
``QuantizeFilter`` in fp16, blockwise8, nf4 and fp4, serialized bytes
against the byte model and the paper) and Table III on its host (the
full-width blockwise8 message sent regular, container and file over the
loopback driver at 1 MiB chunks, MemoryMeter peaks ordered regular >
container > file, with VmHWM, the host's RAM and the free disk).

Then the serving path (``repro_torch.launch.serve.generate``): the
flash-attention kernel against its plain version on every case of
``kernels.cases.ATTENTION_CASES`` and at the two serving shapes, timed
beside PyTorch's ``scaled_dot_product_attention``, with its fp32 bound, the
bound of its own tensor-core arithmetic and its TFLOP/s; full-width llama3.2-1b
served twice — full attention at batch 4, prompt 512, and the reference's
long-context variant (``sliding_window`` 4096) at batch 1, prompt 8192 —
each with the counters zeroed before and exactly one flash launch per
layer of the prefill after; smoke-width serving on the card against the
CPU; and a backward through the kernel, which must raise.

Then every other model family through ``launch.serve.generate`` at full
width with seeded weights: recurrentgemma-2b (RG-LRU hybrid, uncut: batch
1, prompt 4096, 8 local-attention layers at hd 256), phi-3-vision-4.2b
(uncut: 576 zero patches + 64 tokens at batch 2, hd 96), whisper-small
(uncut: 1,500 zero frames, batch 4 x 128), dbrx-132b (MoE at its full
widths, 2 of its 40 layers: batch 1 x 512) and granite-8b (uncut: batch
4 x 512), each with the counters zeroed before and exactly its B7
launches after (8 / 32 / 12 / 2 / 36), finite logits and caches, the
spans and the device peak; B7 is held against its plain version and
timed at each run's prefill shape (the build's ptxas lines give each
instantiation's registers and spills; for the wide kernel, hd 96 and 256,
the card's own occupancy query gives warps an SM, registers and local
bytes, which must be at least 8, and 0 with no ptxas spill); then the
eight new architectures (and recurrentgemma-2b at 5 layers) at smoke
width card vs CPU.

Then the mesh-view federated trainer (``repro_torch.launch.fl_train``): the
K-way dequantize-and-sum kernel against its plain version on every case of
``kernels.cases.agg_cases`` and at the collective's full shape (2 pods x the
flat full-width qwen1.5-0.5b delta), timed beside a one-call einsum; then
two ranks over gloo, both on this card, each take one full-width
qwen1.5-0.5b round with ``--agg int8``, one with ``--agg int8-bucket``
and one more with ``--agg int8`` (warm: the first run also pays one-time
costs), all from the same seeded weights, the launch counters zeroed
just before each round and read just after in each rank; the ranks must
end bitwise equal,
and on each rank's own delta the bucketed collective must equal the
unbucketed one bitwise; last, a smoke-width ``int8`` round on the card
against the same round on the CPU.

Then xLSTM serving (``launch.serve.generate`` on xlstm-125m): the sLSTM-scan
kernel against its plain version (h and the final state) on every case of
``kernels.cases.SLSTM_CASES`` and at xlstm-125m's width at batch 4 x 1024
steps and 1 x 8192, timed at both (us a step, with the cluster layout and
shared memory a CTA); full-width xlstm-125m served at batch
4, prompt 1024, 16 generated tokens, with the counters zeroed before and
exactly one sLSTM-scan launch per sLSTM layer (6) after; smoke-width
serving on the card against the CPU at a prompt of 200 (every prefill
length goes through the kernel); and a backward through the kernel, which
must raise.

Last, the live plane (``repro_torch.launch.federation``) over real TCP
on 127.0.0.1: (A) ``examples/jobs/live_smoke.json`` at full width, 2
clients of 4 and 1 round of 2, through ``run_live_federation(...,
spawn=False)`` with the clients on threads of this script (taking turns
to train), the counters zeroed before and read after (one B1 an uplink;
the spec's dense ``fedavg`` dequantizes every item, one B2 each), the
device peak, the walls by phase, and the weights bitwise ``run_job``'s;
(B) ``examples/jobs/chaos_federation.json`` at full width, 2 clients of 4
and 2 rounds of 3, site-1 behind its own ChaosProxy with the spec's stall
plan, the launches derived from the server's grant log and the weights
bitwise ``reference_run``'s over the recorded contributor sets; (C) both
specs as they stand through ``python -m repro_torch.launch.federation``
with subprocess clients on the card (``--verify-sim``,
``--verify-chaos``), and live_smoke.json with fixed updates card vs CPU;
(D) full-width checkpoints in blockwise8 and nf4 (B1/B2, B4/B5 one an
item; files bitwise the ones the CPU writes) and a ``--resume``.

Then the centralized trainer (``repro_torch.launch.train.train_loop``,
seed 0, 4 steps, TF32 off, each step's loss logged): (T1) full-width
llama3.2-1b at batch 4 x 192, xlstm-125m at 4 x 192, whisper-small at 4 x
192 with 1,500 zero frames and recurrentgemma-2b at 1 x 192, all uncut,
each with the counters zeroed before and no kernel launched after (every
length takes the masked softmax: B7 has no gradient, ROADMAP C13), finite
losses, every leaf moved, step ms (the ``train.step`` spans, median of
steps 1-3), tokens/s and the device peak; llama3.2-1b once more with
remat off, its peak and step beside remat on's; (T2) one family each
(dense, MoE, VLM, ssm, hybrid, enc-dec) at smoke width, the first
gradient leaf by leaf and three steps card vs CPU from the same weights
within the CPU tests' tolerances; (T3) a
smoke-width step at seq 128, which routes attention to B7 and must raise
NotImplementedError in the backward; (T4) the first path's spec with
xlstm-125m at full width (B1, B2 and B3 as its 33 items imply) and the
xlstm-125m and recurrentgemma-2b smoke specs with fixed updates card vs
CPU, bitwise.

Before the trainer, (E1) the port's five examples (``examples/torch``:
quickstart, streaming_demo, async_federation, hetero_federation,
serve_batch) run on the card, each against its own CPU run in this
process from the same weights (the federations at ``EXAMPLE_ROUNDS``
rounds on both sides alike): async and hetero print the same bytes,
streaming the same MemoryMeter peaks, nf4 checkpoint bytes and error,
serve_batch the same greedy tokens, quickstart the same message count
with losses and wire bytes within the CPU test's bounds. Each prints its
card and CPU seconds and its B1/B2/B4/B5/B8 launches, counted from zero;
every kernel an example implies must have launched.

Last (R1), the roofline of five of those full-width steps: each is
dry-run on the meta device (``repro_torch.launch.dryrun``: the same
arch, shape, fp32 and TF32 off, one chip, the peaks of the card by its
name) — train_llama's and train_griffin's step, serve_dense8b's prefill
and one decode step, serve_full's prefill — and its counted FLOPs and
bytes, compute and memory seconds, bottleneck, meta peak (beside the
run's ``max_memory_allocated``) and share = max(compute_s, memory_s) /
the measured seconds are printed; a share above 1.05 fails (the count
would be wrong). Then ``python -m repro_torch.launch.dryrun --all`` at one
chip and the pairs of ``ROOFLINE_MESH_PAIRS`` on the (16, 16) mesh over a
fake process group (one from each class torch 2.11 refused before the
repair, and granite-8b's decode), a line a pair, timed; every one must
count. They run on the host's CPU in subprocesses started before (E1),
beside the examples and the training phases, so T1's times are taken
while they run. (The whole ``--mesh 16x16`` sweep does not join in
``ROOFLINE_SWEEP_TIMEOUT_S`` beside them; it is a chip call of its own.)

``--svd-drivers`` also times both exact cuSOLVER SVD drivers (``gesvd``,
``gesvdj``) once on the largest decomposed item, the measurement that
chose ``ops.SVD_DRIVER``.

Output: the card, build and per-kernel lines, per-phase wall times, then
the card's name and power limit, one JSON line with every kernel's
numbers, and last ``{"ok": true, "device": {...}}``. Exits non-zero (and
prints no result) on any failure, without CUDA, or outside a checkout.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_OPS_PER_S,
    FP32_OPS_PER_S,
    HBM_BYTES_PER_S,
    TF32_OPS_PER_S,
)

#: the first path: examples/jobs/live_smoke.json at full width, quantized
#: downlink, int8 fold aggregator
SPEC = {
    "arch": "llama3.2-1b", "smoke": False, "rounds": 1, "clients": 2,
    "local_steps": 2, "batch": 4, "seq": 32, "partition": "iid",
    "pipeline": {"task_data_out": ["quantize:blockwise8"],
                 "task_result_out": ["quantize:blockwise8", "crc32"]},
    "aggregator": "quantized-fedavg", "server_streaming_agg": True,
    "transmission": "container", "driver": "loopback", "chunk_mb": 1, "seed": 0,
}
#: the second path: examples/jobs/wire_pipeline.json at full width, without
#: zlib (single-threaded deflate of an 843 MB message is host time) and with
#: 1 round instead of 2
SPEC_NF4 = {
    "arch": "llama3.2-1b", "smoke": False, "rounds": 1, "clients": 2,
    "local_steps": 2, "batch": 4, "seq": 32, "partition": "iid",
    "pipeline": {"task_data_out": ["quantize:nf4"],
                 "task_result_out": ["quantize:nf4", "crc32"]},
    "aggregator": "fedavg", "server_streaming_agg": False,
    "transmission": "container", "driver": "loopback", "chunk_mb": 1, "seed": 0,
}
WIRE_PIPELINE_JOB = os.path.join(REPO, "examples", "jobs", "wire_pipeline.json")
#: the third path: the paper's two-way filter scheme, run at full width with
#: 1 round of its 2 (time), in container and in regular transmission
LEGACY_JOB = os.path.join(REPO, "examples", "jobs", "legacy_quantized.json")
#: the fourth path: the async runtime (FedBuff, server-side streaming
#: aggregation) at full-width qwen1.5-0.5b, and both async example specs
#: at smoke width card vs CPU
ASYNC_JOB = os.path.join(REPO, "examples", "jobs", "streaming_aggregation.json")
ASYNC_HETERO_JOB = os.path.join(REPO, "examples", "jobs", "async_hetero_pipeline.json")
#: the fifth path: the LoRA plane, examples/jobs/lora_federation.json at
#: full-width llama3.2-1b, its 4 clients and 2 rounds uncut
LORA_JOB = os.path.join(REPO, "examples", "jobs", "lora_federation.json")
#: the sixth path: the live plane over real TCP, examples/jobs/live_smoke.json
#: and chaos_federation.json at full width, clients cut 4 -> 2 (memory: one
#: full-width AdamW step peaks at ~36 GB, so the clients take turns to train
#: and two fit beside the server on the 80 GB card), rounds cut 2 -> 1 and
#: 3 -> 2 (time: the script must stay under 1,000 s); and both at smoke
#: width as they stand through the command line
LIVE_JOB = os.path.join(REPO, "examples", "jobs", "live_smoke.json")
CHAOS_JOB = os.path.join(REPO, "examples", "jobs", "chaos_federation.json")
LIVE_CLIENTS = 2
LIVE_ROUNDS = 1
CHAOS_ROUNDS = 2
LIVE_TIMEOUT_S = 600.0
#: the SVD drivers ``--svd-drivers`` times on the path's largest
#: decomposed item (blocks.mlp.w_up / w_gate with their 16 layers collapsed)
SVD_SHAPE = (32768, 8192)
SVD_DRIVERS = ("gesvd", "gesvdj")
#: check (a): ||x - ab||^2 against the discarded singular mass, relative
#: to the kept mass
LORA_FIDELITY_TOL = 1e-3
#: check (a): each kept sigma_i against the float64 eigensolve's, in units
#: of eps sqrt(m n) sigma_1 (eps = 2^-24): Weyl's bound for an SVD whose
#: backward error is eps sqrt(m n) ||x||_2, the usual size of Householder
#: bidiagonalisation's (its worst case grows like m n). The card's gesvd
#: read 2.67 units of the smaller eps sqrt(max(m, n)) sigma_1 at (32768, 512)
LORA_SIGMA_TOL = 1.0
#: check (c): the full-width item that topk and bf16 run on, card vs CPU
TOPK_BF16_ITEM = "blocks.attn.wq"
TOPK_FRACTION = 0.01
#: secure aggregation card vs CPU: full-width qwen1.5-0.5b's stacked MLP
#: gate (69,206,016 values); with the embedding item as well, the host's
#: numpy mask draws made this check take about a minute
SECURE_AGG_SHAPES = {"blocks.mlp.w_gate": (24, 1024, 2816)}
N_ITEMS = 12                       # flat state-dict items of llama3.2-1b
LLAMA_PARAMS = 1_498_482_688       # parameters of full-width llama3.2-1b
#: Table II: the formats quantized on the card, and the paper's size of each
#: as a share of fp32 (paper Table II, as benchmarks/table2_message_size.py
#: records it: the 147-tensor layout, whose blockwise8 meta also counts a
#: 1 KiB code map per tensor)
TABLE2_FORMATS = ("fp16", "blockwise8", "nf4", "fp4")
PAPER_TABLE2_PCT = {"fp16": 50.00, "blockwise8": 25.03, "nf4": 14.06}
TABLE3_CHUNK = 1 << 20             # Table III's chunk: the paper's default, 1 MiB
LARGEST_ITEM = (16, 2048, 8192)    # blocks.mlp.w_gate / w_up
GROUP_BLOCKS = 365_841             # 4096-blocks of one message's fused group
GROUP_BLOCKS4 = 23_413_792         # 64-blocks of the same group (no padding)
CHUNK_BLOCKS4 = 1 << 21            # 64-blocks per plain-version comparison

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM_BYTES_PER_S,
# FP32_OPS_PER_S (outside the tensor cores), TF32_OPS_PER_S, BF16_OPS_PER_S,
# from the port's roofline table (imported at the top)

#: the serving runs: full-width llama3.2-1b, (label, sliding window,
#: batch, prompt, generated tokens); the window is the reference's
#: long-context serving variant (src/repro/launch/specs.py, SWA_WINDOW)
SERVE_RUNS = (("serve_full", None, 4, 512, 16), ("serve_window", 4096, 1, 8192, 16))
#: card (kernel) vs CPU (plain) serving at smoke width: logits and caches
#: within 1e-4 (fp32 matrix products and attention summed in other orders)
SERVE_CPU_TOL = 1e-4
#: the serving runs of the other families, full width with seeded weights:
#: (label, arch, batch, prompt, generated tokens, layers or None for the
#: published depth, the B7 launches of its prefill: one per attention layer
#: whose prefill length is a multiple of 128). recurrentgemma-2b: 8 local-
#: attention layers of its 26 (window 2048, hd 256, MQA); phi-3-vision: 576
#: zero patches + 64 tokens = 640 rows, hd 96; whisper-small: the decoder's
#: 12 self-attention layers (the encoder's 1,500 frames take the masked
#: softmax); dbrx-132b at its full widths but 2 of its 40 layers (the whole
#: model is 526 GB in fp32, 2 layers about 30 GB); granite-8b uncut (~33 GB)
FAMILY_SERVE_RUNS = (
    ("serve_griffin", "recurrentgemma-2b", 1, 4096, 16, None, 8),
    ("serve_vlm", "phi-3-vision-4.2b", 2, 64, 16, None, 32),
    ("serve_encdec", "whisper-small", 4, 128, 16, None, 12),
    ("serve_moe", "dbrx-132b", 1, 512, 8, 2, 2),
    ("serve_dense8b", "granite-8b", 4, 512, 16, None, 36),
)
#: the architectures of the last six families, served at smoke width card vs CPU
#: (recurrentgemma-2b also at 5 layers, so that its tail runs), at a
#: prefill of 128 rows (through the kernel on the card), 8 generated tokens
NEW_ARCHS = ("stablelm-1.6b", "dbrx-132b", "whisper-small", "llama4-scout-17b-a16e",
             "recurrentgemma-2b", "granite-8b", "phi-3-vision-4.2b", "qwen2.5-32b")
FAMILY_SMOKE = (*((a, a, {}) for a in NEW_ARCHS),
                ("recurrentgemma-2b-tail", "recurrentgemma-2b", {"num_layers": 5}))
FAMILY_CPU_ROWS = 128
#: card vs CPU at smoke width for those: logits and caches within 1e-5 *
#: (1 + |want|), the CPU parity tests' tolerance (tests/test_torch_families.py)
FAMILY_CPU_TOL = 1e-5
#: B7 at each family serving run's prefill shape: (label, B, H, KV, S, hd,
#: window), all causal — recurrentgemma-2b's local attention (MQA, hd 256),
#: phi-3-vision's prefill (hd 96), whisper-small's decoder self-attention,
#: dbrx-132b's (GQA group 6) and granite-8b's (group 4, hd 128)
FAMILY_FLASH_SHAPES = (("serve_griffin", 1, 10, 1, 4096, 256, 2048),
                       ("serve_vlm", 2, 32, 32, 640, 96, None),
                       ("serve_encdec", 4, 12, 12, 128, 64, None),
                       ("serve_moe", 1, 48, 8, 512, 128, None),
                       ("serve_dense8b", 4, 32, 8, 512, 128, None))
#: the lora path's depth: llama3.2-1b's 16 layers cut to 2 (time: at full
#: depth cuSOLVER's SVDs of the (32768, 8192) w_gate / w_up items took 65-70 %
#: of a 213-227 s phase; at 4 layers their (8192, 8192) items still took
#: 6.2 s each and the phases 187 s; at 2 they are (4096, 8192)). Below 9
#: layers the stacked (layers, 2048) attn_norm / mlp_norm items are too
#: small for rank-8 factors to pay and go to nf4 as leftovers
LORA_LAYERS = 2

#: the federated trainer's runs: full-width qwen1.5-0.5b (fl_train's own
#: default arch), 2 pods on one card over gloo, the reference's defaults of
#: 2 local steps at batch 4 x seq 64 and lr 1e-3, 1 round (of its 5) per
#: aggregation; seed 1, whose Dirichlet partition gives the pods different
#: data (seed 0 gives both the same)
FL_ARGS = {"arch": "qwen1.5-0.5b", "smoke": False, "rounds": 1, "local_steps": 2,
           "batch": 4, "seq": 64, "pods": 2, "lr": 1e-3, "alpha": 0.5, "seed": 1,
           "device": "cuda", "backend": "gloo"}
#: (label, --agg): the first run of a rank also pays its one-time costs
#: (cuBLAS handles, the allocator's first blocks), so int8 runs again last
FL_RUNS = (("fl_int8", "int8"), ("fl_int8_bucket", "int8-bucket"), ("fl_int8_warm", "int8"))
#: the xLSTM serving run: full-width xlstm-125m (the model B8 exists for),
#: batch 4, a prompt of 1024 (a multiple of the reference's 256-step chunk,
#: which the prefill routes on), 16 generated tokens
SERVE_XLSTM = ("serve_xlstm", 4, 1024, 16)
#: the sLSTM scan at its two full-width shapes: (label, batch, steps);
#: heads 4 x 192 (xlstm-125m's)
SLSTM_SHAPES = (("serve_xlstm", 4, 1024), ("long_prompt", 1, 8192))
#: card (kernel) vs CPU (plain version) xLSTM serving at smoke width, at a
#: prompt that is no multiple of the reference's chunk of 256: logits
#: within 1e-4 * (1 + |want|); each cache leaf within 1e-4 * (|want| + its
#: largest |want|) — the leaves span ten decades (mLSTM C ~1e-5, sLSTM n
#: ~1) and both sides sum their fp32 products in other orders
XLSTM_CPU_TOL = 1e-4
XLSTM_CPU_PROMPT = 200
FL_SPANS = ("fl.round", "fl.local_train", "coll.quantize", "coll.all_gather",
            "kernel.dequant_accumulate8")
AGG_CHUNK_BLOCKS = 1 << 15         # blocks per plain-version call of the K-way sum

#: the centralized trainer (launch/train.py) at full width, seed 0:
#: (label, arch, batch, seq, layers or None for the published depth). Every
#: length routes attention to the masked softmax (ROADMAP C13: B7 has no
#: gradient, as the reference's Pallas kernel has none): 192 tokens, and
#: whisper-small's 1,500 zero frames in its encoder. recurrentgemma-2b
#: (2.7B parameters, ~43 GB of AdamW state in fp32) at batch 1, uncut
TRAIN_RUNS = (("train_llama", "llama3.2-1b", 4, 192, None),
              ("train_xlstm", "xlstm-125m", 4, 192, None),
              ("train_encdec", "whisper-small", 4, 192, None),
              ("train_griffin", "recurrentgemma-2b", 1, 192, None))
#: steps a run: step 0 trains at lr 0 (the schedule reads the step before
#: the update), so weights move from step 1; step ms is the median of 1-3
TRAIN_STEPS = 4
#: one family each at smoke width, card vs CPU: the first gradient and
#: three train_loop steps from the same weights at batch 2 x 32 tokens
#: (phi-3-vision's 16 patches make 48 rows, no multiple of 128); held to
#: the CPU tests' tolerances (tests/test_torch_train.py): each gradient
#: leaf within 1e-5 of its own largest, histories within 1e-5 relative,
#: weights under testing.trained_counts
TRAIN_SMOKE = (("dense", "llama3.2-1b"), ("moe", "dbrx-132b"), ("vlm", "phi-3-vision-4.2b"),
               ("ssm", "xlstm-125m"), ("hybrid", "recurrentgemma-2b"),
               ("encdec", "whisper-small"))
TRAIN_SMOKE_SEQ = 32
#: three steps, so the last loss is taken after an update (step 0 runs at lr 0)
TRAIN_SMOKE_STEPS = 3
TRAIN_HISTORY_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-5
#: a federated round over another family: the first path's spec with
#: xlstm-125m at full width; and the smoke specs whose fixed-update runs
#: must give the CPU's bits on the card
FAMILY_JOB_ARCH = "xlstm-125m"
FAMILY_JOB_SMOKE = ("xlstm-125m", "recurrentgemma-2b")

#: (R1) the full-width runs held against the roofline of their own step,
#: each dry-run on meta at the same arch, shape, fp32 and TF32 off, one chip:
#: (label, run whose measured span it takes, arch, step kind, batch, length,
#: remat). serve_dense8b's decode steps run against the (prompt + generated)
#: cache that generate replays into: 512 + 16 slots
ROOFLINE_RUNS = (("train_llama", "train_llama", "llama3.2-1b", "train", 4, 192, True),
                 ("train_griffin", "train_griffin", "recurrentgemma-2b", "train", 1, 192, True),
                 ("serve_dense8b_prefill", "serve_dense8b", "granite-8b", "prefill", 4, 512,
                  False),
                 ("serve_dense8b_decode", "serve_dense8b", "granite-8b", "decode", 4, 528,
                  False),
                 ("serve_full_prefill", "serve_full", "llama3.2-1b", "prefill", 4, 512, False))
#: a roofline above the measured time means the count is wrong
ROOFLINE_SHARE_MAX = 1.05
#: the pairs dry-run here on the (16, 16) mesh over a fake group of 256
#: ranks, on the card machine's torch, each of which must count: granite-8b's
#: decode, and one pair from each class torch 2.11's DTensor refused before
#: the models ran their mesh steps on local shards (ROADMAP A, item 2): a
#: flatten of two sharded dims (qwen1.5-0.5b's head-sharded decode), an
#: uneven split of a sharded dim (whisper-small's cross-attention, 12 heads
#: on 16), a shard asked for a partial (recurrentgemma-2b's gate bias) and a
#: missing strategy (xlstm-125m's log_sigmoid_backward)
ROOFLINE_MESH_PAIRS = (("granite-8b", "decode_32k"), ("qwen1.5-0.5b", "decode_32k"),
                       ("whisper-small", "decode_32k"), ("recurrentgemma-2b", "train_4k"),
                       ("xlstm-125m", "train_4k"))
ROOFLINE_SWEEP_TIMEOUT_S = 300
#: (E1) the port's examples run on the card and against the CPU; the
#: federations (quickstart, async, hetero) at this many rounds on both
#: sides alike (time)
EXAMPLES = ("quickstart", "streaming_demo", "async_federation", "hetero_federation",
            "serve_batch")
EXAMPLE_ROUNDS = 2
#: quickstart card vs CPU: its CPU test's bounds (C1's drift)
EXAMPLE_LOSS_ATOL = 1e-3
EXAMPLE_BYTES_RTOL = 1e-3

BW8_SOURCE = "src/repro_torch/kernels/csrc/blockwise8.cu"
FB4_SOURCE = "src/repro_torch/kernels/csrc/fourbit.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
SLSTM_SOURCE = "src/repro_torch/kernels/csrc/slstm_scan.cu"
#: kernel wrapper -> (CUDA source, the TPU kernel's pl.pallas_call it
#: replaces, the main path whose launches it reports)
KERNELS = {
    "quantize_blockwise8": (BW8_SOURCE, "src/repro/kernels/quant_blockwise8.py:45",
                            "blockwise8"),
    "dequantize_blockwise8": (BW8_SOURCE, "src/repro/kernels/quant_blockwise8.py:66",
                              "blockwise8"),
    "dequant_accumulate8_into": (BW8_SOURCE, "src/repro/kernels/fused_dequant_agg.py:85",
                                 "blockwise8"),
    "quantize_4bit": (FB4_SOURCE, "src/repro/kernels/quant_nf4.py:86", "nf4"),
    "dequantize_4bit": (FB4_SOURCE, "src/repro/kernels/quant_nf4.py:112", "nf4"),
    "flash_attention": (FA_SOURCE, "src/repro/kernels/flash_attention.py:103", "serve_full"),
    "dequant_accumulate8": (BW8_SOURCE, "src/repro/kernels/fused_dequant_agg.py:44",
                            "fl_int8"),
    "slstm_scan": (SLSTM_SOURCE, "src/repro/kernels/slstm_scan.py:99", "serve_xlstm"),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3, batch: int = 10) -> float:
    """Median over ``reps`` CUDA-event timings of ``batch`` back-to-back
    calls of ``fn()``, per call, after warm-up. The batch keeps the
    device busy while the host prepares the next launch, so a wrapper's
    Python overhead (tens of microseconds) is not counted as device time
    unless it is longer than the kernel."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(np.median(times))


def bound(nbytes: float, ops: float, rate: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over HBM rate and
    operations over ``rate`` (the fp32 peak unless given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def flash_tensor_ops(hd: int, pairs: int, bf16_rate: float = BF16_OPS_PER_S,
                     tf32_rate: float = TF32_OPS_PER_S) -> float:
    """fp32 attention's tensor-core arithmetic as tf32 operations (to
    divide by the tf32 rate), at every head dim: per visible pair, 4 * hd
    of tf32 hi products (q k and p v) and 8 * hd of the bf16 product that
    holds both small ones (twice the depth), counted at the bf16 rate —
    the least split that keeps fp32 accuracy, which ``flash_fwd_kernel``
    runs."""
    return 4 * hd * pairs + 8 * hd * pairs * tf32_rate / bf16_rate


#: a tf32 m16n8k8 and a bf16 m16n8k16 mma.sync in a loop, 8 independent
#: accumulators a warp: the tensor-core rates a kernel built on mma.sync can
#: reach on this card (wgmma, which the published peaks assume, is not used)
MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int BF16>
__global__ void probe(float* out, int iters) {
  uint32_t a0 = threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u;
  float d[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(j), "r"(i));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(j), "r"(i));
    }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_probe(int bf16, void* out, int blocks, int threads, int iters, void* stream) {
  if (bf16) probe<1><<<blocks, threads, 0, (cudaStream_t)stream>>>((float*)out, iters);
  else probe<0><<<blocks, threads, 0, (cudaStream_t)stream>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def start_mma_probe_build(build_dir: str):
    """Start nvcc on :data:`MMA_PROBE` (beside the kernel build, in
    parallel); returns the process and the library path."""
    from repro_torch.kernels import _build

    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "mma_probe.cu")
    lib = os.path.join(build_dir, f"mma_probe.{os.getpid()}.so")
    with open(src, "w") as fh:
        fh.write(MMA_PROBE)
    proc = subprocess.Popen([_build.find_nvcc(), *_build.ARCH_FLAGS, "-O3", "-shared",
                             "-Xcompiler", "-fPIC", "-o", lib, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def mma_sync_rates(torch, proc, lib_path: str) -> dict[str, float]:
    """TFLOP/s of tf32 m16n8k8 and bf16 m16n8k16 mma.sync at 16 warps an SM."""
    import ctypes

    log = proc.communicate()[0]
    if proc.returncode != 0:
        fail(f"nvcc failed on the mma.sync probe:\n{log}")
    lib = ctypes.CDLL(lib_path)
    lib.mma_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 2 * sms, 256, 4096
    out = torch.empty(blocks * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, bf16, flops in (("tf32", 0, 2 * 16 * 8 * 8), ("bf16", 1, 2 * 16 * 8 * 16)):
        ms = time_ms(torch, lambda: lib.mma_probe(bf16, out.data_ptr(), blocks, threads,
                                                  iters, stream), reps=5, warmup=1, batch=3)
        rates[name] = blocks * threads // 32 * iters * 8 * flops / ms / 1e9
    print(f"mma.sync rates on this card (16 warps an SM): tf32 m16n8k8 "
          f"{rates['tf32']:.1f} TFLOP/s, bf16 m16n8k16 {rates['bf16']:.1f} TFLOP/s "
          f"(published dense peaks {TF32_OPS_PER_S / 1e12:.0f} and "
          f"{BF16_OPS_PER_S / 1e12:.0f}, through wgmma)")
    os.unlink(lib_path)
    return rates


def sass_counts(lib_path: str) -> dict[str, dict[str, int]]:
    """Per kernel of the built library, the count of the SASS instructions
    that show the redesigned kernels' mechanisms (``cuobjdump -sass``):
    tensor-core products by type, cp.async copies, cluster barriers."""
    from repro_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts: dict[str, dict[str, int]] = {}
    name = None
    ops = ("HMMA.1688.F32.TF32", "HMMA.16816.F32.BF16", "LDGSTS", "UCGABAR")
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            counts[name] = {op: 0 for op in ops}
        elif name is not None:
            for op in ops:
                if op in line:
                    counts[name][op] += 1
    return counts


def check_sass(lib_path: str) -> dict[str, dict[str, int]]:
    """The flash kernels run tf32 mma.sync with cp.async copies, and on
    fp32 inputs the bf16 mma.sync of the split's two small products too
    (both kernels, every head dim); the sLSTM kernels meet at a cluster
    barrier."""
    counts = sass_counts(lib_path)
    flash = {k: v for k, v in counts.items()
             if "flash_fwd_kernel" in k or "flash_wide_kernel" in k}
    scan = {k: v for k, v in counts.items() if "slstm_cluster_kernel" in k}
    if len(flash) != 8 or len(scan) != 2:
        fail(f"SASS: {len(flash)} flash and {len(scan)} sLSTM kernels, expected 8 and 2")
    for name, c in flash.items():
        bf16_split = "_kernelIf" in name
        if not (c["HMMA.1688.F32.TF32"] and c["LDGSTS"]
                and (c["HMMA.16816.F32.BF16"] > 0) == bf16_split):
            fail(f"SASS of {name}: {c}")
    for name, c in scan.items():
        if not c["UCGABAR"]:
            fail(f"SASS of {name}: no cluster barrier ({c})")
    for name, c in {**flash, **scan}.items():
        print(f"  sass: {name[-60:]}: " + ", ".join(f"{k} {v}" for k, v in c.items() if v))
    return {**flash, **scan}


def bits(torch, t):
    return t.contiguous().view(torch.int32)


def same_bits(torch, a, b) -> bool:
    """Bitwise equal, with NaN in the same places (a NaN's payload is not
    compared: the card's arithmetic returns its canonical NaN)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(bits(torch, a)[~nan],
                                                            bits(torch, b)[~nan])


def check_nonfinite_absmax(torch, name: str, absmax) -> None:
    """The ``nan_inf`` case's blocks: NaN absmax for the blocks holding NaN
    (0 and 3), inf for those holding an infinity only (1 and 2), a finite
    one for block 4 — what the reference gives."""
    if not (torch.isnan(absmax[[0, 3]]).all() and torch.isinf(absmax[[1, 2]]).all()
            and torch.isfinite(absmax[4])):
        fail(f"{name}: the nan_inf blocks' absmax is {absmax[:5].tolist()}, expected "
             "[nan, inf, inf, nan, finite]")


def release(torch) -> None:
    """Free what the last phase left: collect reference cycles (a model's
    init can leave device tensors in one) and return cached blocks, so
    the next phase's allocation and peak start from what it holds."""
    gc.collect()
    torch.cuda.empty_cache()


def time_rows(torch, rows: dict, err: dict, timed: dict, n: int) -> None:
    """Time each kernel, its plain version and its library yardstick (if
    any) and record them with the bound of the bytes and operations given."""
    for name, (kern, plain, lib, nbytes, nops) in timed.items():
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain, reps=10, warmup=1, batch=1)
        lib_ms = time_ms(torch, lib) if lib is not None else None
        bound_ms, bound_by = bound(nbytes, nops)
        rows[name] = {"elements": n, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "max_abs_err": err[name]}
        print(f"{name}: {ms:.4f} ms at {n} elements ({nbytes / ms / 1e6:.1f} GB/s), "
              f"bound {bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / ms:.1f}% of it), "
              f"plain {plain_ms:.4f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")


def largest_item(torch, dev):
    """Weight-like values of the slice's largest item, from a seed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = math.prod(LARGEST_ITEM)
    return torch.randn(n, generator=gen, device=dev) * 0.02, gen


def check_kernels(torch, dev) -> dict[str, dict]:
    """Every blockwise8 kernel against its plain version on the card, each
    at the shapes the main path gives it: the edge cases of
    ``repro_torch.kernels.cases``; the slice's largest item for all three
    (dequantize and the fold run per item); and the whole fused group of
    one message (365,841 blocks of the slice's own initial weights) for
    quantize, which runs once per message over all of it. Quantize is
    timed at the fused group, dequantize and the fold at the largest item."""
    from repro_torch.core.quantization import pack_group
    from repro_torch.fl.job import initial_weights
    from repro_torch.kernels import cases, ops, ref
    from repro_torch.kernels.fused_dequant_agg import dequant_accumulate8_into
    from repro_torch.kernels.quant_blockwise8 import (
        dequantize_blockwise8,
        quantize_blockwise8,
    )

    err = {"quantize_blockwise8": 0.0, "dequantize_blockwise8": 0.0,
           "dequant_accumulate8_into": 0.0}

    def compare_quantize(name, x2d):
        q, am = quantize_blockwise8(x2d)
        q_p, am_p = ref.quantize_blockwise8(x2d)
        if not (torch.equal(q, q_p) and same_bits(torch, am, am_p)):
            fail(f"quantize kernel disagrees with its plain version on {name}")
        if name == "nan_inf":
            check_nonfinite_absmax(torch, "blockwise8 quantize kernel", am)
        return q, am

    def compare(name, x2d, acc0, weight):
        q, am = compare_quantize(name, x2d)
        d = dequantize_blockwise8(q, am)
        d_p = ref.dequantize_blockwise8(q, am)
        if not same_bits(torch, d, d_p):
            fail(f"dequantize kernel disagrees with its plain version on {name}")
        del d, d_p
        k = dequant_accumulate8_into(acc0.clone(), q, am, weight)
        p = ref.dequant_accumulate8_into(acc0.clone(), q, am, weight)
        nan = torch.isnan(p)
        if not torch.equal(torch.isnan(k), nan):
            fail(f"fold kernel puts NaN elsewhere than its plain version on {name}")
        diff = (k - p).abs()[~nan]
        ulp = (torch.nextafter(p.abs(), torch.full_like(p, math.inf)) - p.abs())[~nan]
        if bool((diff > ulp).any()):
            fail(f"fold kernel differs from its plain version by more than 1 ulp of "
                 f"|acc| on {name} (weight {weight})")
        if diff.numel():
            err["dequant_accumulate8_into"] = max(err["dequant_accumulate8_into"],
                                                  float(diff.max()))
        return q, am

    for name, x in cases.blockwise8_cases().items():
        x2d = ops.pad_to_blocks(torch.from_numpy(x).to(dev))
        accumulator = (cases.subnormal_accumulator if name == "subnormal"
                       else cases.fold_accumulator)
        for w in cases.FOLD_WEIGHTS:
            acc0 = torch.from_numpy(accumulator(x2d.shape[0])).to(dev)
            compare(name, x2d, acc0, w)
    print(f"blockwise8 kernels agree with their plain versions on "
          f"{len(cases.blockwise8_cases())} edge cases (quantize, dequantize bitwise, NaN "
          "in the same places; fold within 1 ulp of |acc|); nan_inf absmax: NaN, inf, inf, "
          "NaN, finite")

    rows: dict[str, dict] = {}
    flat, gen = largest_item(torch, dev)
    n = flat.numel()
    x2d = flat.reshape(-1, ref.BLOCK8)
    acc0 = torch.randn(x2d.shape, generator=gen, device=dev) * 0.02
    weight = float(SPEC["batch"] * SPEC["local_steps"])
    q, am = compare("blocks.mlp.w_gate", x2d, acc0, weight)
    del x2d, flat
    torch.cuda.synchronize()

    nb = q.shape[0]
    scale = am * ref.INV127
    s_fold = am * float(np.float32(ref.INV127) * np.float32(weight))
    acc_k, acc_p, acc_l = acc0.clone(), acc0.clone(), acc0.clone()
    del acc0
    time_rows(torch, rows, err, {
        "dequantize_blockwise8": (
            lambda: dequantize_blockwise8(q, am), lambda: ref.dequantize_blockwise8(q, am),
            lambda: q.float() * scale[:, None],
            5 * n + 4 * nb, 2 * n),
        "dequant_accumulate8_into": (
            lambda: dequant_accumulate8_into(acc_k, q, am, weight),
            lambda: ref.dequant_accumulate8_into(acc_p, q, am, weight),
            lambda: acc_l.addcmul_(q, s_fold[:, None]),
            9 * n + 4 * nb, 3 * n),
    }, n)
    del q, am, scale, s_fold, acc_k, acc_p, acc_l
    release(torch)

    # one message's fused group, laid out as quantize_batch lays it out
    weights = initial_weights(SPEC, device=dev)
    x2d, _spans = pack_group(weights, list(weights), dev, ref.BLOCK8)
    del weights
    if x2d.shape[0] != GROUP_BLOCKS:
        fail(f"fused group has {x2d.shape[0]} blocks, expected {GROUP_BLOCKS}")
    q, am = compare_quantize("the fused group", x2d)
    del q, am
    release(torch)
    n = x2d.numel()
    print(f"quantize kernel agrees bitwise with its plain version on the fused group "
          f"({GROUP_BLOCKS} blocks, {n} elements)")
    time_rows(torch, rows, err, {
        "quantize_blockwise8": (
            lambda: quantize_blockwise8(x2d), lambda: ref.quantize_blockwise8(x2d), None,
            5 * n + 4 * GROUP_BLOCKS, 6 * n),
    }, n)
    del x2d
    release(torch)
    return rows


def check_fourbit_kernels(torch, dev) -> dict[str, dict]:
    """Both 4-bit kernels against their plain versions on the card, bitwise
    (the same uint8 codes, the same int32 views of absmax and of the
    dequantized values), for nf4 and fp4: on the edge cases of
    ``kernels.cases.fourbit_cases``, on the slice's largest item, and
    (quantize) over the whole nf4 fused group of the slice's own initial
    weights, compared in chunks of blocks because the plain version builds
    full-size temporaries (blocks are independent, so chunks give the same
    bits). Quantize is timed at the fused group, dequantize at the largest
    item — the shapes the main path gives them; both plain versions are
    timed at the largest item. No single PyTorch call computes either
    function, so neither has a library time."""
    from repro_torch.core.quantization import pack_group
    from repro_torch.fl.job import initial_weights
    from repro_torch.kernels import cases, ops, ref
    from repro_torch.kernels.quant_nf4 import dequantize_4bit, quantize_4bit

    err = {"quantize_4bit": 0.0, "dequantize_4bit": 0.0}

    def compare_quantize(name, fmt, x2d, p, am):
        p_p, am_p = ref.quantize_4bit(x2d, fmt)
        finite = torch.isfinite(am_p)
        err["quantize_4bit"] = max(err["quantize_4bit"],
                                   float((p.int() - p_p.int()).abs().max()),
                                   float((am - am_p)[finite].abs().max()))
        if not (torch.equal(p, p_p) and same_bits(torch, am, am_p)):
            fail(f"4-bit quantize kernel disagrees with its plain version on {name} ({fmt})")
        if name == "nan_inf":
            check_nonfinite_absmax(torch, f"4-bit quantize kernel ({fmt})", am)

    def compare(name, fmt, x2d):
        p, am = quantize_4bit(x2d, fmt)
        compare_quantize(name, fmt, x2d, p, am)
        d = dequantize_4bit(p, am, fmt)
        d_p = ref.dequantize_4bit(p, am, fmt)
        finite = torch.isfinite(d_p)
        err["dequantize_4bit"] = max(err["dequantize_4bit"],
                                     float((d - d_p)[finite].abs().max()))
        if not same_bits(torch, d, d_p):
            fail(f"4-bit dequantize kernel disagrees with its plain version on {name} ({fmt})")
        return p, am

    edge = cases.fourbit_cases()
    for fmt in ("fp4", "nf4"):
        for name, x in edge.items():
            compare(name, fmt, ops.pad_to_blocks(torch.from_numpy(x).to(dev), ref.BLOCK4))
    print(f"4-bit kernels agree bitwise with their plain versions on {len(edge)} edge "
          "cases (NaN in the same places), for fp4 and nf4; nan_inf absmax: NaN, inf, inf, "
          "NaN, finite")

    rows: dict[str, dict] = {}
    flat, _gen = largest_item(torch, dev)
    n = flat.numel()
    x2d = flat.reshape(-1, ref.BLOCK4)
    del flat
    for fmt in ("fp4", "nf4"):
        p, am = compare("blocks.mlp.w_gate", fmt, x2d)
    torch.cuda.synchronize()
    print(f"4-bit kernels agree bitwise with their plain versions at the largest item "
          f"({n} elements), for fp4 and nf4")
    nb = p.shape[0]
    item_quantize_ms = time_ms(torch, lambda: quantize_4bit(x2d, "nf4"))
    plain_quantize_ms = time_ms(torch, lambda: ref.quantize_4bit(x2d, "nf4"), reps=10,
                                warmup=1, batch=1)
    del x2d
    release(torch)
    time_rows(torch, rows, err, {
        "dequantize_4bit": (
            lambda: dequantize_4bit(p, am, "nf4"), lambda: ref.dequantize_4bit(p, am, "nf4"),
            None, n // 2 + 4 * nb + 4 * n, n),
    }, n)
    del p, am
    release(torch)

    weights = initial_weights(SPEC_NF4, device=dev)
    x2d, _spans = pack_group(weights, list(weights), dev, ref.BLOCK4)
    del weights
    if x2d.shape[0] != GROUP_BLOCKS4:
        fail(f"nf4 fused group has {x2d.shape[0]} blocks, expected {GROUP_BLOCKS4}")
    p, am = quantize_4bit(x2d, "nf4")
    for start in range(0, GROUP_BLOCKS4, CHUNK_BLOCKS4):
        end = min(start + CHUNK_BLOCKS4, GROUP_BLOCKS4)
        compare_quantize(f"blocks {start}:{end} of the fused group", "nf4",
                         x2d[start:end], p[start:end], am[start:end])
    del p, am
    release(torch)
    n = x2d.numel()
    print(f"4-bit quantize kernel agrees bitwise with its plain version on the nf4 fused "
          f"group ({GROUP_BLOCKS4} blocks, {n} elements, compared in chunks of "
          f"{CHUNK_BLOCKS4} blocks)")
    ms = time_ms(torch, lambda: quantize_4bit(x2d, "nf4"))
    del x2d
    release(torch)
    # bytes: fp32 in, packed codes and absmax out; operations: abs, max,
    # the multiply and 15 compares per element
    nbytes = 4 * n + n // 2 + 4 * GROUP_BLOCKS4
    bound_ms, bound_by = bound(nbytes, 18 * n)
    rows["quantize_4bit"] = {
        "elements": n, "ms": ms, "plain_ms": plain_quantize_ms,
        "plain_elements": math.prod(LARGEST_ITEM), "item_ms": item_quantize_ms,
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "max_abs_err": err["quantize_4bit"]}
    print(f"quantize_4bit: {ms:.4f} ms at {n} elements ({nbytes / ms / 1e6:.1f} GB/s), "
          f"bound {bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / ms:.1f}% of it); at the "
          f"largest item {item_quantize_ms:.4f} ms, plain {plain_quantize_ms:.4f} ms; "
          "library n/a")
    return rows


def phase_times(events: list[dict], fold: bool) -> dict[str, float]:
    """Per-phase wall seconds from the device-synchronised span trace.
    A transmit span holds the encode and the receiving end's decode (or,
    with ``fold``, the streaming fold) of that message, plus the host
    framing (serialization, crc32, chunking, reassembly); local steps run
    between the two transmits. Without the fold, the server's dense
    accumulate is what a client round trip holds besides its two
    transmits and its local steps."""
    spans = [e for e in events if e.get("ph") == "X"]
    transmits = [e for e in spans if e["name"] == "wire.transmit"]

    def inside(e, outer):
        return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    def direction(e):
        for t in transmits:
            if inside(e, t):
                return t["args"]["kind"]
        return None

    def total(pred):
        return sum(e["dur"] for e in spans if pred(e)) / 1e6

    def named(name, kind=None):
        return lambda e: e["name"] == name and (kind is None or direction(e) == kind)

    phases = {
        "downlink_transmit_s": total(lambda e: e["name"] == "wire.transmit"
                                     and e["args"]["kind"] == "task_data"),
        "uplink_transmit_s": total(lambda e: e["name"] == "wire.transmit"
                                   and e["args"]["kind"] == "task_result"),
        "downlink_encode_s": total(named("kernel.quantize_batch", "task_data")),
        "client_decode_s": total(named("stage.decode.quantize", "task_data")),
        "local_steps_s": total(named("client.train")),
        "uplink_encode_s": total(named("kernel.quantize_batch", "task_result")),
    }
    if fold:
        phases["fold_s"] = total(named("kernel.dequant_accumulate8"))
    else:
        phases["server_decode_s"] = total(named("stage.decode.quantize", "task_result"))
        trips = [e for e in spans if e["name"] == "client.round_trip"]
        phases["fedavg_accumulate_s"] = sum(
            t["dur"] - sum(e["dur"] for e in spans
                           if e["name"] in ("wire.transmit", "client.train") and inside(e, t))
            for t in trips) / 1e6
    phases["finish_s"] = total(named("agg.finish"))
    return phases


def run_path(torch, dev, label: str, spec: dict, want: dict[str, int],
             n_items: int = N_ITEMS) -> dict:
    """One main path: one full-width federated round with the launch
    counters zeroed just before it and read just after; the model's flat
    state has ``n_items`` items."""
    from repro_torch.fl.job import build_job
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    job = build_job({**spec, "trace": True}, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    result = job.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    want = {name: want.get(name, 0) for name in launches}
    print(f"{label} launches: {launches} (expected {want})")
    if launches != want:
        fail(f"kernel launches on the {label} path {launches} != {want}")
    clients, rounds = spec["clients"], spec["rounds"]
    losses = result["history"]
    if len(losses) != clients * rounds or not all(math.isfinite(x) for x in losses):
        fail(f"{label}: losses not finite: {losses}")
    final, init = result["final_weights"], job.init_weights
    if list(final) != list(init) or len(final) != n_items:
        fail(f"{label}: final weights do not have the initial weights' names")
    moved = 0
    for name, w in final.items():
        if w.shape != init[name].shape or w.device.type != dev.type:
            fail(f"{label}: {name}: shape {tuple(w.shape)} on {w.device}")
        if not bool(torch.isfinite(w).all()):
            fail(f"{label}: {name}: non-finite final weights")
        moved += int(not torch.equal(w, init[name]))
    if moved != len(final):
        fail(f"{label}: only {moved} of {len(final)} tensors moved from their initial values")
    n_params = sum(w.numel() for w in final.values())
    phases = phase_times(job.sim.tracer.chrome_trace()["traceEvents"],
                         fold=spec["aggregator"] == "quantized-fedavg")
    report = {
        "wall_s": wall, "build_job_s": build_s,
        "round_wall_s": [r["wall_s"] for r in result["round_log"]],
        "phases": phases, "losses": losses, "launches": launches,
        "messages": result["messages"], "wire_bytes": result["wire_bytes"],
        "params": n_params,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "allocated_before_bytes": allocated_before,
    }
    print(f"{label}: {n_params} params, {result['messages']} messages, "
          f"{result['wire_bytes']} wire bytes, losses {losses}, wall {wall:.3f} s "
          f"(build_job {build_s:.3f} s)")
    print(f"{label} phases (s): " + ", ".join(f"{k}={v:.4f}" for k, v in phases.items()))
    print(f"{label} max_memory_allocated: {report['max_memory_allocated_bytes']} bytes "
          f"({allocated_before} allocated before the round)")
    del job, result, final, init
    release(torch)
    return report


def check_against_cpu(torch, dev) -> dict:
    """Smoke width, card vs CPU from identical weights, blockwise8 path:
    fixed updates must give the same bits; a trained round must agree
    within one quantization step per block plus 1e-5 relative (see
    tests/test_torch_slice.py for why)."""
    from repro_torch.fl.job import build_job, initial_weights, run_job
    from repro_torch.kernels.ref import BLOCK8
    from repro_torch.testing import block_step, fixed_train_fn

    spec = {**SPEC, "smoke": True, "rounds": 1}
    init = {k: v.numpy() for k, v in initial_weights(spec, device="cpu").items()}

    outs = {}
    for d in ("cpu", dev):
        jb = build_job(spec, device=d, weights=init)
        for i, proxy in enumerate(jb.sim.proxies):
            proxy.executor.train_fn = fixed_train_fn(init, i, 0.05)
        outs[str(d)] = {k: v.cpu() for k, v in jb.run()["final_weights"].items()}
    for name, want in outs["cpu"].items():
        if not torch.equal(bits(torch, outs[str(dev)][name]), bits(torch, want)):
            fail(f"fixed-update federation differs between card and CPU at {name}")

    cpu = run_job(spec, device="cpu", weights=init)
    gpu = run_job(spec, device=dev, weights=init)
    worst = 0.0
    for name, want in cpu["final_weights"].items():
        got = gpu["final_weights"][name].cpu()
        step = block_step(want, got, BLOCK8, 1 / 127)
        err = (got - want).abs().reshape(-1)
        if bool((err > step + 1e-5 * want.abs().reshape(-1)).any()):
            fail(f"trained round on the card is more than one quantization step from "
                 f"the CPU at {name}")
        worst = max(worst, float((err / step.clamp_min(1e-30)).max()))
    rel = max(abs(a - b) / abs(b) for a, b in zip(gpu["history"], cpu["history"]))
    if rel > 1e-4:
        fail(f"losses on the card differ from the CPU by {rel:.3g} relative")
    print(f"blockwise8, smoke width, card vs CPU: fixed-update weights bitwise equal; "
          f"trained round within {worst:.3f} quantization steps, losses within "
          f"{rel:.3g} relative")
    return {"trained_max_steps": worst, "loss_rel": rel}


def check_nf4_against_cpu(torch, dev) -> dict:
    """``examples/jobs/wire_pipeline.json`` as it stands (smoke width, nf4 +
    zlib down, nf4 + zlib + crc32 up, fedavg, 2 rounds), card vs CPU from
    identical weights. Fixed updates must give the same bits and the same
    wire bytes. Trained, each round's global weights must agree within the
    bound ``tests/test_torch_slice.py`` states against the reference: after
    round 1 every element within one adjacent-code gap of its block (the
    codebook's largest gap times the block's absmax) + 1e-5 relative; after
    the final round every element within one gap + 2 * lr * local_steps
    (a code flipped in round 1 may flip the sign of a near-zero gradient in
    round 2, and AdamW's step is ~lr either way) + 1e-5 relative, and at
    most a 1e-5 share of the elements outside one gap. Losses agree within
    1e-4 relative."""
    from repro_torch.fl.job import build_job, initial_weights, normalize_spec
    from repro_torch.kernels.ref import BLOCK4, NF4_CODE
    from repro_torch.testing import block_step, fixed_train_fn

    with open(WIRE_PIPELINE_JOB) as fh:
        spec = normalize_spec(json.load(fh))
    init = {k: v.numpy() for k, v in initial_weights(spec, device="cpu").items()}

    outs, wire = {}, {}
    for d in ("cpu", dev):
        jb = build_job(spec, device=d, weights=init)
        for i, proxy in enumerate(jb.sim.proxies):
            proxy.executor.train_fn = fixed_train_fn(init, i, 0.05 * (i + 1))
        out = jb.run()
        outs[str(d)] = {k: v.cpu() for k, v in out["final_weights"].items()}
        wire[str(d)] = out["wire_bytes"]
    if wire[str(dev)] != wire["cpu"]:
        fail(f"nf4 fixed-update federation: {wire[str(dev)]} wire bytes on the card, "
             f"{wire['cpu']} on the CPU")
    for name, want in outs["cpu"].items():
        if not torch.equal(bits(torch, outs[str(dev)][name]), bits(torch, want)):
            fail(f"nf4 fixed-update federation differs between card and CPU at {name}")

    gap = float(np.diff(np.sort(NF4_CODE)).max())
    globals_by_round = {}
    histories = {}
    for d in ("cpu", dev):
        jb = build_job(spec, device=d, weights=init)
        rounds = globals_by_round[str(d)] = []
        jb.sim.controller.on_round_end = (
            lambda rnd, weights, results, _r=rounds: _r.append(
                {n: v.cpu().clone() for n, v in weights.items()}))
        histories[str(d)] = jb.run()["history"]
    sign_flips = 2 * spec["lr"] * spec["local_steps"]
    worst = []
    for rnd, (want_r, got_r) in enumerate(zip(globals_by_round["cpu"],
                                              globals_by_round[str(dev)])):
        n = outside = 0
        worst_gaps = 0.0
        for name, want in want_r.items():
            got = got_r[name]
            step = block_step(want, got, BLOCK4, gap)
            err = (got - want).abs().reshape(-1)
            rel = 1e-5 * want.abs().reshape(-1)
            cap = step + rel if rnd == 0 else step + sign_flips + rel
            if bool((err > cap).any()):
                fail(f"nf4 trained federation, round {rnd + 1}: the card is outside the "
                     f"stated bound from the CPU at {name}")
            n += err.numel()
            outside += int((err > step + rel).sum())
            worst_gaps = max(worst_gaps, float((err / step.clamp_min(1e-30)).max()))
        if outside > 1e-5 * n:
            fail(f"nf4 trained federation, round {rnd + 1}: {outside} of {n} elements "
                 "more than one code gap from the CPU")
        worst.append(worst_gaps)
    if len(worst) != spec["rounds"]:
        fail(f"nf4 trained federation ran {len(worst)} rounds, expected {spec['rounds']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(histories[str(dev)], histories["cpu"]))
    if rel > 1e-4:
        fail(f"nf4 losses on the card differ from the CPU by {rel:.3g} relative")
    print(f"nf4 wire_pipeline.json, smoke width, card vs CPU: fixed-update weights "
          f"bitwise equal, {wire['cpu']} wire bytes on both; trained rounds within "
          f"{', '.join(f'{w:.3f}' for w in worst)} code gaps, losses within {rel:.3g} "
          "relative")
    return {"trained_max_gaps": worst, "loss_rel": rel, "wire_bytes": wire["cpu"]}


def legacy_spec() -> dict:
    """``examples/jobs/legacy_quantized.json`` at full width, 1 round of its 2."""
    with open(LEGACY_JOB) as fh:
        return {**json.load(fh), "smoke": False, "rounds": 1}


def legacy_phases(events: list[dict]) -> dict[str, float]:
    """Per-phase wall seconds of a legacy filter round from the
    device-synchronised span trace: the filters run inside the transmits
    (egress quantize before the first item is framed, ingress dequantize
    after the last is reassembled); the rest of a transmit is host
    framing (serialization, device-to-host copies, chunking, reassembly,
    and in regular mode the two joins of the blob)."""
    spans = [e for e in events if e.get("ph") == "X"]
    transmits = [e for e in spans if e["name"] == "wire.transmit"]

    def kind_of(e):
        for t in transmits:
            if t["ts"] <= e["ts"] and e["ts"] + e["dur"] <= t["ts"] + t["dur"]:
                return t["args"]["kind"]
        return None

    def total(name, kind=None):
        return sum(e["dur"] for e in spans if e["name"] == name
                   and (kind is None or kind_of(e) == kind)) / 1e6

    quantize, dequantize = "stage.encode.filter:QuantizeFilter", \
        "stage.decode.filter:DequantizeFilter"
    phases = {}
    for kind, label in (("task_data", "downlink"), ("task_result", "uplink")):
        phases[f"{label}_transmit_s"] = sum(
            t["dur"] for t in transmits if t["args"]["kind"] == kind) / 1e6
        phases[f"{label}_quantize_filter_s"] = total(quantize, kind)
        phases[f"{label}_dequantize_filter_s"] = total(dequantize, kind)
        phases[f"{label}_framing_s"] = (phases[f"{label}_transmit_s"]
                                        - phases[f"{label}_quantize_filter_s"]
                                        - phases[f"{label}_dequantize_filter_s"])
    phases["local_steps_s"] = total("client.train")
    phases["finish_s"] = total("agg.finish")
    return phases


def run_legacy(torch, dev) -> dict:
    """The paper's filter form of two-way quantization at full width: the
    legacy spec's one round, once with ``container`` and once with
    ``regular`` transmission from the same seeded weights, the launch
    counters zeroed just before each and read just after. Each blockwise8
    item is quantized by one B1 launch at each egress point and
    dequantized by one B2 launch at each ingress point (the filters work
    item by item, as the reference's do), and the fold kernel does not run
    (dense ``fedavg``). The two runs must end bitwise equal, and regular
    transmission must hold more transmission memory than container."""
    from repro_torch.fl.job import build_job
    from repro_torch.kernels import ops

    spec = legacy_spec()
    per_direction = spec["clients"] * spec["rounds"] * N_ITEMS
    want = {name: 0 for name in ops.KERNELS}
    want.update(quantize_blockwise8=2 * per_direction, dequantize_blockwise8=2 * per_direction)
    init, final, runs = None, None, {}
    for mode in ("container", "regular"):
        torch.cuda.synchronize()
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        label = f"legacy_{mode}"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        job = build_job({**spec, "transmission": mode, "trace": True}, device=dev,
                        weights=init)
        if init is None:
            init = {k: v.clone() for k, v in job.init_weights.items()}
        result = job.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        print(f"{label} launches: {launches} (expected {want})")
        if launches != want:
            fail(f"kernel launches on the {label} path {launches} != {want}")
        losses = result["history"]
        if len(losses) != spec["clients"] or not all(math.isfinite(x) for x in losses):
            fail(f"{label}: losses not finite: {losses}")
        out = result["final_weights"]
        if list(out) != list(init) or len(out) != N_ITEMS:
            fail(f"{label}: final weights do not have the initial weights' names")
        for name, w in out.items():
            if w.shape != init[name].shape or not bool(torch.isfinite(w).all()):
                fail(f"{label}: {name}: shape {tuple(w.shape)} or non-finite values")
            if torch.equal(w, init[name]):
                fail(f"{label}: {name} did not move from its initial values")
        if final is None:
            final = out
        else:
            for name, w in out.items():
                if not torch.equal(bits(torch, w), bits(torch, final[name])):
                    fail(f"legacy round: regular and container transmission differ at {name}")
        memory = result["telemetry"]["memory"]
        runs[mode] = {
            "wall_s": wall, "round_wall_s": [r["wall_s"] for r in result["round_log"]],
            "phases": legacy_phases(job.sim.tracer.chrome_trace()["traceEvents"]),
            "losses": losses, "launches": launches, "messages": result["messages"],
            "wire_bytes": result["wire_bytes"], "meter_peak_bytes": memory["peak"],
            "meter_copied_bytes": memory["copied"],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        }
        print(f"{label}: {result['messages']} messages, {result['wire_bytes']} wire bytes, "
              f"round wall {runs[mode]['round_wall_s'][0]:.3f} s (whole call {wall:.3f} s), "
              f"MemoryMeter peak {memory['peak']} bytes, copied {memory['copied']} bytes, "
              f"losses {losses}")
        print(f"{label} phases (s): " + ", ".join(
            f"{k}={v:.4f}" for k, v in runs[mode]["phases"].items()))
        del job, result, out
    if not runs["regular"]["meter_peak_bytes"] > runs["container"]["meter_peak_bytes"]:
        fail("legacy round: regular transmission's MemoryMeter peak is not above container's")
    print("legacy round: container and regular final weights bitwise equal; "
          f"regular peak / container peak = "
          f"{runs['regular']['meter_peak_bytes'] / runs['container']['meter_peak_bytes']:.3f}")
    del init, final
    release(torch)
    return runs


def check_legacy_against_cpu(torch, dev) -> dict:
    """``legacy_quantized.json`` at smoke width, card vs CPU from identical
    weights: fixed updates over the spec's 2 rounds must give the same
    bits and wire bytes in both transmissions; a trained round must agree
    within one quantization step per block plus 1e-5 relative, losses
    within 1e-4 relative (see tests/test_torch_slice_legacy.py). Then the
    command-line entry point runs the spec file unchanged on the card."""
    from repro_torch.fl.job import build_job, initial_weights, run_job
    from repro_torch.kernels.ref import BLOCK8
    from repro_torch.testing import block_step, fixed_train_fn

    with open(LEGACY_JOB) as fh:
        spec = json.load(fh)
    init = {k: v.numpy() for k, v in initial_weights(spec, device="cpu").items()}
    wire = {}
    for mode in ("container", "regular"):
        outs = {}
        for d in ("cpu", dev):
            jb = build_job({**spec, "transmission": mode}, device=d, weights=init)
            for i, proxy in enumerate(jb.sim.proxies):
                proxy.executor.train_fn = fixed_train_fn(init, i, 0.05 * (i + 1))
            out = jb.run()
            outs[str(d)] = ({k: v.cpu() for k, v in out["final_weights"].items()},
                            out["wire_bytes"])
        (want, want_bytes), (got, got_bytes) = outs["cpu"], outs[str(dev)]
        if got_bytes != want_bytes:
            fail(f"legacy {mode} fixed-update federation: {got_bytes} wire bytes on the "
                 f"card, {want_bytes} on the CPU")
        for name, w in want.items():
            if not torch.equal(bits(torch, got[name]), bits(torch, w)):
                fail(f"legacy {mode} fixed-update federation differs between card and "
                     f"CPU at {name}")
        wire[mode] = want_bytes

    one_round = {**spec, "rounds": 1}
    cpu = run_job(one_round, device="cpu", weights=init)
    gpu = run_job(one_round, device=dev, weights=init)
    worst = 0.0
    for name, want in cpu["final_weights"].items():
        got = gpu["final_weights"][name].cpu()
        step = block_step(want, got, BLOCK8, 1 / 127)
        err = (got - want).abs().reshape(-1)
        if bool((err > step + 1e-5 * want.abs().reshape(-1)).any()):
            fail(f"legacy trained round on the card is more than one quantization step "
                 f"from the CPU at {name}")
        worst = max(worst, float((err / step.clamp_min(1e-30)).max()))
    rel = max(abs(a - b) / abs(b) for a, b in zip(gpu["history"], cpu["history"]))
    if rel > 1e-4:
        fail(f"legacy losses on the card differ from the CPU by {rel:.3g} relative")

    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.fl.job", LEGACY_JOB],
                          capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    if proc.returncode != 0:
        fail(f"python -m repro_torch.fl.job {os.path.relpath(LEGACY_JOB, REPO)} exited "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    summary = json.loads(proc.stdout)
    n_results = spec["rounds"] * spec["clients"]
    if (summary["messages"] != 2 * n_results or len(summary["history"]) != n_results
            or not all(math.isfinite(x) for x in summary["history"])
            or summary["telemetry"]["traffic"]["bytes_sent"] != summary["wire_bytes"]):
        fail(f"the job entry point's summary on the card is wrong: {summary}")
    print(f"legacy_quantized.json, smoke width, card vs CPU: fixed-update weights and wire "
          f"bytes equal in both transmissions ({wire}); trained round within {worst:.3f} "
          f"quantization steps, losses within {rel:.3g} relative; python -m "
          f"repro_torch.fl.job on the card: {summary['messages']} messages, "
          f"{summary['wire_bytes']} wire bytes, losses {summary['history']}")
    return {"fixed_wire_bytes": wire, "trained_max_steps": worst, "loss_rel": rel,
            "cli": {k: summary[k] for k in ("messages", "wire_bytes", "history")}}


def async_spec(path: str = ASYNC_JOB) -> dict:
    """``examples/jobs/streaming_aggregation.json`` at full width, ``zlib``
    dropped from both hops (single-core deflate of ~0.9 GB a downlink and
    ~0.6 GB an uplink, the uplink encoded twice, is host time)."""
    with open(path) as fh:
        spec = json.load(fh)
    pipeline = {hop: [s for s in stages if s != "zlib"]
                for hop, stages in spec["pipeline"].items()}
    return {**spec, "smoke": False, "pipeline": pipeline}


def check_async_kernels(torch, dev, spec: dict) -> dict:
    """B1, B2, B4 and B5 against their plain versions on the card, bitwise,
    at the shapes the full-width async path gives them, from the spec's
    own initial weights: quantize over the uplink's fused blockwise8 group
    and over the downlink's fused nf4 group (the items the spec's rules
    leave to nf4), laid out as ``quantize_batch`` lays them out, the 4-bit
    one compared in chunks of blocks as in :func:`check_fourbit_kernels`;
    dequantize at each group's largest item, its rows copied out of the
    kernel's own output (blocks never span items)."""
    from repro_torch.core.quantization import pack_group
    from repro_torch.fl.job import initial_weights
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_blockwise8 import (
        dequantize_blockwise8,
        quantize_blockwise8,
    )
    from repro_torch.kernels.quant_nf4 import dequantize_4bit, quantize_4bit
    from repro_torch.testing import async_formats

    weights = initial_weights(spec, device=dev)
    names = list(weights)
    up = async_formats(spec, "task_result", names)
    down = async_formats(spec, "task_data", names)
    report = {}

    group = [n for n in names if up[n] == "blockwise8"]
    x2d, spans = pack_group(weights, group, dev, ref.BLOCK8)
    q, am = quantize_blockwise8(x2d)
    q_p, am_p = ref.quantize_blockwise8(x2d)
    if not (torch.equal(q, q_p) and same_bits(torch, am, am_p)):
        fail("async: blockwise8 quantize kernel disagrees with its plain version on the "
             "uplink's fused group")
    del q_p, am_p
    name, shape, _dtype, start, nb = max(spans, key=lambda s: s[4])
    # the item's own buffers, as the wire delivers them (a row slice of
    # absmax need not be 16-byte aligned)
    q_i, am_i = q[start:start + nb].clone(), am[start:start + nb].clone()
    if not same_bits(torch, dequantize_blockwise8(q_i, am_i),
                     ref.dequantize_blockwise8(q_i, am_i)):
        fail(f"async: blockwise8 dequantize kernel disagrees with its plain version at {name}")
    report["uplink"] = {"items": len(group), "blocks": x2d.shape[0],
                        "largest_item": name, "largest_shape": shape}
    del x2d, q, am, q_i, am_i
    release(torch)

    group = [n for n in names if down[n] == "nf4"]
    x2d, spans = pack_group(weights, group, dev, ref.BLOCK4)
    del weights
    p, am = quantize_4bit(x2d, "nf4")
    for lo in range(0, x2d.shape[0], CHUNK_BLOCKS4):
        hi = min(lo + CHUNK_BLOCKS4, x2d.shape[0])
        p_p, am_p = ref.quantize_4bit(x2d[lo:hi], "nf4")
        if not (torch.equal(p[lo:hi], p_p) and same_bits(torch, am[lo:hi], am_p)):
            fail(f"async: nf4 quantize kernel disagrees with its plain version on blocks "
                 f"{lo}:{hi} of the downlink's fused group")
        del p_p, am_p
    name, shape, _dtype, start, nb = max(spans, key=lambda s: s[4])
    p_i, am_i = p[start:start + nb].clone(), am[start:start + nb].clone()
    if not same_bits(torch, dequantize_4bit(p_i, am_i, "nf4"),
                     ref.dequantize_4bit(p_i, am_i, "nf4")):
        fail(f"async: nf4 dequantize kernel disagrees with its plain version at {name}")
    report["downlink"] = {"items": len(group), "blocks": x2d.shape[0],
                          "largest_item": name, "largest_shape": shape}
    del x2d, p, am, p_i, am_i
    release(torch)
    print(f"async kernels agree bitwise with their plain versions at the full-width path's "
          f"shapes: blockwise8 quantize on the uplink group ({report['uplink']['items']} items, "
          f"{report['uplink']['blocks']} blocks), dequantize at "
          f"{report['uplink']['largest_item']} {report['uplink']['largest_shape']}; nf4 "
          f"quantize on the downlink group ({report['downlink']['items']} items, "
          f"{report['downlink']['blocks']} blocks, in chunks of {CHUNK_BLOCKS4}), dequantize "
          f"at {report['downlink']['largest_item']} {report['downlink']['largest_shape']}")
    return report


def async_span_totals(events: list[dict]) -> dict[str, float]:
    """Seconds per phase, summed over the worker threads' overlapping
    spans of the device-synchronised trace (thread time, not wall)."""
    spans = [e for e in events if e.get("ph") == "X"]

    def total(pred):
        return sum(e["dur"] for e in spans if pred(e)) / 1e6

    return {
        "training_s": total(lambda e: e["name"] == "client.train"),
        "encode_s": total(lambda e: e["name"] == "kernel.quantize_batch"),
        "downlink_transmit_s": total(lambda e: e["name"] == "wire.transmit"
                                     and e["args"]["kind"] == "task_data"),
        "uplink_pricing_s": total(lambda e: e["name"] == "wire.transmit"
                                  and e["args"]["kind"] == "task_result"
                                  and e["args"]["count_only"]),
        "uplink_fold_transfer_s": total(lambda e: e["name"] == "wire.transmit"
                                        and e["args"]["kind"] == "task_result"
                                        and e["args"]["streaming_fold"]),
        "fold_s": total(lambda e: e["name"] == "agg.accept_item"),
        "decode_s": total(lambda e: e["name"] == "stage.decode.quantize"),
        "settle_wait_s": total(lambda e: e["name"] == "sched.settle"),
    }


def hop_bytes(job) -> tuple[int, int]:
    """Wire bytes down and up, summed over the run's completed round trips."""
    down = up = 0
    for e in job.sim.scheduler.timeline:
        if e.kind.value == "completion":
            down += e.data["result"].headers["wire_bytes_down"]
            up += e.data["result"].headers["wire_bytes_up"]
    return down, up


def run_async(torch, dev) -> dict:
    """The async runtime at full width: ``streaming_aggregation.json``
    with qwen1.5-0.5b at its published widths, FedBuff over 3 clients
    (6 tasks, buffer 2, 3 in flight) on a hetero fiber/lte network, nf4
    downlink with its per-layer rules, blockwise8 + crc32 uplink folded
    at each completion instant; ``zlib`` dropped. The launch counters are
    zeroed just before the run and read just after, and must equal what
    the path implies (:func:`~repro_torch.testing.async_launches`); the
    runtime must report 6 dispatches and completions, 3 model updates and
    no failure; every
    tensor must move and stay finite. Before the run, the path's kernels
    are held against their plain versions at its own shapes
    (:func:`check_async_kernels`)."""
    from repro_torch.fl.job import build_job
    from repro_torch.kernels import ops
    from repro_torch.testing import async_launches

    spec = async_spec()
    kernels = check_async_kernels(torch, dev, spec)
    torch.cuda.synchronize()
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    job = build_job({**spec, "trace": True}, device=dev)
    result = job.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    names = list(job.init_weights)
    want = {name: 0 for name in ops.KERNELS}
    want.update(async_launches(spec, names))
    print(f"async launches: {launches} (expected {want})")
    if launches != want:
        fail(f"kernel launches on the async path {launches} != {want}")
    stats = result["runtime_stats"]
    if (stats["dispatches"], stats["completions"], stats["model_updates"],
            stats["failed_clients"], stats["dropouts"]) != (6, 6, 3, 0, 0):
        fail(f"async runtime stats {stats}: expected 6 dispatches and completions, "
             "3 model updates, no failures")
    losses = result["history"]
    if len(losses) != 6 or not all(math.isfinite(x) for x in losses):
        fail(f"async: losses not finite: {losses}")
    final, init = result["final_weights"], job.init_weights
    if list(final) != names:
        fail("async: final weights do not have the initial weights' names")
    for name, w in final.items():
        if w.shape != init[name].shape or w.device.type != dev.type:
            fail(f"async: {name}: shape {tuple(w.shape)} on {w.device}")
        if not bool(torch.isfinite(w).all()):
            fail(f"async: {name}: non-finite final weights")
        if torch.equal(w, init[name]):
            fail(f"async: {name} did not move from its initial values")
    down, up = hop_bytes(job)
    largest = max(w.numel() * w.element_size() for w in init.values())
    memory = result["telemetry"]["memory"]
    report = {
        "kernels": kernels,
        "wall_s": wall, "sim_time_s": result["sim_time_s"], "runtime_stats": stats,
        "staleness": job.sim.scheduler.policy.staleness_seen,
        "launches": launches, "losses": losses, "messages": result["messages"],
        "wire_bytes": result["wire_bytes"], "wire_bytes_down": down, "wire_bytes_up": up,
        "params": sum(w.numel() for w in final.values()),
        "largest_item_bytes": largest, "meter_peak_bytes": memory["peak"],
        "meter_peak_over_largest_item": memory["peak"] / largest,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "allocated_before_bytes": allocated_before,
        "spans": async_span_totals(job.sim.tracer.chrome_trace()["traceEvents"]),
    }
    print(f"async: {report['params']} params, {result['messages']} messages, wall "
          f"{wall:.3f} s, sim_time_s {result['sim_time_s']:.6f}, wire bytes down {down} "
          f"up {up} (total {result['wire_bytes']}), staleness {report['staleness']}, "
          f"losses {losses}")
    print(f"async: MemoryMeter peak {memory['peak']} bytes "
          f"({report['meter_peak_over_largest_item']:.3f} x the largest item, "
          f"{largest} bytes); max_memory_allocated {report['max_memory_allocated_bytes']} "
          f"bytes ({allocated_before} before)")
    print("async spans (s, summed over threads): " + ", ".join(
        f"{k}={v:.4f}" for k, v in report["spans"].items()))
    del job, result, final, init
    release(torch)
    return report


def timeline(job) -> list[tuple]:
    return [(e.kind.value, e.client, e.time, e.seq) for e in job.sim.scheduler.timeline]


def check_async_against_cpu(torch, dev) -> dict:
    """Both async example specs as they stand (smoke width, zlib), card vs
    CPU from identical weights. Fixed updates: the timeline, runtime stats,
    ``sim_time_s``, each completion's wire bytes and the final weights must
    be identical. Trained: the event order, counts and staleness must be
    identical, times and wire bytes within 1e-4 relative (the loss in each
    header and zlib's input differ in the last bits), and the weights
    within C1's bound of the CPU's (:func:`~repro_torch.testing.c1_counts`, which
    tests/test_torch_slice_async.py holds the reference to as well). Then
    ``python -m repro_torch.fl.job`` runs ``streaming_aggregation.json``
    unchanged on the card."""
    from repro_torch.fl.job import build_job, initial_weights, normalize_spec
    from repro_torch.testing import c1_counts, fixed_train_fn

    out = {}
    for path in (ASYNC_JOB, ASYNC_HETERO_JOB):
        label = os.path.basename(path)
        with open(path) as fh:
            spec = json.load(fh)
        init = {k: v.numpy() for k, v in initial_weights(spec, device="cpu").items()}
        runs = {}
        for fixed in (True, False):
            for d in ("cpu", dev):
                jb = build_job(spec, device=d, weights=init)
                if fixed:
                    for i, proxy in enumerate(jb.sim.proxies):
                        proxy.executor.train_fn = fixed_train_fn(init, i, 0.05 * (i + 1))
                res = jb.run()
                runs[(fixed, str(d))] = (
                    timeline(jb), res["runtime_stats"], res["sim_time_s"],
                    [(e.client, e.data["result"].headers["wire_bytes_down"],
                      e.data["result"].headers["wire_bytes_up"])
                     for e in jb.sim.scheduler.timeline if e.kind.value == "completion"],
                    {k: v.cpu() for k, v in res["final_weights"].items()},
                    jb.sim.scheduler.policy.staleness_seen)
        want, got = runs[(True, "cpu")], runs[(True, str(dev))]
        if got[:4] != want[:4] or got[5] != want[5]:
            fail(f"{label} fixed updates: timeline, stats, sim time or wire bytes differ "
                 "between card and CPU")
        for name, w in want[4].items():
            if not torch.equal(bits(torch, got[4][name]), bits(torch, w)):
                fail(f"{label} fixed updates: weights differ between card and CPU at {name}")
        want, got = runs[(False, "cpu")], runs[(False, str(dev))]
        order = [[e[:2] + e[3:] for e in r[0]] for r in (want, got)]
        stats = [{k: v for k, v in r[1].items() if k != "sim_time_s"} for r in (want, got)]
        if order[0] != order[1] or stats[0] != stats[1] or want[5] != got[5]:
            fail(f"{label} trained: event order, stats or staleness differ between card "
                 "and CPU")
        t_rel = max(abs(a[2] - b[2]) / max(abs(b[2]), 1e-30)
                    for a, b in zip(got[0], want[0]))
        b_rel = max(abs(a[2] - b[2]) / b[2] for a, b in zip(got[3], want[3]))
        if t_rel > 1e-4 or b_rel > 1e-4:
            fail(f"{label} trained: times ({t_rel:.3g}) or uplink bytes ({b_rel:.3g}) "
                 "differ by more than 1e-4 relative")
        c1 = c1_counts(want[4], got[4],
                       2 * normalize_spec(spec)["lr"] * spec["local_steps"])
        print(f"{label}, smoke width, card vs CPU: fixed updates identical (timeline of "
              f"{len(want[0])} events, sim_time_s {runs[(True, 'cpu')][2]:.6f}, weights "
              f"bitwise); trained: same event order and stats, times within {t_rel:.3g}, "
              f"uplink bytes within {b_rel:.3g}; of {c1['elements']} elements "
              f"{c1['beyond_step']} beyond the step bound (worst {c1['worst_of_step']:.4f} of "
              f"it), {c1['beyond_gap']} beyond the gap bound (worst {c1['worst_of_gap']:.4f})")
        if not c1["holds"]:
            fail(f"{label} trained: the card's weights are beyond C1's bound of the CPU's: {c1}")
        out[label] = {"sim_time_s": want[2], "completions": want[1]["completions"],
                      "trained_time_rel": t_rel, "trained_bytes_rel": b_rel, "trained_c1": c1}

    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.fl.job", ASYNC_JOB],
                          capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    if proc.returncode != 0:
        fail(f"python -m repro_torch.fl.job {os.path.relpath(ASYNC_JOB, REPO)} exited "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    summary = json.loads(proc.stdout)
    rs = summary["runtime_stats"]
    if (summary["policy"] != "fedbuff" or rs["completions"] != 6 or rs["model_updates"] != 3
            or len(summary["history"]) != 6
            or not all(math.isfinite(x) for x in summary["history"])):
        fail(f"the job entry point's async summary on the card is wrong: {summary}")
    print(f"python -m repro_torch.fl.job streaming_aggregation.json on the card: "
          f"{summary['messages']} messages, {summary['wire_bytes']} wire bytes, "
          f"sim_time_s {summary['sim_time_s']:.6f}, losses {summary['history']}")
    out["cli"] = {k: summary[k] for k in ("messages", "wire_bytes", "sim_time_s", "history")}
    return out


def check_secure_agg_against_cpu(torch, dev) -> dict:
    """Secure aggregation card vs CPU on a full-width qwen1.5-0.5b item
    (:data:`SECURE_AGG_SHAPES`), 3 clients: each client's masked ``uint32``
    grid and the unmasked mean bitwise equal, and the masks cancel (the
    masked grids sum to the plain grids mod 2**32)."""
    from repro_torch.core import secure_agg as sa
    from repro_torch.core.messages import Message, MessageKind

    gen = torch.Generator().manual_seed(0)
    shapes = SECURE_AGG_SHAPES
    clients = [0, 1, 2]
    payloads = [{k: torch.randn(s, generator=gen) * 0.02 for k, s in shapes.items()}
                for _ in clients]
    outs = {}
    for d in ("cpu", dev):
        agg = sa.SecureAggregator(len(clients), device=d)
        masked = []
        for i, p in zip(clients, payloads):
            m = sa.SecureMaskFilter(i, clients, base_seed=7, device=d).process(
                Message(MessageKind.TASK_RESULT, dict(p), {"round": 0, "num_samples": 4}))
            masked.append({k: v.cpu() for k, v in m.payload.items()})
            agg.accept(m)
        outs[str(d)] = (masked, {k: v.cpu() for k, v in agg.finish().items()})
    (want_m, want), (got_m, got) = outs["cpu"], outs[str(dev)]
    for i in clients:
        for k in shapes:
            if not torch.equal(got_m[i][k].to(torch.int64), want_m[i][k].to(torch.int64)):
                fail(f"secure-agg: client {i}'s masked grid {k} differs between card and CPU")
    for k in shapes:
        if not torch.equal(bits(torch, got[k]), bits(torch, want[k])):
            fail(f"secure-agg: the unmasked mean of {k} differs between card and CPU")
        total = sum(m[k].to(torch.int64) for m in got_m) % sa.MOD
        plain = sum(sa._to_grid(p[k]) for p in payloads) % sa.MOD
        if not torch.equal(total, plain):
            fail(f"secure-agg: the masks of {k} do not cancel")
    n = sum(math.prod(s) for s in shapes.values())
    print(f"secure-agg, {len(clients)} clients x {n} values, card vs CPU: masked grids and "
          "unmasked means bitwise equal; masks cancel")
    return {"values": n, "clients": len(clients)}


def lora_spec(layers: int | None = None) -> dict:
    """``examples/jobs/lora_federation.json`` at full width; at ``layers``
    of the model's layers (the job spec's ``num_layers``) when given."""
    with open(LORA_JOB) as fh:
        spec = {**json.load(fh), "smoke": False}
    return spec if layers is None else {**spec, "num_layers": layers}


def time_svd_drivers(torch, dev) -> dict:
    """With ``--svd-drivers`` only: each cuSOLVER SVD driver of
    :data:`SVD_DRIVERS` once on the path's largest decomposed item,
    :data:`SVD_SHAPE` (``blocks.mlp.w_up`` / ``w_gate`` with their 16
    layers collapsed), the measurement that chose ``ops.SVD_DRIVER`` (the
    path never runs ``gesvdj``), on seeded weight-like values: host clock around
    work ending in a synchronise, and the truncation's fidelity,
    ``||x - U_8 S_8 V_8||_F^2`` against the discarded ``sum sigma_i^2``
    (i >= 8), relative to ``||x||_F^2``. (That ``ops.SVD_DRIVER`` gives
    the same bits twice is check (a), :func:`check_lora_items`.)"""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn(SVD_SHAPE, generator=gen, device=dev) * 0.02
    x64 = x.double()
    total = float((x64 ** 2).sum())
    out = {}
    for driver in SVD_DRIVERS:
        release(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, s, vt = torch.linalg.svd(x, full_matrices=False, driver=driver)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        resid = (x64 - (u[:, :8].double() * s[:8].double()) @ vt[:8].double()).norm() ** 2
        fidelity = float((resid - (s[8:].double() ** 2).sum()).abs()) / total
        out[driver] = {"ms": ms, "fidelity_rel": fidelity, "sigma_top8": s[:8].tolist()}
        print(f"svd {driver} {SVD_SHAPE}: {ms:.1f} ms, fidelity {fidelity:.2e} of ||x||^2, "
              f"sigma_1..8 {[round(v, 5) for v in s[:8].tolist()]}")
        del u, s, vt, resid
    top = [torch.tensor(out[d]["sigma_top8"], dtype=torch.float64) for d in SVD_DRIVERS]
    out["sigma_top8_rel_diff"] = float(((top[0] - top[1]).abs() / top[0]).max())
    print(f"svd drivers: top-8 singular values agree within {out['sigma_top8_rel_diff']:.2e}; "
          f"the path uses {ops.SVD_DRIVER}")
    del x, x64
    release(torch)
    return out


def check_lora_items(torch, dev) -> dict:
    """Check (a) on every full-width item the ``lora`` stage decomposes,
    from the seeded full-width weights: the whole uplink stack encodes
    the same payload twice to the same wire bytes; each factor pair is
    canonical (the first largest-|b| entry of each row is positive); the
    kept ``sigma_i`` (the norms of ``a``'s columns: ``a = U_r S_r`` up to
    signs) are the item's top ``r`` singular values, held against the
    square roots of the top eigenvalues of its float64 Gram matrix
    (``torch.linalg.eigvalsh``, no SVD) within :data:`LORA_SIGMA_TOL`
    units of ``eps sqrt(m n) sigma_1``; and ``||x - a b||_F^2``
    equals ``||x||_F^2 - sum_i ||a_i||^2`` within
    :data:`LORA_FIDELITY_TOL` of the kept mass. The last two together
    make ``||x - a b||_F^2`` the discarded mass of the top ``r``
    singular values, the Eckart–Young optimum, to the SVD's own
    accuracy; the float64 gap ``sigma_r - sigma_{r+1}`` in the same units
    says whether that accuracy tells the ``r``-th direction from the
    ``r+1``-th (below one unit no fp32 SVD can: random weights have
    nearly equal top singular values).
    The first encode is traced: its ``kernel.lora_decompose`` spans
    (device-synchronised) are the SVD time of each item (check d)."""
    from repro_torch.core.messages import Message, MessageKind
    from repro_torch.core.pipeline import build_pipeline
    from repro_torch.core.serialization import join_views
    from repro_torch.fl.job import initial_weights
    from repro_torch.obs import Tracer
    from repro_torch.obs import trace as obs_trace
    from repro_torch.peft.lowrank import LowRankDelta
    from repro_torch.testing import lora_factor_bytes
    from repro_torch.utils.trees import as_tensor

    release(torch)
    spec = lora_spec(LORA_LAYERS)
    state = initial_weights(spec, device=dev)
    stack = spec["pipeline"]["task_result_out"]

    def encode():
        p = build_pipeline(stack, decode_values=False, device=dev)
        msg, ctx = p.begin_encode(Message(MessageKind.TASK_RESULT, dict(state),
                                          {"client": "site-0", "round": 0, "num_samples": 4}))
        return p, [(n, join_views(v)) for n, v in p.iter_encode_views(msg, ctx)]

    tracer = Tracer(sync=torch.cuda.synchronize)
    t0 = time.perf_counter()
    with obs_trace.activate(tracer):
        p, first = encode()
    encode_s = time.perf_counter() - t0
    svd_ms = {e["args"]["item"]: e["dur"] / 1e3 for e in tracer.chrome_trace()["traceEvents"]
              if e.get("name") == "kernel.lora_decompose"}
    second = encode()[1]
    if first != second:
        differ = [n for (n, a), (_, b) in zip(first, second) if a != b]
        fail(f"lora: encoding the same payload twice gave different wire bytes for {differ}")
    dec = p.decoder()
    items = {}
    for name, blob in first:
        _, value, _ = dec.decode_item(blob)
        if isinstance(value, LowRankDelta):
            x = state[name].reshape(-1, state[name].shape[-1]).double()
            a, b = as_tensor(value.a, dev), as_tensor(value.b, dev)
            r = b.shape[0]
            rows = torch.arange(r, device=dev)
            canonical = bool((b[rows, b.abs().argmax(dim=1)] > 0).all())
            kept = float((a.double() ** 2).sum())
            resid = float(((x - a.double() @ b.double()) ** 2).sum())
            total = float((x ** 2).sum())
            # a zero item (the norms start at zero) keeps and discards nothing
            err = abs(resid - (total - kept)) / kept if kept else abs(resid - total)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gram = x.T @ x if x.shape[1] <= x.shape[0] else x @ x.T
            sigma64 = torch.linalg.eigvalsh(gram).flip(0)[:r + 1].clamp_min(0).sqrt()
            torch.cuda.synchronize()
            eig_ms = (time.perf_counter() - t0) * 1e3
            unit = max(2.0 ** -24 * math.sqrt(x.numel()) * float(sigma64[0]), 1e-300)
            sigma_err = float((a.double().norm(dim=0) - sigma64[:r]).abs().max()) / unit
            gap = float(sigma64[r - 1] - sigma64[r]) / unit
            items[name] = {"shape": list(x.shape), "svd_ms": svd_ms[name], "canonical": canonical,
                           "fidelity_rel_of_kept": err, "kept_share": kept / max(total, 1e-300),
                           "sigma_err_units": sigma_err, "sigma_gap_units": gap,
                           "sigma64_top": sigma64.tolist(), "eigvalsh_ms": eig_ms}
            print(f"lora (a) {name} {tuple(x.shape)}: svd {svd_ms[name]:.1f} ms, canonical "
                  f"{canonical}, ||x-ab||^2 vs discarded mass {err:.2e} of the kept "
                  f"{kept:.4g} ({100 * kept / max(total, 1e-300):.4f} % of ||x||^2); kept "
                  f"sigma vs float64 Gram eigvalsh {sigma_err:.3g} units of eps sqrt(mn) "
                  f"sigma_1 (sigma_{r} - sigma_{r + 1} = {gap:.3g} units; eigvalsh "
                  f"{eig_ms:.0f} ms)")
            if not canonical or err > LORA_FIDELITY_TOL or sigma_err > LORA_SIGMA_TOL:
                fail(f"lora (a): {name}: canonical {canonical}, fidelity {err:.3e}, kept "
                     f"sigma {sigma_err:.3g} units from the float64 eigensolve's")
            del x, a, b, gram, sigma64
    if set(items) != set(lora_factor_bytes(spec, {k: tuple(v.shape)
                                                  for k, v in state.items()})[1]):
        fail(f"lora (a): decomposed {sorted(items)}")
    print(f"lora (a): {len(items)} items decomposed, the uplink encoded twice to the same "
          f"{sum(len(b) for _, b in first)} bytes; first encode {encode_s:.2f} s, SVDs "
          f"{sum(svd_ms.values()) / 1e3:.2f} s")
    del state, first, second
    release(torch)
    return {"items": items, "encode_s": encode_s, "svd_s": sum(svd_ms.values()) / 1e3}


def check_topk_bf16(torch, dev) -> dict:
    """Check (c) on the full-width item :data:`TOPK_BF16_ITEM` (seeded
    weights, with NaNs of both signs, ±inf, ±0 and repeated magnitudes
    written in at seeded places): ``topk`` (stable sort on the card)
    against the reference's numpy selection on the host, and ``bf16``
    (bit arithmetic on the card) against the same on the CPU — the
    SparseTensor, the bf16 words, the widened values and each stage's
    envelope bitwise. Also what torch's own card cast gives for NaNs."""
    from repro_torch.core import quantization as q
    from repro_torch.core.messages import Message, MessageKind
    from repro_torch.core.pipeline import build_pipeline, registered_stages
    from repro_torch.core.serialization import join_views
    from repro_torch.core.sparse import topk_sparsify
    from repro_torch.fl.job import initial_weights

    release(torch)
    x = initial_weights(lora_spec(), device=dev)[TOPK_BF16_ITEM].contiguous()
    flat = x.view(-1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    pos = torch.randint(0, flat.numel(), (4096,), generator=gen, device=dev)
    specials = np.asarray([0x7FC00000, 0xFFC12345, 0x7F800001, 0x7F800000, 0xFF800000,
                           0x00000000, 0x80000000, 0x00000001], np.uint32).view(np.float32)
    flat[pos[:8]] = torch.from_numpy(specials).to(dev)
    # one magnitude, both signs, at the other places: ties the sort must keep in index order
    flat[pos[8:]] = torch.where(pos[8:] % 2 == 0, 1.0, -1.0) * flat[pos[8]].abs()
    host = x.cpu()
    out = {"item": TOPK_BF16_ITEM, "shape": list(x.shape),
           "zstd_registered": "zstd" in registered_stages()}
    print(f"zstd stage registered on this machine: {out['zstd_registered']}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = topk_sparsify(x, TOPK_FRACTION)
    out["topk_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = topk_sparsify(host.numpy(), TOPK_FRACTION)
    out["topk_host_numpy_s"] = time.perf_counter() - t0
    topk_same = (card.indices.tobytes() == plain.indices.tobytes()
                 and card.values.tobytes() == plain.values.tobytes())

    narrow = q.narrow_bf16(x)
    narrow_cpu = q.narrow_bf16(host)
    bf16_same = torch.equal(narrow.view(torch.int16).cpu(), narrow_cpu.view(torch.int16))
    widen_same = torch.equal(bits(torch, q.widen_bf16(narrow).cpu()),
                             bits(torch, q.widen_bf16(narrow_cpu)))
    own = x.to(torch.bfloat16).view(torch.int16)
    differ = own != narrow.view(torch.int16)
    nan_words = sorted({int(w) & 0xFFFF for w in own[torch.isnan(x)].tolist()})
    out["torch_card_cast"] = {"words_differing": int(differ.sum()),
                              "of_them_nan": int((differ & torch.isnan(x)).sum()),
                              "nan_words": [f"0x{w:04x}" for w in nan_words]}

    envelopes_same = {}
    for stack in ([f"topk:{TOPK_FRACTION}", "crc32"], ["quantize:bf16", "crc32"]):
        blobs = []
        for d, value in ((dev, x), ("cpu", host)):
            p = build_pipeline(stack, device=d)
            msg, ctx = p.begin_encode(Message(MessageKind.TASK_RESULT,
                                              {TOPK_BF16_ITEM: value}, {"round": 0}))
            blobs.append([join_views(v) for _n, v in p.iter_encode_views(msg, ctx)])
        envelopes_same[stack[0]] = blobs[0] == blobs[1]
    out.update(topk_bitwise=topk_same, bf16_bitwise=bf16_same, widen_bitwise=widen_same,
               envelopes_bitwise=envelopes_same, topk_k=int(card.values.size))
    print(f"(c) {TOPK_BF16_ITEM} {tuple(x.shape)}: topk:{TOPK_FRACTION} card vs host numpy "
          f"bitwise {topk_same} (k {card.values.size}; card {out['topk_card_s']:.3f} s, "
          f"numpy {out['topk_host_numpy_s']:.3f} s); bf16 card vs CPU bitwise {bf16_same}, "
          f"widened {widen_same}; envelopes {envelopes_same}; torch's own card cast differs "
          f"in {out['torch_card_cast']['words_differing']} words "
          f"({out['torch_card_cast']['of_them_nan']} NaN), NaN words {nan_words}")
    if not (topk_same and bf16_same and widen_same and all(envelopes_same.values())):
        fail(f"(c) topk / bf16 card vs CPU: {out}")
    del x, host, card, narrow, own
    release(torch)
    return out


def lora_phases(events: list[dict]) -> dict:
    """Per-phase wall seconds of the lora round from its device-synchronised
    spans, and the SVD and merge time of each item (check d)."""
    spans = [e for e in events if e.get("ph") == "X"]

    def total(pred):
        return sum(e["dur"] for e in spans if pred(e)) / 1e6

    def per_item(name):
        out: dict[str, list[float]] = {}
        for e in spans:
            if e["name"] == name:
                out.setdefault(e["args"]["item"], []).append(e["dur"] / 1e3)
        return {k: {"ms_mean": float(np.mean(v)), "calls": len(v)} for k, v in out.items()}

    phases = {
        "downlink_transmit_s": total(lambda e: e["name"] == "wire.transmit"
                                     and e["args"]["kind"] == "task_data"),
        "uplink_transmit_s": total(lambda e: e["name"] == "wire.transmit"
                                   and e["args"]["kind"] == "task_result"),
        "local_steps_s": total(lambda e: e["name"] == "client.train"),
        "svd_s": total(lambda e: e["name"] == "kernel.lora_decompose"),
        "uplink_nf4_encode_s": total(lambda e: e["name"] == "stage.encode.quantize"),
        "merge_s": total(lambda e: e["name"] == "kernel.lora_merge"),
        "finish_s": total(lambda e: e["name"] == "agg.finish"),
    }
    uplinks = [e["args"]["wire_bytes"] for e in spans
               if e["name"] == "wire.transmit" and e["args"]["kind"] == "task_result"]
    return {"phases": phases, "svd_ms": per_item("kernel.lora_decompose"),
            "merge_ms": per_item("kernel.lora_merge"), "uplink_wire_bytes": uplinks}


def check_lora_kernels(torch, dev, spec: dict, inputs: list) -> dict:
    """B4 and B5 against their plain versions on the card, bitwise, at the
    lora path's own inputs: each ``(name, value)`` the uplink's
    ``quantize`` stage took (the item the ``lora`` stage left, as each
    client sent it), laid out as the stage lays it out, B4's codes and
    absmax against the plain quantize, then B5 on those codes (what the
    server's ``lora-fedavg`` runs) against the plain dequantize."""
    from repro_torch.core.pipeline import build_stage
    from repro_torch.core.quantization import pack_group
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_nf4 import dequantize_4bit, quantize_4bit

    fmt = next(s.fmt for s in map(build_stage, spec["pipeline"]["task_result_out"])
               if s.name == "quantize")
    for i, (name, value) in enumerate(inputs):
        x2d, _ = pack_group({name: value}, [name], dev, ref.BLOCK4)
        p, am = quantize_4bit(x2d, fmt)
        p_p, am_p = ref.quantize_4bit(x2d, fmt)
        if not (torch.equal(p, p_p) and same_bits(torch, am, am_p)):
            fail(f"lora: {fmt} quantize kernel disagrees with its plain version on "
                 f"{name} {tuple(value.shape)}, input {i}")
        if not same_bits(torch, dequantize_4bit(p, am, fmt), ref.dequantize_4bit(p, am, fmt)):
            fail(f"lora: {fmt} dequantize kernel disagrees with its plain version on "
                 f"{name} {tuple(value.shape)}, input {i}")
    shapes = sorted({(n, tuple(v.shape)) for n, v in inputs})
    print(f"lora kernels agree bitwise with their plain versions on the path's own "
          f"{len(inputs)} inputs: {fmt} quantize and dequantize at {shapes}")
    return {"inputs": len(inputs), "items": [list(x) for x in shapes], "fmt": fmt}


def run_lora(torch, dev) -> dict:
    """The lora path: ``lora_federation.json`` at full-width llama3.2-1b
    (:func:`lora_spec`), the counters zeroed just before and read just
    after; B4 and B5 as :func:`~repro_torch.testing.lora_launches`
    implies and nothing else, then each held against its plain version on
    the values B4 took (:func:`check_lora_kernels`: the initial one and
    every client's); every uplink carries the factor bytes the shapes
    imply (:func:`~repro_torch.testing.lora_factor_bytes`) plus the
    leftover nf4 items and framing; finite losses and weights; SVD and
    merge times per item (check d)."""
    from repro_torch.fl.job import build_job
    from repro_torch.kernels import ops
    from repro_torch.testing import lora_factor_bytes, lora_launches

    spec = lora_spec(LORA_LAYERS)
    uplinks = spec["clients"] * spec["rounds"]
    torch.cuda.synchronize()
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    job = build_job({**spec, "trace": True}, device=dev)
    shapes = {k: tuple(v.shape) for k, v in job.init_weights.items()}
    want = lora_launches(spec, shapes)
    factor_bytes, factored = lora_factor_bytes(spec, shapes)
    # keep what each uplink's quantize stage takes: the items lora leaves
    quantized = [(n, job.init_weights[n].clone()) for n in shapes if n not in factored]
    hops = {id(p.pipelines["task_result"]): p.pipelines["task_result"]
            for p in job.sim.proxies}
    for pipeline in hops.values():
        def record(name, value, ctx, _encode=pipeline.encode_wire_item_views):
            if name not in factored:
                quantized.append((name, torch.as_tensor(value, device=dev).clone()))
            return _encode(name, value, ctx)
        pipeline.encode_wire_item_views = record
    ops.reset_launch_counts()
    result = job.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    want = {name: want.get(name, 0) for name in launches}
    print(f"lora launches: {launches} (expected {want})")
    if launches != want:
        fail(f"kernel launches on the lora path {launches} != {want}")
    if len(quantized) != len(shapes) - len(factored) + want["quantize_4bit"]:
        fail(f"lora: {len(quantized)} quantize inputs kept for {want['quantize_4bit']} "
             "launches")
    kernels = check_lora_kernels(torch, dev, spec, quantized)
    del quantized
    losses = result["history"]
    if len(losses) != uplinks or not all(math.isfinite(x) for x in losses):
        fail(f"lora: losses {losses}")
    if result["messages"] != 2 * uplinks:
        fail(f"lora: {result['messages']} messages for {uplinks} uplinks")
    final = result["final_weights"]
    if set(final) != set(shapes) or not all(bool(torch.isfinite(w).all())
                                                for w in final.values()):
        fail("lora: final weights not finite or not the model's items")
    trace = lora_phases(job.sim.tracer.chrome_trace()["traceEvents"])
    up = trace["uplink_wire_bytes"]
    # leftovers: nf4 payload and absmax of each item the stage skips
    leftover = sum(math.ceil(math.prod(s) / 64) * (32 + 4) for n, s in shapes.items()
                   if n not in factored)
    if len(up) != uplinks or not all(factor_bytes + leftover < b < factor_bytes + leftover
                                     + (64 << 10) for b in up):
        fail(f"lora: uplink wire bytes {up}; factors {factor_bytes}, nf4 {leftover}")
    if set(trace["svd_ms"]) != set(factored) or set(trace["merge_ms"]) != set(factored):
        fail(f"lora: decomposed {sorted(trace['svd_ms'])}, merged {sorted(trace['merge_ms'])}")
    n_params = sum(math.prod(s) for s in shapes.values())
    report = {"spec": {k: spec[k] for k in ("clients", "rounds", "local_steps", "batch", "seq")},
              "wall_s": wall, "losses": losses, "launches": launches,
              "messages": result["messages"], "wire_bytes": result["wire_bytes"],
              "factor_bytes_per_uplink": factor_bytes, "nf4_bytes_per_uplink": leftover,
              "dense_fp32_bytes": 4 * n_params, "factored_items": factored,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "round_wall_s": [r["wall_s"] for r in result["round_log"]],
              "kernels_vs_plain": kernels, **trace}
    print(f"lora: {uplinks} uplinks of {up} bytes (factors {factor_bytes}, nf4 {leftover}; "
          f"dense fp32 {4 * n_params}, {4 * n_params / up[0]:.1f} x), "
          f"{result['wire_bytes']} wire bytes, losses {losses}, wall {wall:.3f} s")
    print("lora phases (s): " + ", ".join(f"{k}={v:.4f}" for k, v in trace["phases"].items()))
    for name in factored:
        print(f"lora {name} {shapes[name]}: svd {trace['svd_ms'][name]['ms_mean']:.1f} ms "
              f"(x{trace['svd_ms'][name]['calls']}), merge "
              f"{trace['merge_ms'][name]['ms_mean']:.2f} ms (x{trace['merge_ms'][name]['calls']})")
    print(f"lora max_memory_allocated: {report['max_memory_allocated_bytes']} bytes")
    del job, result, final
    release(torch)
    return report


def check_lora_against_cpu(torch, dev) -> dict:
    """Check (b): ``lora_federation.json`` as it stands (smoke width) on
    the card and on the CPU from the same weights, each client a fixed
    seeded update — Gaussian (``fixed_train_fn``) and with a
    well-separated rank-8 part (``separated_train_fn``, where the bound is
    tight enough to catch a TF32 merge): the same messages; uplink
    envelopes as :func:`~repro_torch.testing.lora_wire_compare` requires
    (the nf4 items bitwise, the byte totals apart only by the crc32 digits
    of the factor items); the nf4-folded global items bitwise and every
    other within its :func:`~repro_torch.testing.lora_fixed_bounds`, each
    item's reading and bound printed. Also ``python -m
    repro_torch.fl.job`` on the spec file, on the card."""
    from repro_torch.fl.job import build_job, initial_weights
    from repro_torch.testing import (
        envelope_log,
        fixed_train_fn,
        lora_factor_bytes,
        lora_fixed_bounds,
        lora_wire_compare,
        relative_errors,
        separated_train_fn,
    )

    with open(LORA_JOB) as fh:
        spec = json.load(fh)
    init = {k: v.numpy() for k, v in initial_weights(spec, device="cpu").items()}
    factored = lora_factor_bytes(spec, {k: v.shape for k, v in init.items()})[1]
    nf4_items = [n for n in init if n not in factored]
    report = {}
    for label, train_fn in (("gaussian", fixed_train_fn), ("separated", separated_train_fn)):
        outs, logs = {}, {}
        for d in ("cpu", dev):
            job = build_job(spec, device=d, weights=init)
            logs[str(d)] = envelope_log(job.sim.proxies[0].pipelines["task_result"])
            for i, proxy in enumerate(job.sim.proxies):
                proxy.executor.train_fn = train_fn(init, i, 0.05 * (i + 1))
            outs[str(d)] = job.run()
        want, got = outs["cpu"], outs[str(dev)]
        cmp = lora_wire_compare(logs["cpu"], logs[str(dev)])
        errs = relative_errors({k: v.cpu() for k, v in want["final_weights"].items()},
                               {k: v.cpu() for k, v in got["final_weights"].items()})
        nf4_bitwise = all(torch.equal(bits(torch, got["final_weights"][n].cpu()),
                                      bits(torch, want["final_weights"][n])) for n in nf4_items)
        bounds = lora_fixed_bounds(spec, init, {k: v.numpy() for k, v in
                                                want["final_weights"].items()},
                                   factored, train_fn)
        share = {n: errs[n] / bounds[n] for n in factored}
        ok = (cmp["holds"] and got["messages"] == want["messages"] and nf4_bitwise
              and got["wire_bytes"] - want["wire_bytes"] == cmp["crc_digit_diff"]
              and max(share.values()) <= 1)
        worst = max(share, key=share.get)
        print(f"lora (b) smoke card vs CPU, {label} fixed updates: {got['messages']} "
              f"messages, wire {got['wire_bytes']} vs {want['wire_bytes']} bytes ({cmp}); "
              f"nf4 items {nf4_items} bitwise {nf4_bitwise}; factored items within "
              f"{max(errs[n] for n in factored):.2e} relative, at most {share[worst]:.3f} of "
              f"their SVD bound ({worst})")
        print(f"lora (b) {label} per item (card vs CPU relative error / bound): " + ", ".join(
            f"{n} {errs[n]:.3e} / {bounds[n]:.3e}" for n in factored))
        if not ok:
            fail(f"lora (b) {label}: card vs CPU {cmp}, {errs}, bounds {bounds}")
        report[label] = {"wire": cmp, "rel_errors": errs, "bounds": bounds,
                         "nf4_bitwise": nf4_bitwise}
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    cli = subprocess.run([sys.executable, "-m", "repro_torch.fl.job", LORA_JOB],
                         capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    if cli.returncode != 0:
        fail(f"python -m repro_torch.fl.job {os.path.relpath(LORA_JOB, REPO)} exited "
             f"{cli.returncode}: {cli.stderr[-2000:]}")
    summary = json.loads(cli.stdout)
    if summary["messages"] != want["messages"] or not all(
            math.isfinite(x) for x in summary["history"]):
        fail(f"python -m repro_torch.fl.job lora_federation.json: {summary['messages']} "
             f"messages, losses {summary['history']}")
    print(f"python -m repro_torch.fl.job lora_federation.json on the card: "
          f"{summary['messages']} messages, {summary['wire_bytes']} wire bytes, "
          f"{time.perf_counter() - t0:.1f} s")
    return {**report, "cli_messages": summary["messages"],
            "cli_wire_bytes": summary["wire_bytes"]}


def serialized_nbytes(payload: dict) -> int:
    """The container blob's length (item count + every item), summed from
    each item's views without joining them."""
    from repro_torch.core.serialization import serialize_item_views, views_nbytes

    return 4 + sum(views_nbytes(serialize_item_views(n, v)) for n, v in payload.items())


def table2(torch, dev) -> tuple[dict, dict]:
    """Paper Table II on the card: the full-width llama3.2-1b global state
    through ``QuantizeFilter`` in each format (one launch per item for the
    blocked formats), its serialized bytes counted from the item views,
    beside ``message_size_report`` (the byte model), the fp32 bytes and
    the paper's share of fp32. Returns the rows and the blockwise8
    message, copied to the host, for Table III."""
    from repro_torch.core.filters import QuantizeFilter
    from repro_torch.core.messages import Message, MessageKind
    from repro_torch.core.quantization import QuantizedTensor, message_size_report
    from repro_torch.fl.job import initial_weights
    from repro_torch.kernels import ops

    release(torch)
    state = initial_weights(legacy_spec(), device=dev)
    n_params = sum(v.numel() for v in state.values())
    if n_params != LLAMA_PARAMS or len(state) != N_ITEMS:
        fail(f"Table II: the llama3.2-1b state has {n_params} parameters in {len(state)} items")
    fp32_bytes = 4 * n_params
    launches_of = {"blockwise8": "quantize_blockwise8", "nf4": "quantize_4bit",
                   "fp4": "quantize_4bit"}
    rows, bw8_host = {}, None
    print(f"Table II: {n_params} parameters in {len(state)} items, fp32 {fp32_bytes} bytes")
    for fmt in TABLE2_FORMATS:
        msg = Message(MessageKind.TASK_DATA, dict(state), {})
        filt = QuantizeFilter(fmt, device=dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        q = filt.process(msg)
        torch.cuda.synchronize()
        quantize_ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        want = {name: 0 for name in ops.KERNELS}
        if fmt in launches_of:
            want[launches_of[fmt]] = N_ITEMS
        if launches != want:
            fail(f"Table II {fmt}: launches {launches} != {want}")
        nbytes = serialized_nbytes(q.payload)
        report = message_size_report(state, fmt)
        pct = 100.0 * nbytes / fp32_bytes
        payload_meta = sum(v.total_bytes for v in q.payload.values())
        rows[fmt] = {"serialized_bytes": nbytes, "payload_meta_bytes": payload_meta,
                     "fp32_bytes": fp32_bytes, "fp32_pct": pct,
                     "report_fp32_pct": report["fp32_pct"], "report_total_mb": report["total_mb"],
                     "paper_fp32_pct": PAPER_TABLE2_PCT.get(fmt),
                     "quantize_filter_ms": quantize_ms, "launches": launches}
        print(f"Table II {fmt}: {nbytes} serialized bytes ({payload_meta} payload + meta), "
              f"{pct:.3f} % of fp32; byte model {report['fp32_pct']:.3f} % "
              f"({report['total_mb']:.2f} MB); paper {PAPER_TABLE2_PCT.get(fmt)} %; "
              f"QuantizeFilter {quantize_ms:.2f} ms on the card")
        if abs(pct - report["fp32_pct"]) > 0.01:
            fail(f"Table II {fmt}: {pct:.4f} % of fp32 measured, {report['fp32_pct']:.4f} % "
                 "by the byte model")
        if fmt in PAPER_TABLE2_PCT and abs(pct - PAPER_TABLE2_PCT[fmt]) > 0.05:
            fail(f"Table II {fmt}: {pct:.4f} % of fp32, the paper has {PAPER_TABLE2_PCT[fmt]} %")
        if fmt == "blockwise8":
            bw8_host = {n: QuantizedTensor(v.payload.cpu().numpy(), v.absmax.cpu().numpy(),
                                           v.fmt, v.orig_shape, v.orig_dtype)
                        for n, v in q.payload.items()}
        del msg, q
        release(torch)
    del state
    release(torch)
    return rows, bw8_host


def reset_rss_peak() -> bool:
    """Reset this process's VmHWM (Linux ``clear_refs`` 5), so the next
    ``rss_peak_kb`` reads one run's peak; False where that is refused."""
    try:
        with open("/proc/self/clear_refs", "w") as fh:
            fh.write("5")
    except OSError:
        return False
    return True


def table3(torch, message: dict) -> dict:
    """Paper Table III on the card's host: the full-width blockwise8
    message sent three ways over the loopback driver at 1 MiB chunks, each
    under a fresh MemoryMeter with the resident-set peak beside it (VmHWM,
    reset before each run where the kernel allows it; else the process's
    ``ru_maxrss``, a peak over all it ran so far) — ObjectStreamer ->
    BlobReceiver (regular), ContainerStreamer -> ContainerReceiver, and
    FileStreamer -> FileReceiver from a file in a temporary directory. What
    arrives must equal what was sent, and the peaks must order regular >
    container > file."""
    import filecmp
    import resource
    import shutil
    import tempfile

    from repro_torch.core import serialization as ser
    from repro_torch.core import streaming as sm
    from repro_torch.utils.mem import MemoryMeter, rss_peak_kb

    host_ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    msg_bytes = serialized_nbytes(message)
    max_item = max(ser.views_nbytes(ser.serialize_item_views(n, v))
                   for n, v in message.items())
    rows: dict = {}

    def same(got: dict) -> bool:
        return list(got) == list(message) and all(
            np.array_equal(got[n].payload, v.payload) and np.array_equal(got[n].absmax, v.absmax)
            for n, v in message.items())

    with tempfile.TemporaryDirectory(prefix="table3_") as tmp:
        free_disk = shutil.disk_usage(tmp).free
        print(f"Table III: host RAM {host_ram} bytes, free disk {free_disk} bytes in the "
              f"temporary directory; message {msg_bytes} bytes, largest item {max_item} bytes, "
              f"chunk {TABLE3_CHUNK} bytes")
        if free_disk < 2.2 * msg_bytes:
            fail(f"Table III: {free_disk} free bytes of disk, the file mode needs two "
                 f"copies of the {msg_bytes}-byte message")
        src, dst = os.path.join(tmp, "model.bin"), os.path.join(tmp, "received.bin")
        with open(src, "wb") as fh:   # the container blob, item by item
            fh.write(len(message).to_bytes(4, "little"))
            for _n, views in ser.iter_serialized_items(message):
                for v in views:
                    fh.write(v)
        if os.path.getsize(src) != msg_bytes:
            fail(f"Table III: the message file holds {os.path.getsize(src)} bytes, "
                 f"expected {msg_bytes}")
        for mode in ("regular", "container", "file"):
            gc.collect()
            meter = MemoryMeter()
            reset = reset_rss_peak()
            driver = sm.LoopbackDriver()
            t0 = time.perf_counter()
            with meter.activate():
                if mode == "regular":
                    recv = sm.BlobReceiver()
                    driver.connect(recv.on_chunk)
                    sm.ObjectStreamer(driver, TABLE3_CHUNK).send_container(message)
                elif mode == "container":
                    recv = sm.ContainerReceiver()
                    driver.connect(recv.on_chunk)
                    sm.ContainerStreamer(driver, TABLE3_CHUNK).send_container(message)
                else:
                    recv = sm.FileReceiver(dst)
                    driver.connect(recv.on_chunk)
                    sm.FileStreamer(driver, TABLE3_CHUNK).send_file(src)
            wall = time.perf_counter() - t0
            rss_kb = rss_peak_kb()
            maxrss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            ok = filecmp.cmp(src, dst, shallow=False) if mode == "file" else same(recv.result)
            if not ok:
                fail(f"Table III {mode}: what arrived differs from what was sent")
            rows[mode] = {"meter_peak_bytes": meter.peak, "meter_copied_bytes": meter.copied,
                          "wall_s": wall, "rss_peak_kb": rss_kb, "rss_peak_reset": reset,
                          "process_maxrss_kb": maxrss_kb}
            print(f"Table III {mode}: MemoryMeter peak {meter.peak} bytes "
                  f"({meter.peak / msg_bytes:.3f} x the message), copied {meter.copied} bytes, "
                  f"wall {wall:.3f} s, VmHWM {rss_kb} kB"
                  f"{'' if reset else ' (not reset)'}, process ru_maxrss {maxrss_kb} kB")
            del recv
    peaks = {m: r["meter_peak_bytes"] for m, r in rows.items()}
    ordering = peaks["regular"] > peaks["container"] > peaks["file"]
    summary = {"regular>container>file": ordering,
               "regular_over_message": peaks["regular"] / msg_bytes,
               "container_over_max_item": peaks["container"] / max_item,
               "file_over_chunk": peaks["file"] / TABLE3_CHUNK,
               "message_bytes": msg_bytes, "max_item_bytes": max_item,
               "chunk_bytes": TABLE3_CHUNK, "host_ram_bytes": host_ram,
               "free_disk_bytes": free_disk}
    print("Table III ordering: " + ", ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}" for k, v in summary.items()))
    if not ordering:
        fail(f"Table III: peaks {peaks} do not order regular > container > file")
    return {**rows, "summary": summary}


def visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs one head attends over under the masks."""
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def flash_inputs(torch, dev, B, H, KV, S, hd, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev)
            for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Per kernel of the build's ``-Xptxas -v`` output: registers a thread
    and spill store / load bytes (empty when the library came from the
    cache and nothing was compiled)."""
    report: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            report.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[name]["spill_stores"], report[name]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return report


def check_wide_occupancy(torch, ptxas: dict[str, dict[str, int]]) -> dict:
    """Each wide instantiation (hd 96 and 256, fp32 and bf16) as the card
    holds it: at least 8 warps an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    at its layout's threads and shared bytes), its registers a thread, no
    local bytes (``cudaFuncGetAttributes``) and, where this run compiled
    it, no ptxas spill."""
    from repro_torch.kernels.flash_attention import WIDE_HEAD_DIMS, layout, occupancy

    out = {}
    for hd in WIDE_HEAD_DIMS:
        for dt, tname in ((torch.float32, "f"), (torch.bfloat16, "13__nv_bfloat16")):
            occ = occupancy(hd, dt)
            lay = layout(hd, dt)
            found = [v for k, v in ptxas.items() if f"flash_wide_kernelI{tname}Li{hd}E" in k]
            spill = (found[0].get("spill_stores", 0) + found[0].get("spill_loads", 0)
                     if found else None)
            label = f"hd{hd}_{str(dt).split('.')[-1]}"
            out[label] = {**occ, "smem_bytes": lay.smem_bytes, "rows": lay.rows,
                          "keys": lay.keys, "ptxas_spill_bytes": spill}
            print(f"flash_wide_kernel {label}: {occ['warps_per_sm']} warps an SM "
                  f"({occ['ctas_per_sm']} CTA of {lay.warps} warps, {lay.rows} query rows, "
                  f"{lay.keys}-key tiles, {lay.smem_bytes} shared bytes), "
                  f"{occ['registers']} registers a thread, local bytes {occ['local_bytes']}, "
                  f"ptxas spill bytes {spill if found else 'not in this build log'}")
            if occ["warps_per_sm"] < 8 or occ["local_bytes"] or spill:
                fail(f"flash_wide_kernel {label}: {out[label]}")
    return out


def check_flash_kernel(torch, dev, rates: dict[str, float],
                       ptxas: dict[str, dict[str, int]]) -> dict:
    """The flash-attention kernel against its plain version on the card:
    every case of ``kernels.cases.ATTENTION_CASES``, then the two serving
    shapes of llama3.2-1b (32 heads, 8 KV heads, hd 64) — batch 4 x 512
    causal, and batch 1 x 8192 causal with the 4096 window — and each
    family serving run's prefill shape (:data:`FAMILY_FLASH_SHAPES`:
    recurrentgemma-2b at hd 256, MQA, window 2048; phi-3-vision at hd 96;
    whisper-small's decoder; dbrx-132b at GQA group 6; granite-8b), each
    within ``kernels.cases.ATTENTION_TOL``. At the serving shapes it times the
    kernel, the plain version and PyTorch's ``scaled_dot_product_attention``
    (``enable_gqa``; ``is_causal``, or a boolean mask for the window), which
    the port never calls. Two bounds, each the larger of its operations and
    the bytes of q, k, v and the output: the fp32 one (4 * hd fp32
    operations per visible pair at the CUDA cores' fp32 peak) and the
    tensor-core one (tf32 and bf16 products at their published peaks,
    :func:`flash_tensor_ops`, at every head dim: both kernels run just
    these products), which is the row's bound; and the same products at the
    mma.sync ``rates`` measured here. First the wide kernel's occupancy
    (:func:`check_wide_occupancy`)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.cases import (
        ATTENTION_CASES,
        ATTENTION_TOL,
        attention_case,
        attention_inputs,
    )
    from repro_torch.kernels.flash_attention import flash_attention

    wide_occupancy = check_wide_occupancy(torch, ptxas)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for name in sorted(ATTENTION_CASES):
        c = attention_case(name)
        dt = getattr(torch, c["dtype"])
        q, k, v = (torch.from_numpy(a).to(dev, dt) for a in attention_inputs(name))
        out = flash_attention(q, k, v, causal=c["causal"], window=c["window"]).float()
        want = ref.attention(q, k, v, causal=c["causal"], window=c["window"]).float()
        atol, rtol = ATTENTION_TOL[c["dtype"]]
        if not bool(((out - want).abs() <= atol + rtol * want.abs()).all()):
            fail(f"flash kernel outside (atol {atol}, rtol {rtol}) of its plain version on "
                 f"{name}: max |err| {float((out - want).abs().max()):.3g}")
        worst[c["dtype"]] = max(worst[c["dtype"]], float((out - want).abs().max()))
    print(f"flash kernel within ATTENTION_TOL of its plain version on {len(ATTENTION_CASES)} "
          f"cases: max |err| fp32 {worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}")

    shapes = {}
    runs = [(label, B, 32, 8, S, 64, window) for label, window, B, S, _gen in SERVE_RUNS]
    for label, B, H, KV, S, hd, window in runs + list(FAMILY_FLASH_SHAPES):
        q, k, v = flash_inputs(torch, dev, B, H, KV, S, hd, seed=S)
        out = flash_attention(q, k, v, causal=True, window=window)
        want = ref.attention(q, k, v, causal=True, window=window)
        err = float((out - want).abs().max())
        atol, rtol = ATTENTION_TOL["float32"]
        if not bool(((out - want).abs() <= atol + rtol * want.abs()).all()):
            fail(f"flash kernel outside its tolerance at the {label} shape: max |err| {err:.3g}")
        del out, want
        release(torch)
        if window is None:
            def lib():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        else:
            i = torch.arange(S, device=dev)[:, None]
            j = torch.arange(S, device=dev)[None, :]
            mask = (j <= i) & (i - j < window)

            def lib():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        pairs = visible_pairs(S, S, True, window) * B * H
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        fp32_ms, fp32_by = bound(nbytes, 4 * hd * pairs)
        bound_ms, bound_by = bound(nbytes, flash_tensor_ops(hd, pairs), TF32_OPS_PER_S)
        mma_ms, _ = bound(nbytes, flash_tensor_ops(hd, pairs, 1e12 * rates["bf16"],
                                                   1e12 * rates["tf32"]), 1e12 * rates["tf32"])
        ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=True, window=window))
        plain_ms = time_ms(torch, lambda: ref.attention(q, k, v, causal=True, window=window),
                           reps=5, warmup=1, batch=1)
        release(torch)
        lib_ms = time_ms(torch, lib, reps=10, warmup=2, batch=3)
        release(torch)
        shapes[label] = {"shape": [B, H, KV, S, hd], "window": window, "pairs": pairs,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "bound_fp32_ms": fp32_ms,
                         "bound_fp32_by": fp32_by, "bound_mma_sync_ms": mma_ms,
                         "fp32_tflops": 4 * hd * pairs / ms / 1e9, "max_abs_err": err}
        print(f"flash_attention ({label} shape {B}x{H}x{S}x{hd}, KV {KV}, window {window}): "
              f"{ms:.4f} ms ({4 * hd * pairs / ms / 1e9:.1f} TFLOP/s of fp32 work); bound "
              f"{bound_ms:.4f} ms by {bound_by} (tf32 + bf16 tensor-core products at their "
              f"peaks; {100 * bound_ms / ms:.1f}% of it), fp32 bound {fp32_ms:.4f} ms by "
              f"{fp32_by} ({100 * fp32_ms / ms:.1f}%), at the measured mma.sync rates "
              f"{mma_ms:.4f} ms ({100 * mma_ms / ms:.1f}%); plain {plain_ms:.4f} ms, "
              f"SDPA {lib_ms:.4f} ms, max |err| {err:.3g}")
        del q, k, v
        release(torch)
    return {"cases_max_abs_err": worst, "wide_occupancy": wide_occupancy, **shapes}


def serve_phases(events: list[dict]) -> dict[str, float]:
    spans = {e["name"]: e["dur"] / 1e6 for e in events
             if e.get("ph") == "X" and e["name"].startswith("serve.")}
    return {"prefill_s": spans.get("serve.prefill", 0.0),
            "replay_s": spans.get("serve.replay", 0.0),
            "decode_s": spans.get("serve.decode", 0.0)}


def layer0(node):
    """Layer 0's slice of stacked (layer-first) block parameters."""
    return {k: layer0(v) for k, v in node.items()} if isinstance(node, dict) else node[0]


def layer0_attention_check(torch, model, params, prompts) -> float:
    """The kernel's attention output at layer 0 on the run's real q, k, v
    against ``_sdpa``'s on the same tensors; returns max |err|."""
    from repro_torch.kernels.cases import ATTENTION_TOL
    from repro_torch.models import layers as L

    cfg = model.cfg
    with torch.inference_mode():
        x = L.embed_tokens(prompts, params["embed"], cfg.activ_dtype)
        bp = layer0(params["blocks"])
        s = prompts.shape[1]
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = L._project_qkv(L.rms_norm(x, bp["attn_norm"]), bp["attn"], cfg, positions)
        del x
        got = L.sdpa_or_flash(q, k, v, cfg, causal=True, window=cfg.sliding_window)
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        mask = j <= i
        if cfg.sliding_window is not None:
            mask = mask & (i - j < cfg.sliding_window)
        want = L._sdpa(q, k, v, mask, cfg)
        atol, rtol = ATTENTION_TOL["float32"]
        ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
        err = float((got - want).abs().max())
    del q, k, v, got, want
    release(torch)
    if not ok:
        fail(f"layer 0: the flash kernel's attention is outside its tolerance of _sdpa's "
             f"(max |err| {err:.3g})")
    return err


def run_serve(torch, dev, label: str, window, batch: int, prompt: int, gen: int) -> dict:
    """One serving run of full-width llama3.2-1b with seeded weights through
    ``generate``, with the launch counters zeroed just before and read just
    after: exactly one flash launch per layer (the prefill's; decode steps
    have one query and never route), none of any other kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import create_model
    from repro_torch.obs import trace as obs_trace

    cfg = get_config("llama3.2-1b").with_overrides(remat=False, sliding_window=window)
    model = create_model(cfg)
    params = model.init(0, dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    tracer = obs_trace.Tracer(sync=torch.cuda.synchronize)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with obs_trace.activate(tracer):
        tokens = generate(model, params, prompts, gen_len=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    want = {name: 0 for name in launches}
    want["flash_attention"] = cfg.num_layers
    print(f"{label} launches: {launches} (expected {want})")
    if launches != want:
        fail(f"kernel launches on the {label} path {launches} != {want}")
    if tuple(tokens.shape) != (batch, prompt + gen) or tokens.dtype != torch.int32:
        fail(f"{label}: tokens {tuple(tokens.shape)} {tokens.dtype}, expected "
             f"({batch}, {prompt + gen}) int32")
    if not (torch.equal(tokens[:, :prompt], prompts) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size):
        fail(f"{label}: tokens do not extend the prompts within the vocabulary")
    with torch.inference_mode():
        logits, cache = model.prefill(params, prompts)
    if not (bool(torch.isfinite(logits).all())
            and all(bool(torch.isfinite(t.float()).all()) for t in cache.values())):
        fail(f"{label}: prefill logits or cache not finite")
    del logits, cache
    release(torch)
    layer0_err = layer0_attention_check(torch, model, params, prompts)

    phases = serve_phases(tracer.chrome_trace()["traceEvents"])
    decode_steps = gen - 1
    report = {
        "batch": batch, "prompt": prompt, "gen": gen, "window": window, "wall_s": wall,
        **phases,
        "replay_ms_per_token": 1e3 * phases["replay_s"] / prompt if window is None else None,
        "decode_ms_per_token": 1e3 * phases["decode_s"] / max(decode_steps, 1),
        "tokens_per_s": batch * gen / wall, "launches": launches,
        "layer0_max_abs_err": layer0_err, "max_memory_allocated_bytes": peak,
        "allocated_before_bytes": allocated_before,
        "last_tokens": tokens[0, -gen:].tolist(),
    }
    replay = (f"replay {report['replay_ms_per_token']:.3f} ms/token ({prompt} steps), "
              if window is None else "")
    print(f"{label}: batch {batch}, prompt {prompt}, gen {gen}, window {window}: wall "
          f"{wall:.3f} s, prefill {phases['prefill_s']:.4f} s, {replay}decode "
          f"{report['decode_ms_per_token']:.3f} ms/token ({decode_steps} steps), "
          f"{report['tokens_per_s']:.2f} generated tokens/s; max_memory_allocated {peak} "
          f"bytes ({allocated_before} before); layer-0 attention max |err| {layer0_err:.3g}")
    print(f"{label} tokens[0, -{gen}:]: {report['last_tokens']}")
    del model, params, prompts, tokens
    release(torch)
    return report


def check_serve_against_cpu(torch, dev) -> dict:
    """Smoke-width llama3.2-1b served with the same weights on the card
    (prefill through the kernel: both prompts are multiples of 128) and on
    the CPU (the masked softmax): full attention at prompt 128, and
    ``sliding_window`` 64 at prompt 256. Prefill logits and caches agree
    within ``SERVE_CPU_TOL``; greedy tokens are equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import create_model
    from repro_torch.utils.trees import flatten_state_dict, unflatten_state_dict

    report = {}
    for window, prompt in ((None, 128), (64, 256)):
        cfg = get_smoke_config("llama3.2-1b").with_overrides(remat=False, sliding_window=window)
        model = create_model(cfg)
        cpu_params = model.init(0, "cpu")
        card_params = unflatten_state_dict(
            {k: v.to(dev) for k, v in flatten_state_dict(cpu_params).items()})
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, prompt)).astype(np.int32))
        outs = {}
        ops.reset_launch_counts()
        for where, d, params in (("cpu", "cpu", cpu_params), ("card", dev, card_params)):
            with torch.inference_mode():
                logits, cache = model.prefill(params, prompts.to(d))
            tokens = generate(model, params, prompts.to(d), gen_len=8)
            outs[where] = (logits.cpu(), {k: v.cpu() for k, v in cache.items()}, tokens.cpu())
        launches = ops.launch_counts()["flash_attention"]
        if launches != 2 * cfg.num_layers:
            fail(f"smoke serving on the card launched the flash kernel {launches} times, "
                 f"expected {2 * cfg.num_layers} (two prefills)")
        err = 0.0
        for got, want in [(outs["card"][0], outs["cpu"][0])] + [
                (outs["card"][1][k], outs["cpu"][1][k]) for k in outs["cpu"][1]]:
            got, want = got.float(), want.float()
            if not bool(((got - want).abs() <= SERVE_CPU_TOL * (1 + want.abs())).all()):
                fail(f"smoke serving (window {window}): card and CPU prefill differ by "
                     f"{float((got - want).abs().max()):.3g}")
            err = max(err, float((got - want).abs().max()))
        if not torch.equal(outs["card"][2], outs["cpu"][2]):
            fail(f"smoke serving (window {window}): greedy tokens differ between card and CPU")
        key = "full_128" if window is None else "window64_256"
        report[key] = {"max_abs_err": err, "tokens": outs["cpu"][2][0, -8:].tolist()}
        print(f"smoke serving card vs CPU, window {window}, prompt {prompt}: prefill logits "
              f"and caches within {err:.3g}, greedy tokens equal "
              f"({report[key]['tokens']})")
    return report


def check_forward_only(torch, dev) -> None:
    """A backward through the flash kernel must raise NotImplementedError,
    as the reference's kernel has no gradient."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = (t.requires_grad_(True) for t in flash_inputs(torch, dev, 1, 4, 2, 128, 64, 3))
    out = flash_attention(q, k, v)
    try:
        out.sum().backward()
    except NotImplementedError as exc:
        print(f"flash kernel backward raises NotImplementedError: {exc}")
    else:
        fail("a backward through the flash kernel did not raise")


def family_extra(torch, cfg, batch: int, device, rng=None):
    """``generate``'s ``extra`` for an enc-dec (frames) or a VLM (patches):
    zeros as the reference's ``main`` gives them, or standard normal from
    ``rng``; None for every other family."""
    n = {"encdec": cfg.encoder_seq, "vlm": cfg.num_patches}.get(cfg.family)
    if n is None:
        return None
    shape = (batch, n, cfg.d_model)
    value = (torch.zeros(shape) if rng is None
             else torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
    return {"frames" if cfg.family == "encdec" else "patches": value.to(device)}


def attention_layers(model) -> int:
    """The layers whose prefill routes full-sequence causal attention
    through ``sdpa_or_flash``: the hybrid's attention layers, every other
    decoder's layers (an enc-dec's encoder takes the masked softmax at any
    length only because its frames are no multiple of 128)."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        return (model.n_super * cfg.block_pattern.count("attn")
                + model.tail_pattern.count("attn"))
    return cfg.num_layers


def run_family_serve(torch, dev, label: str, arch: str, batch: int, prompt: int, gen: int,
                     layers, flash_launches: int) -> dict:
    """One full-width serving run of ``arch`` (``layers`` cuts the depth)
    with seeded weights through ``generate`` (zero frames or patches for
    the enc-dec and the VLM), with the launch counters zeroed just before
    and read just after: exactly ``flash_launches`` B7 launches and none
    of any other kernel. Then the prefill's logits and cache must be
    finite and the tokens extend the prompts within the vocabulary; the
    spans give prefill, replay and decode walls, and the device peak is
    ``max_memory_allocated``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import create_model
    from repro_torch.obs import trace as obs_trace
    from repro_torch.utils.trees import flatten_state_dict

    cfg = get_config(arch).with_overrides(remat=False)
    if layers is not None:
        cfg = cfg.with_overrides(num_layers=layers)
    model = create_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(math.prod(s) for s in model.param_shapes().values())
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)).to(dev)
    extra = family_extra(torch, cfg, batch, dev)
    torch.cuda.synchronize()
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    tracer = obs_trace.Tracer(sync=torch.cuda.synchronize)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with obs_trace.activate(tracer):
        tokens = generate(model, params, prompts, gen_len=gen, extra=extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want["flash_attention"] = flash_launches
    print(f"{label} launches: {launches} (expected {want})")
    if launches != want:
        fail(f"kernel launches on the {label} path {launches} != {want}")
    if tuple(tokens.shape) != (batch, prompt + gen) or tokens.dtype != torch.int32:
        fail(f"{label}: tokens {tuple(tokens.shape)} {tokens.dtype}, expected "
             f"({batch}, {prompt + gen}) int32")
    if not (torch.equal(tokens[:, :prompt], prompts) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size):
        fail(f"{label}: tokens do not extend the prompts within the vocabulary")
    with torch.inference_mode():
        logits, cache = model.prefill(params, prompts, *(extra or {}).values())
    leaves = list(flatten_state_dict(cache).values())
    if not (tuple(logits.shape) == (batch, 1, cfg.vocab_size)
            and bool(torch.isfinite(logits).all())
            and all(bool(torch.isfinite(t.float()).all()) for t in leaves)):
        fail(f"{label}: prefill logits {tuple(logits.shape)} or cache not finite")
    del logits, cache, leaves
    phases = serve_phases(tracer.chrome_trace()["traceEvents"])
    report = {"arch": arch, "layers": cfg.num_layers, "params": n_params, "batch": batch,
              "prompt": prompt, "gen": gen, "extra": None if extra is None else list(extra),
              "init_s": init_s, "wall_s": wall, **phases,
              "decode_ms_per_token": 1e3 * phases["decode_s"] / max(gen - 1, 1),
              "tokens_per_s": batch * gen / wall, "launches": launches,
              "max_memory_allocated_bytes": peak, "allocated_before_bytes": allocated_before,
              "last_tokens": tokens[0, -gen:].tolist()}
    replay = (f"replay {phases['replay_s']:.4f} s, " if phases["replay_s"] else "")
    print(f"{label}: {arch} ({cfg.num_layers} layers, {n_params} params, init {init_s:.2f} s), "
          f"batch {batch}, prompt {prompt}{'' if extra is None else ' + ' + str(list(extra))}, "
          f"gen {gen}: wall {wall:.3f} s, prefill {phases['prefill_s']:.4f} s, {replay}decode "
          f"{report['decode_ms_per_token']:.3f} ms/token; max_memory_allocated {peak} bytes "
          f"({allocated_before} before)")
    print(f"{label} tokens[0, -{gen}:]: {report['last_tokens']}")
    del model, params, prompts, tokens, extra
    release(torch)
    return report


def check_family_serve_against_cpu(torch, dev) -> dict:
    """Every architecture of :data:`FAMILY_SMOKE` at smoke width, served
    with the same seeded weights on the card (each attention prefill of
    :data:`FAMILY_CPU_ROWS` rows through the kernel) and on the CPU (the
    masked softmax), with random frames / patches from a seed: prefill
    logits and every cache leaf within :data:`FAMILY_CPU_TOL` * (1 +
    |want|), greedy tokens equal, and B7 launched once per attention
    layer per prefill on the card (two: the check's and ``generate``'s)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import create_model
    from repro_torch.utils.trees import flatten_state_dict, unflatten_state_dict

    report = {}
    for label, arch, over in FAMILY_SMOKE:
        cfg = get_smoke_config(arch).with_overrides(remat=False, **over)
        model = create_model(cfg)
        cpu_params = model.init(0, "cpu")
        card_params = unflatten_state_dict(
            {k: v.to(dev) for k, v in flatten_state_dict(cpu_params).items()})
        rng = np.random.default_rng(2)
        prompt = FAMILY_CPU_ROWS - (cfg.num_patches if cfg.family == "vlm" else 0)
        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, prompt)).astype(np.int32))
        extra = family_extra(torch, cfg, 2, "cpu", rng)
        outs = {}
        ops.reset_launch_counts()
        for where, d, params in (("cpu", "cpu", cpu_params), ("card", dev, card_params)):
            ex = None if extra is None else {k: v.to(d) for k, v in extra.items()}
            with torch.inference_mode():
                logits, cache = model.prefill(params, prompts.to(d), *(ex or {}).values())
            tokens = generate(model, params, prompts.to(d), gen_len=8, extra=ex)
            outs[where] = (logits.cpu(), {k: v.cpu() for k, v in
                                          flatten_state_dict(cache).items()}, tokens.cpu())
        launches = ops.launch_counts()
        want = {name: 0 for name in launches}
        want["flash_attention"] = 2 * attention_layers(model)
        if launches != want:
            fail(f"smoke {label} on the card: launches {launches} != {want}")
        err = 0.0
        pairs = [("logits", outs["card"][0], outs["cpu"][0])] + [
            (k, outs["card"][1][k], outs["cpu"][1][k]) for k in outs["cpu"][1]]
        for name, got, want_t in pairs:
            got, want_t = got.float(), want_t.float()
            diff = (got - want_t).abs()
            if not bool((diff <= FAMILY_CPU_TOL * (1 + want_t.abs())).all()):
                fail(f"smoke {label}: card and CPU {name} differ by {float(diff.max()):.3g}")
            err = max(err, float(diff.max()))
        if not torch.equal(outs["card"][2], outs["cpu"][2]):
            fail(f"smoke {label}: greedy tokens differ between card and CPU")
        report[label] = {"max_abs_err": err, "flash_launches": launches["flash_attention"],
                         "tokens": outs["cpu"][2][0, -8:].tolist()}
        print(f"smoke {label} card vs CPU, {prompt} tokens"
              f"{'' if extra is None else ' + ' + str(list(extra))}: prefill logits and "
              f"{len(outs['cpu'][1])} cache leaves within {err:.3g}, greedy tokens equal "
              f"({report[label]['tokens']}), B7 x{launches['flash_attention']}")
        del model, cpu_params, card_params, outs
        release(torch)
    return report


def slstm_bound(B: int, S: int, H: int, hd: int, gx_bytes: int = 4) -> tuple[float, str]:
    """The sLSTM scan's least time: gx read once, h written once, r read
    once, the final state written once; 2 operations per multiply-add of
    the per-head (hd) x (hd, 4 hd) product each step."""
    D = H * hd
    nbytes = gx_bytes * B * S * 4 * D + 4 * B * S * D + 4 * 4 * H * hd * hd + 4 * 4 * B * D
    return bound(nbytes, 2 * B * S * 4 * H * hd * hd)


def slstm_err(torch, got, want) -> tuple[bool, float]:
    """Within ``SLSTM_TOL`` of the plain version (h and the four state
    tensors), and the largest |err|."""
    from repro_torch.kernels.cases import SLSTM_TOL

    atol, rtol = SLSTM_TOL
    ok, err = True, 0.0
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        ok = ok and bool(((a - b).abs() <= atol + rtol * b.abs()).all())
        err = max(err, float((a - b).abs().max()))
    return ok, err


def check_slstm_kernel(torch, dev) -> dict:
    """The sLSTM-scan kernel against its plain version on the card, h and
    the final state within ``kernels.cases.SLSTM_TOL``: every case of
    ``SLSTM_CASES``, then xlstm-125m's width (4 heads of 192) at batch 4 x
    1024 steps (serve_xlstm's prefill) and 1 x 8192 (a long prompt), from
    seeded inputs (gx standard normal, r normal * 0.05). At both shapes it
    times the kernel and the plain version; no single PyTorch call
    computes this recurrence (``torch.nn.LSTM`` is another cell), so there
    is no library time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cases import SLSTM_CASES, slstm_case, slstm_inputs
    from repro_torch.kernels.slstm_scan import cluster_layout, slstm_scan

    worst = 0.0
    for name in sorted(SLSTM_CASES):
        c = slstm_case(name)
        gx, r = (torch.from_numpy(a).to(dev) for a in slstm_inputs(name))
        gx = gx.to(getattr(torch, c["dtype"]))
        ok, err = slstm_err(torch, slstm_scan(gx, r, num_heads=c["H"], chunk=c["chunk"]),
                            ref.slstm_scan(gx, r, c["H"]))
        if not ok:
            fail(f"sLSTM kernel outside SLSTM_TOL of its plain version on {name}: max |err| "
                 f"{err:.3g}")
        worst = max(worst, err)
    print(f"sLSTM kernel within SLSTM_TOL of its plain version on {len(SLSTM_CASES)} cases "
          f"(h and final state): max |err| {worst:.3g}")

    shapes = {}
    H, hd = 4, 192
    for label, B, S in SLSTM_SHAPES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(S)
        gx = torch.randn((B, S, 4, H * hd), generator=gen, device=dev)
        r = torch.randn((4, H, hd, hd), generator=gen, device=dev) * 0.05
        ok, err = slstm_err(torch, slstm_scan(gx, r, num_heads=H), ref.slstm_scan(gx, r, H))
        if not ok:
            fail(f"sLSTM kernel outside SLSTM_TOL at the {label} shape: max |err| {err:.3g}")
        release(torch)
        bound_ms, bound_by = slstm_bound(B, S, H, hd)
        ms = time_ms(torch, lambda: slstm_scan(gx, r, num_heads=H), reps=10, warmup=2,
                     batch=5 if S <= 1024 else 2)
        plain_ms = time_ms(torch, lambda: ref.slstm_scan(gx, r, H), reps=3, warmup=1, batch=1)
        layout = cluster_layout(hd)._asdict()
        shapes[label] = {"shape": [B, S, H, hd], "ms": ms, "us_per_step": 1e3 * ms / S,
                         "plain_ms": plain_ms, "plain_us_per_step": 1e3 * plain_ms / S,
                         "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                         "layout": layout, "ctas": layout["cluster"] * B * H,
                         "max_abs_err": err}
        print(f"slstm_scan ({label} shape {B}x{S}, {H} heads of {hd}): {ms:.4f} ms "
              f"({1e3 * ms / S:.3f} us a step), bound {bound_ms:.4f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.2f}% of it), plain {plain_ms:.2f} ms "
              f"({1e3 * plain_ms / S:.1f} us a step), library n/a, max |err| {err:.3g}; "
              f"clusters of {layout['cluster']} CTAs ({layout['cluster'] * B * H} CTAs), "
              f"{layout['threads']} threads and {layout['smem_bytes']} bytes of shared "
              f"memory a CTA")
        del gx, r
        release(torch)
    return {"cases_max_abs_err": worst, **shapes}


def run_serve_xlstm(torch, dev, label: str, batch: int, prompt: int, gen: int) -> dict:
    """Full-width xlstm-125m with seeded weights served through ``generate``
    twice — the first call also pays one-time costs (cuBLAS plans, first
    use of each kernel), the second is warm — each with the launch
    counters zeroed just before and read just after: exactly one
    sLSTM-scan launch per sLSTM layer (the prefill's; decode steps run
    the cell) and none of any other kernel. The warm call's numbers are
    the run's; the trace span ``kernel.slstm_scan`` gives the kernel's
    share of the prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import create_model
    from repro_torch.obs import trace as obs_trace

    cfg = get_config("xlstm-125m").with_overrides(remat=False)
    model = create_model(cfg)
    params = model.init(0, dev)
    n_params = sum(math.prod(s) for s in model.param_shapes().values())
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)).to(dev)
    want = {name: 0 for name in ops.KERNELS}
    want["slstm_scan"] = model.n_super
    runs = {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        allocated_before = torch.cuda.memory_allocated()
        tracer = obs_trace.Tracer(sync=torch.cuda.synchronize)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with obs_trace.activate(tracer):
            tokens = generate(model, params, prompts, gen_len=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        print(f"{label} ({run}) launches: {launches} (expected {want})")
        if launches != want:
            fail(f"kernel launches on the {label} path ({run}) {launches} != {want}")
        events = tracer.chrome_trace()["traceEvents"]
        runs[run] = {"wall_s": wall, **serve_phases(events),
                     "slstm_scan_s": sum(e["dur"] for e in events if e.get("ph") == "X"
                                         and e["name"] == "kernel.slstm_scan") / 1e6,
                     "launches": launches, "max_memory_allocated_bytes":
                     torch.cuda.max_memory_allocated(), "allocated_before_bytes":
                     allocated_before}
    if tuple(tokens.shape) != (batch, prompt + gen) or tokens.dtype != torch.int32:
        fail(f"{label}: tokens {tuple(tokens.shape)} {tokens.dtype}, expected "
             f"({batch}, {prompt + gen}) int32")
    if not (torch.equal(tokens[:, :prompt], prompts) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size):
        fail(f"{label}: tokens do not extend the prompts within the vocabulary")
    with torch.inference_mode():
        logits, cache = model.prefill(params, prompts)
    leaves = [t for block in cache.values() for t in block.values()]
    if not (tuple(logits.shape) == (batch, 1, cfg.vocab_size)
            and bool(torch.isfinite(logits).all())
            and all(bool(torch.isfinite(t).all()) for t in leaves)):
        fail(f"{label}: prefill logits {tuple(logits.shape)} or state not finite")
    del logits, cache, leaves
    release(torch)

    decode_steps = gen - 1
    for run in runs.values():
        run["decode_ms_per_token"] = 1e3 * run["decode_s"] / max(decode_steps, 1)
        run["tokens_per_s"] = batch * gen / run["wall_s"]
        run["slstm_share_of_prefill"] = run["slstm_scan_s"] / run["prefill_s"]
    report = {"batch": batch, "prompt": prompt, "gen": gen, "params": n_params,
              **runs["warm"], "cold": runs["cold"], "last_tokens": tokens[0, -gen:].tolist()}
    for run, r in runs.items():
        print(f"{label} ({run}): xlstm-125m ({n_params} params), batch {batch}, prompt "
              f"{prompt}, gen {gen}: wall {r['wall_s']:.4f} s, prefill {r['prefill_s']:.4f} s "
              f"(sLSTM kernel {r['slstm_scan_s']:.4f} s, "
              f"{100 * r['slstm_share_of_prefill']:.1f}%), decode "
              f"{r['decode_ms_per_token']:.3f} ms/token ({decode_steps} steps), "
              f"{r['tokens_per_s']:.2f} generated tokens/s; max_memory_allocated "
              f"{r['max_memory_allocated_bytes']} bytes ({r['allocated_before_bytes']} before)")
    print(f"{label}: tokens[0, -{gen}:]: {report['last_tokens']}")
    del model, params, prompts, tokens
    release(torch)
    return report


def check_xlstm_serve_against_cpu(torch, dev) -> dict:
    """Smoke-width xlstm-125m served with the same weights on the card (the
    prefill's sLSTM through the kernel, at a prompt of 200, no multiple of
    the reference's chunk of 256) and on the CPU (the plain version):
    prefill logits and every cache leaf within
    ``XLSTM_CPU_TOL`` as stated there; greedy tokens equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import create_model
    from repro_torch.utils.trees import flatten_state_dict, unflatten_state_dict

    cfg = get_smoke_config("xlstm-125m").with_overrides(remat=False)
    model = create_model(cfg)
    cpu_params = model.init(0, "cpu")
    card_params = unflatten_state_dict(
        {k: v.to(dev) for k, v in flatten_state_dict(cpu_params).items()})
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, XLSTM_CPU_PROMPT)).astype(np.int32))
    outs = {}
    ops.reset_launch_counts()
    for where, d, params in (("cpu", "cpu", cpu_params), ("card", dev, card_params)):
        with torch.inference_mode():
            logits, cache = model.prefill(params, prompts.to(d))
        tokens = generate(model, params, prompts.to(d), gen_len=8)
        outs[where] = (logits.cpu(), {f"{b}.{k}": v.cpu() for b, leaves in cache.items()
                                      for k, v in leaves.items()}, tokens.cpu())
    launches = ops.launch_counts()["slstm_scan"]
    if launches != 2 * model.n_super:
        fail(f"smoke xLSTM serving on the card launched the sLSTM kernel {launches} times, "
             f"expected {2 * model.n_super} (two prefills)")
    got, want = outs["card"][0], outs["cpu"][0]
    logits_err, worst = float((got - want).abs().max()), 0.0
    if not bool(((got - want).abs() <= XLSTM_CPU_TOL * (1 + want.abs())).all()):
        fail(f"smoke xLSTM serving: card and CPU prefill logits differ by {logits_err:.3g}")
    for name, want in outs["cpu"][1].items():
        got = outs["card"][1][name]
        cap = XLSTM_CPU_TOL * (want.abs() + want.abs().max())
        if tuple(got.shape) != tuple(want.shape) or not bool(((got - want).abs() <= cap).all()):
            fail(f"smoke xLSTM serving: card and CPU cache {name} differ by "
                 f"{float((got - want).abs().max()):.3g}")
        worst = max(worst, float(((got - want).abs() / cap.clamp_min(1e-30)).max()))
    if not torch.equal(outs["card"][2], outs["cpu"][2]):
        fail("smoke xLSTM serving: greedy tokens differ between card and CPU")
    tokens = outs["cpu"][2][0, -8:].tolist()
    print(f"smoke xLSTM serving card vs CPU, prompt {XLSTM_CPU_PROMPT}: prefill logits within "
          f"{logits_err:.3g}, cache leaves within {worst:.3g} of their XLSTM_CPU_TOL bound, "
          f"greedy tokens equal ({tokens})")
    return {"logits_max_abs_err": logits_err, "cache_worst_of_bound": worst,
            "tokens": tokens}


def check_slstm_forward_only(torch, dev) -> None:
    """A backward through the sLSTM kernel must raise NotImplementedError,
    as the reference's kernel has no gradient."""
    from repro_torch.kernels.cases import slstm_inputs
    from repro_torch.kernels.slstm_scan import slstm_scan

    gx, r = (torch.from_numpy(a).to(dev).requires_grad_(True)
             for a in slstm_inputs("b2_s32_c8"))
    h, _state = slstm_scan(gx, r, num_heads=4, chunk=8)
    try:
        h.sum().backward()
    except NotImplementedError as exc:
        print(f"sLSTM kernel backward raises NotImplementedError: {exc}")
    else:
        fail("a backward through the sLSTM kernel did not raise")


def fl_flat_size() -> int:
    """Elements of full-width qwen1.5-0.5b's flat delta (every parameter,
    the QKV biases included)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DecoderLM
    return sum(math.prod(s) for s in DecoderLM(get_config(FL_ARGS["arch"])).param_shapes().values())


def check_agg_kernel(torch, dev) -> dict:
    """The K-way dequantize-and-sum kernel against its plain version on the
    card, bitwise (NaN in the same places): every case of
    ``kernels.cases.agg_cases``, then the collective's full shape — 2 pods
    of the flat full-width delta, weights 1/2 — compared in chunks of
    blocks (the plain version's float64 temporaries). Timed there: the
    kernel, the plain version over the same chunks, and one
    ``torch.einsum("kbe,kb->be", qs.float(), s)``. The bound is the bytes:
    K codes and 4 output bytes per element, 4 K bytes of absmax per block."""
    from repro_torch.kernels import cases, ref
    from repro_torch.kernels.fused_dequant_agg import dequant_accumulate8

    edge = cases.agg_cases()
    for name, arrays in edge.items():
        qs, am, w = (torch.from_numpy(a).to(dev) for a in arrays)
        if not same_bits(torch, dequant_accumulate8(qs, am, w), ref.dequant_accumulate8(qs, am, w)):
            fail(f"K-way sum kernel disagrees with its plain version on {name}")
    print(f"K-way sum kernel agrees bitwise with its plain version on {len(edge)} edge cases "
          "(K = 1 to 16, NaN in the same places)")

    n = fl_flat_size()
    pods, nblocks = FL_ARGS["pods"], math.ceil(n / ref.BLOCK8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    qs = torch.randint(-127, 128, (pods, nblocks, ref.BLOCK8), generator=gen, device=dev,
                       dtype=torch.int8)
    am = 10.0 ** (torch.rand((pods, nblocks), generator=gen, device=dev) * 3 - 4)
    w = torch.full((pods,), 1.0 / pods, dtype=torch.float32, device=dev)
    out = dequant_accumulate8(qs, am, w)

    def plain():
        res = torch.empty((nblocks, ref.BLOCK8), dtype=torch.float32, device=dev)
        for b in range(0, nblocks, AGG_CHUNK_BLOCKS):
            res[b:b + AGG_CHUNK_BLOCKS] = ref.dequant_accumulate8(
                qs[:, b:b + AGG_CHUNK_BLOCKS], am[:, b:b + AGG_CHUNK_BLOCKS], w)
        return res

    want = plain()
    if not same_bits(torch, out, want):
        fail("K-way sum kernel disagrees with its plain version at the full shape")
    err = float((out - want).abs().max())
    del out, want
    release(torch)
    print(f"K-way sum kernel agrees bitwise with its plain version at the full shape "
          f"({pods} pods x {nblocks} blocks: the flat delta of {n} elements, padded)")
    s = am * (w * ref.INV127)[:, None]
    elems = nblocks * ref.BLOCK8
    nbytes = pods * elems + 4 * elems + 4 * pods * nblocks
    ms = time_ms(torch, lambda: dequant_accumulate8(qs, am, w))
    plain_ms = time_ms(torch, plain, reps=3, warmup=1, batch=1)
    release(torch)
    lib_ms = time_ms(torch, lambda: torch.einsum("kbe,kb->be", qs.float(), s), reps=10,
                     warmup=2, batch=1)
    del qs, am, w, s
    release(torch)
    bound_ms, bound_by = bound(nbytes, 2 * pods * elems)
    print(f"dequant_accumulate8: {ms:.4f} ms at {pods} x {elems} elements "
          f"({nbytes / ms / 1e6:.1f} GB/s), bound {bound_ms:.4f} ms by {bound_by} "
          f"({100 * bound_ms / ms:.1f}% of it), plain {plain_ms:.4f} ms (chunks of "
          f"{AGG_CHUNK_BLOCKS} blocks), library (einsum) {lib_ms:.4f} ms")
    return {"pods": pods, "elements": elems, "flat_elements": n, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


def span_totals(events: list[dict]) -> dict[str, float]:
    """Seconds per span name over the device-synchronised trace, and the
    gathered wire bytes (every ``coll.all_gather`` span's)."""
    spans = [e for e in events if e.get("ph") == "X"]
    out = {name: sum(e["dur"] for e in spans if e["name"] == name) / 1e6 for name in FL_SPANS}
    out["wire_bytes"] = sum(e["args"]["wire_bytes"] for e in spans
                            if e["name"] == "coll.all_gather")
    return out


def fl_train_rank(rank: int, world: int, args) -> dict:
    """One rank of the federated trainer (spawned by ``fl_train.launch``):
    each full-width run of ``FL_RUNS`` with the counters zeroed just before
    and read just after, a sha256 of the final params, and — on the first
    int8 run — the bucketed collective against the unbucketed one on this
    rank's own delta; then the smoke-width card-vs-CPU round. Returns
    host data only."""
    import argparse
    import hashlib

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import collectives as C
    from repro_torch.kernels import ops
    from repro_torch.launch import fl_train
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.obs import trace as obs_trace
    from repro_torch.utils.trees import flatten_state_dict, tree_leaves

    dev = fl_train.rank_device(args.device, rank)
    fedavg = C.quantized_fedavg_tree
    seen = []

    def keep_delta(tree, group=None, bucket_bytes=None):
        out = fedavg(tree, group, bucket_bytes)
        seen.append((tree, out))
        return out

    report = {}
    for label, agg in FL_RUNS:
        seen.clear()
        C.quantized_fedavg_tree = keep_delta if label == "fl_int8" else fedavg
        torch.cuda.synchronize()
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        tracer = obs_trace.Tracer(sync=torch.cuda.synchronize)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with obs_trace.activate(tracer):
            out = fl_train.run(argparse.Namespace(**{**vars(args), "agg": agg}),
                               rank=rank, world=world)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        C.quantized_fedavg_tree = fedavg
        digest = hashlib.sha256()
        for t in flatten_state_dict(out["params"]).values():
            digest.update(t.detach().cpu().numpy().data)
        finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(out["params"]))
        rep = {"launches": launches, "history": out["history"],
               "round_wall_s": out["round_wall_s"], "wall_s": wall,
               "spans": span_totals(tracer.chrome_trace()["traceEvents"]),
               "max_memory_allocated_bytes": peak, "allocated_before_bytes": before,
               "params_sha256": digest.hexdigest(), "params_finite": finite}
        if label == "fl_int8":
            (delta, mean), = seen
            bucketed = fedavg(delta, None, fl_train.BUCKET_BYTES)
            rep["bucketed_equals_unbucketed"] = all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(tree_leaves(mean), tree_leaves(bucketed)))
            del delta, mean, bucketed
        seen.clear()
        report[label] = rep
        del out
        release(torch)

    # smoke width, one int8 round on the card and on the CPU, same weights
    smoke = argparse.Namespace(**{**vars(args), "smoke": True, "agg": "int8"})
    init = flatten_state_dict(DecoderLM(get_smoke_config(args.arch)).init(args.seed, "cpu"))
    quantize, absmax = C._quantize_flat, []

    def keep_absmax(flat):
        q, am = quantize(flat)
        absmax.append(am.cpu().numpy())
        return q, am

    C._quantize_flat = keep_absmax
    for where in ("card", "cpu"):
        device = str(dev) if where == "card" else "cpu"
        out = fl_train.run(argparse.Namespace(**{**vars(smoke), "device": device}),
                           rank=rank, world=world, init_params=init)
        report[f"smoke_{where}"] = {
            "history": out["history"],
            "params": {k: v.detach().cpu().numpy() for k, v in
                       flatten_state_dict(out["params"]).items()}}
    C._quantize_flat = quantize
    report["smoke_absmax"] = absmax
    return report


def run_fl_train(torch, n: int) -> dict:
    """Both ranks of the federated trainer in one spawn (``fl_train.launch``),
    then the checks on what they report: launches per rank and run (int8:
    one quantize and one K-way sum; int8-bucket: one of each per 8 MiB
    bucket of the ``n``-element flat delta; nothing else), the ranks'
    params bitwise equal, bucketed == unbucketed on each rank's delta,
    finite losses; and the smoke card-vs-CPU round within one quantization
    step of the wire per block + 1e-5 + 1e-5 relative, losses within 1e-4
    relative."""
    import argparse

    from repro_torch.kernels import ops
    from repro_torch.launch import fl_train

    buckets = math.ceil(n / (fl_train.BUCKET_BYTES // 4))
    want = {"int8": {"quantize_blockwise8": 1, "dequant_accumulate8": 1},
            "int8-bucket": {"quantize_blockwise8": buckets, "dequant_accumulate8": buckets}}
    release(torch)
    t0 = time.perf_counter()
    ranks = fl_train.launch(argparse.Namespace(**FL_ARGS), fl_train_rank)
    spawn_s = time.perf_counter() - t0
    report = {"spawn_s": spawn_s, "flat_elements": n, "buckets": buckets}
    for label, agg in FL_RUNS:
        expect = {name: want[agg].get(name, 0) for name in ops.KERNELS}
        for r, rep in enumerate(ranks):
            got = rep[label]
            print(f"{label} rank {r} launches: {got['launches']} (expected {expect})")
            if got["launches"] != expect:
                fail(f"kernel launches on the {label} path, rank {r}: {got['launches']} != "
                     f"{expect}")
            if not (got["params_finite"] and all(math.isfinite(x) for x in got["history"])):
                fail(f"{label} rank {r}: loss {got['history']} or params not finite")
            sp = got["spans"]
            print(f"{label} rank {r}: loss {got['history']}, round wall "
                  f"{got['round_wall_s'][0]:.3f} s; spans (s): " +
                  ", ".join(f"{k}={sp[k]:.4f}" for k in FL_SPANS) +
                  f"; wire bytes gathered {sp['wire_bytes']}; max_memory_allocated "
                  f"{got['max_memory_allocated_bytes']} bytes ({got['allocated_before_bytes']} "
                  "before)")
        if ranks[0][label]["params_sha256"] != ranks[1][label]["params_sha256"]:
            fail(f"{label}: the ranks' params differ after the round")
        print(f"{label}: both ranks' params bitwise equal (sha256 "
              f"{ranks[0][label]['params_sha256'][:16]})")
        report[label] = {"ranks": [{k: v for k, v in rep[label].items()} for rep in ranks],
                         "launches": {name: sum(rep[label]["launches"][name] for rep in ranks)
                                      for name in ops.KERNELS}}
    for r, rep in enumerate(ranks):
        if not rep["fl_int8"]["bucketed_equals_unbucketed"]:
            fail(f"rank {r}: the bucketed collective differs from the unbucketed one on its "
                 "delta")
    print("on each rank's own delta, the bucketed collective (8 MiB buckets) equals the "
          "unbucketed one bitwise")

    # smoke width, card vs CPU
    worst, rel = 0.0, 0.0
    for r, rep in enumerate(ranks):
        card, cpu = rep["smoke_card"], rep["smoke_cpu"]
        absmax = np.maximum.reduce([a for other in ranks for a in other["smoke_absmax"]])
        flat_card = np.concatenate([card["params"][k].reshape(-1) for k in sorted(card["params"])])
        flat_cpu = np.concatenate([cpu["params"][k].reshape(-1) for k in sorted(cpu["params"])])
        step = np.repeat(absmax.astype(np.float64) / 127.0, 4096)[:flat_cpu.size]
        cap = step + 1e-5 + 1e-5 * np.abs(flat_cpu)
        err = np.abs(flat_card.astype(np.float64) - flat_cpu)
        if not (err <= cap).all():
            fail(f"smoke fl_train rank {r}: card and CPU differ by more than one quantization "
                 f"step (max {float((err / cap).max()):.3f} of the bound)")
        worst = max(worst, float((err / cap).max()))
        rel = max(rel, max(abs(a - b) / abs(b) for a, b in zip(card["history"], cpu["history"])))
    if rel > 1e-4:
        fail(f"smoke fl_train: losses on the card differ from the CPU by {rel:.3g} relative")
    print(f"smoke fl_train int8 round, card vs CPU: weights within {worst:.3f} of one "
          f"quantization step + 1e-5 + 1e-5 relative, losses within {rel:.3g} relative")
    report["smoke_cpu_parity"] = {"worst_of_bound": worst, "loss_rel": rel}
    for rep in ranks:
        del rep["smoke_card"], rep["smoke_cpu"], rep["smoke_absmax"]
    return report


# ---------------------------------------------------------------------------
# The live plane (repro_torch.launch.federation): full width over real TCP
# ---------------------------------------------------------------------------

def load_job(path: str, **over) -> dict:
    with open(path) as fh:
        return {**json.load(fh), **over}


class PhaseClock:
    """Wall seconds summed by key across the threads of a live run."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}
        self._lock = threading.Lock()

    def wrap(self, fn, key):
        """``fn`` timed; ``key(*args)`` names what its seconds count as."""
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    name = key(*args)
                    self.seconds[name] = self.seconds.get(name, 0.0) + dt
        return timed


def client_threads(clients: list) -> tuple[list, list]:
    """Run each ``FederationClient`` on a thread of its own; returns
    (threads, errors)."""
    threads, errors = [], []
    for client in clients:
        def run(c=client):
            try:
                c.run()
            except Exception as exc:  # noqa: BLE001 - reported by join_live_clients
                errors.append(f"{c.name}: {exc!r}")

        threads.append(threading.Thread(target=run, daemon=True, name=f"live-{client.name}"))
        threads[-1].start()
    return threads, errors


def start_live_clients(spec: dict, dev, server, clock: PhaseClock,
                       addresses: dict | None = None) -> tuple[list, list]:
    """A ``FederationClient`` thread for each client of ``spec``, at the
    server's address (or at ``addresses[name]``), each built by
    ``for_spec`` on ``dev`` and timed by phase; the server's broadcast
    and gather are timed by round. The clients take turns to train (one
    lock): a full-width AdamW step peaks at ~36 GB on the card beside
    its 6 GB of weights, so two at once do not fit beside the server."""
    from repro_torch.launch.federation import FederationClient

    server._downlink = clock.wrap(server._downlink, lambda roster, rnd, w: f"round{rnd}.downlink")
    server._gather = clock.wrap(server._gather, lambda roster, rnd: f"round{rnd}.uplink_fold")
    train_lock = threading.Lock()
    clients = []
    for i in range(spec["clients"]):
        client = FederationClient.for_spec(
            spec, i, (addresses or {}).get(f"site-{i}", server.address),
            timeout_s=LIVE_TIMEOUT_S, device=dev)
        client._recv_task = clock.wrap(client._recv_task, lambda conn: "client.downlink_decode")
        timed_train = clock.wrap(client.executor.execute, lambda task: "client.train")

        def train(task, _timed=timed_train):
            with train_lock:
                return _timed(task)

        client.executor.execute = train
        client._send_result = clock.wrap(client._send_result,
                                         lambda conn, rnd, res: "client.uplink_encode_send")
        clients.append(client)
    return client_threads(clients)


def join_live_clients(started: list) -> None:
    for threads, errors in started:
        for t in threads:
            t.join(timeout=LIVE_TIMEOUT_S)
            if t.is_alive():
                fail(f"live client thread {t.name} did not finish")
        if errors:
            fail(f"live clients failed: {errors}")


class socket_clock:
    """Times every chunk write of a live run (``streaming.send_chunk``):
    the server's downlink sender threads apart from the clients'
    uplinks."""

    def __init__(self, clock: PhaseClock) -> None:
        from repro_torch.core import streaming as sm

        self.sm, self.clock = sm, clock

    def __enter__(self):
        self.orig = self.sm.send_chunk
        self.sm.send_chunk = self.clock.wrap(
            self.orig, lambda *a: "tcp.send_" + (
                "downlink" if threading.current_thread().name.startswith("fed-downlink")
                else "uplink"))

    def __exit__(self, *exc) -> None:
        self.sm.send_chunk = self.orig


def compare_weights(torch, label: str, got: dict, want: dict) -> None:
    """Fail unless ``got`` is bitwise ``want``, naming every item that is
    not, with its count of differing elements and largest difference."""
    diffs = []
    if list(got) != list(want):
        fail(f"{label}: item names differ: {sorted(set(got) ^ set(want))}")
    for name, w in want.items():
        g = got[name].to(w.device)
        if not torch.equal(bits(torch, g), bits(torch, w)):
            diffs.append(f"{name}: {int((g != w).sum())} of {w.numel()} differ, "
                         f"max |diff| {float((g - w).abs().max()):.3g}")
    if diffs:
        fail(f"{label}: not bitwise equal: " + "; ".join(diffs))


def live_report(torch, label: str, result: dict, wall: float, clock: PhaseClock,
                launches: dict) -> dict:
    telemetry = result["telemetry"]
    wait = telemetry.get("histograms", {}).get("wire.encode_wait_us", {})
    report = {
        "wall_s": wall, "round_log": result["round_log"], "uplink_log": result["uplink_log"],
        "bytes_down": result["bytes_down"], "bytes_up": result["bytes_up"],
        "restarts": result["restarts"], "faults": result["faults"],
        "phase_s": dict(sorted(clock.seconds.items())),
        "sender_encode_wait_s": wait.get("sum", 0.0) / 1e6,
        "launches": launches,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    print(f"{label}: wall {wall:.3f} s, rounds "
          + ", ".join(f"{r['round']}: {r['wall_s']:.3f} s {r['clients']}"
                      + (f" stragglers {r['stragglers']}" if r["stragglers"] else "")
                      for r in result["round_log"])
          + f"; bytes_down {result['bytes_down']}, bytes_up {result['bytes_up']}, "
          f"restarts {result['restarts']}")
    print(f"{label} phases (s, summed over threads): "
          + ", ".join(f"{k}={v:.3f}" for k, v in report["phase_s"].items())
          + f", senders waiting for their encoders {report['sender_encode_wait_s']:.3f}")
    print(f"{label} launches: {launches}; device peak {report['max_memory_allocated_bytes']} "
          f"bytes")
    return report


def run_live_path(torch, dev, label: str, spec: dict, proxied: dict | None = None):
    """One full-width live federation over real sockets on 127.0.0.1:
    ``run_live_federation(spawn=False)`` with ``FederationClient`` threads
    of this process (``proxied``: client name -> ChaosProxy plan), the
    launch counters zeroed just before and read just after, so they and
    the device peak cover the whole federation."""
    from repro_torch.core.resilience import ChaosProxy
    from repro_torch.kernels import ops
    from repro_torch.launch.federation import run_live_federation

    clock, started, proxies = PhaseClock(), [], []

    def on_listen(server):
        addresses = {}
        for name, plan in (proxied or {}).items():
            proxies.append(ChaosProxy(server.address, plan).start())
            addresses[name] = proxies[-1].address
        started.append(start_live_clients(spec, dev, server, clock, addresses))

    torch.cuda.synchronize()
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with socket_clock(clock):
            result = run_live_federation(spec, spawn=False, device=dev,
                                         round_timeout_s=LIVE_TIMEOUT_S, on_listen=on_listen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
    except Exception as exc:
        fail(f"{label}: {exc!r}; the clients' errors: {[e for _, es in started for e in es]}; "
             f"device peak {torch.cuda.max_memory_allocated()} bytes")
    finally:
        for proxy in proxies:
            proxy.close()
    join_live_clients(started)
    return result, live_report(torch, label, result, wall, clock, launches)


def check_live_launches(label: str, launches: dict, want: dict) -> None:
    want = {name: want.get(name, 0) for name in launches}
    if launches != want:
        fail(f"kernel launches on the {label} path {launches} != {want}")


def run_live(torch, dev) -> dict:
    """Phase A: ``examples/jobs/live_smoke.json`` at full width over real
    TCP, clients cut 4 -> 2 (memory), rounds 2 -> 1 (time). Each uplink
    quantizes as one fused group (B1) in its client; the spec names no
    aggregator, so
    the server's dense ``fedavg`` dequantizes every item (B2) before it
    folds: B1 = clients x rounds, B2 = that x 12; nothing else launches
    (the downlink is fp32). The weights must be bitwise the port's
    ``run_job`` on the same spec on the card (``--verify-sim``)."""
    from repro_torch.fl.job import run_job
    from repro_torch.testing import live_launches

    spec = load_job(LIVE_JOB, smoke=False, clients=LIVE_CLIENTS, rounds=LIVE_ROUNDS)
    clients, rounds = spec["clients"], spec["rounds"]
    result, report = run_live_path(torch, dev, "live", spec)
    want = live_launches(spec, result["uplink_log"])
    if want != {"quantize_blockwise8": clients * rounds,
                "dequantize_blockwise8": clients * rounds * N_ITEMS}:
        fail(f"live: the grant log implies {want}, not one clean uplink a client a round")
    check_live_launches("live", report["launches"], want)
    roster = [f"site-{i}" for i in range(clients)]
    if [r["clients"] for r in result["round_log"]] != [roster] * rounds or result["restarts"]:
        fail(f"live: rounds {result['round_log']}, restarts {result['restarts']}")
    final = result.pop("final_weights")
    if len(final) != N_ITEMS or sum(w.numel() for w in final.values()) != LLAMA_PARAMS \
            or not all(bool(torch.isfinite(w).all()) for w in final.values()):
        fail("live: final weights are not 12 finite items of full-width llama3.2-1b")
    release(torch)
    t0 = time.perf_counter()
    sim = run_job(spec, device=dev)
    report["run_job_s"] = time.perf_counter() - t0
    compare_weights(torch, "live vs run_job", final, sim["final_weights"])
    report["run_job_round_wall_s"] = [r["wall_s"] for r in sim["round_log"]]
    print(f"live: weights bitwise equal to run_job's ({report['run_job_s']:.3f} s, rounds "
          f"{report['run_job_round_wall_s']})")
    del final, sim
    release(torch)
    return report


def run_chaos(torch, dev) -> dict:
    """Phase B: ``examples/jobs/chaos_federation.json`` at full width,
    clients cut 4 -> 2 (memory), rounds 3 -> 2 (time): site-1 behind its
    own ChaosProxy with the spec's stall plan (8 s at 60,000 bytes up) against a grace of 5 s
    and quorum 0.5. The launches follow from the server's grant log
    (``repro_torch.testing.live_launches``): one B1 a grant (each grant
    re-encodes the cached result), one B2 an item that reached a fold
    (restarted folds included). The weights must be bitwise
    ``reference_run`` over the recorded contributor sets
    (``--verify-chaos``)."""
    from repro_torch.launch.federation import reference_run
    from repro_torch.testing import live_launches

    spec = load_job(CHAOS_JOB, smoke=False, clients=LIVE_CLIENTS, rounds=CHAOS_ROUNDS)
    plans = {name: plan for name, plan in spec["chaos"].items()
             if int(name.split("-")[1]) < spec["clients"]}
    result, report = run_live_path(torch, dev, "chaos", spec, proxied=plans)
    log = result["uplink_log"]
    check_live_launches("chaos", report["launches"], live_launches(spec, log))
    if not result["faults"]["stragglers"].get("site-1") \
            or not any("site-1" in r["stragglers"] for r in result["round_log"]):
        fail(f"chaos: site-1's stall did not make it a straggler: {result['round_log']}, "
             f"{result['faults']}")
    final = result.pop("final_weights")
    rosters = [r["clients"] for r in result["round_log"]]
    release(torch)
    t0 = time.perf_counter()
    ref = reference_run({k: v for k, v in spec.items() if k != "chaos"}, rosters, device=dev)
    report["reference_run_s"] = time.perf_counter() - t0
    compare_weights(torch, "chaos vs reference_run", final, ref)
    print(f"chaos: grants {[(e['round'], e['client'], e['outcome'], e['items']) for e in log]}; "
          f"faults {result['faults']}; weights bitwise equal to reference_run over {rosters} "
          f"({report['reference_run_s']:.3f} s)")
    del final, ref
    release(torch)
    return report


def run_federation_cli(args: list[str], label: str) -> dict:
    """``python -m repro_torch.launch.federation ARGS --json``: its exit
    code must be 0; returns its summary."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="live_cli_") as tmp:
        out = os.path.join(tmp, "summary.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.federation", *args, "--json", out],
            capture_output=True, text=True, timeout=LIVE_TIMEOUT_S, cwd=REPO,
            env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"{label}: exit {proc.returncode}: {proc.stderr[-3000:]}")
        with open(out) as fh:
            summary = json.load(fh)
    if any(code != 0 for code in summary["client_exit_codes"]):
        fail(f"{label}: client exit codes {summary['client_exit_codes']}")
    print(f"{label}: exit 0 in {wall:.3f} s; rounds "
          f"{[(r['clients'], r['stragglers']) for r in summary['round_log']]}; restarts "
          f"{summary['restarts']}; faults {summary['faults']}")
    return {"cli_wall_s": wall, **{k: summary[k] for k in (
        "round_log", "restarts", "faults", "bytes_down", "bytes_up", "wall_s",
        "resumed_from")}}


def run_live_clis(torch, dev) -> dict:
    """Phase C: both specs as they stand (smoke width, 4 clients) through
    ``python -m repro_torch.launch.federation`` with subprocess clients on
    the card — ``--verify-sim`` for live_smoke.json, ``--verify-chaos``
    for chaos_federation.json (its three ChaosProxy plans) — and
    live_smoke.json with fixed updates in this process, card vs CPU,
    bitwise."""
    from repro_torch.fl.job import initial_weights
    from repro_torch.launch.federation import FederationClient, FederationServer
    from repro_torch.testing import fixed_train_fn

    release(torch)
    out = {"live_smoke": run_federation_cli(["--spec", LIVE_JOB, "--verify-sim"],
                                            "live_smoke.json --verify-sim"),
           "chaos": run_federation_cli(["--spec", CHAOS_JOB, "--verify-chaos"],
                                       "chaos_federation.json --verify-chaos")}
    spec = load_job(LIVE_JOB)
    init = {k: v.numpy() for k, v in initial_weights(spec, device="cpu").items()}
    finals = {}
    for d in ("cpu", dev):
        server = FederationServer(spec, round_timeout_s=LIVE_TIMEOUT_S, device=d).start()
        try:
            clients = []
            for i in range(spec["clients"]):
                clients.append(FederationClient.for_spec(spec, i, server.address,
                                                         timeout_s=LIVE_TIMEOUT_S, device=d))
                clients[-1].executor.train_fn = fixed_train_fn(init, i, 0.05 * (i + 1))
            started = [client_threads(clients)]
            finals[str(d)] = {k: v.cpu() for k, v in server.run(init).items()}
            join_live_clients(started)
        finally:
            server.close()
    compare_weights(torch, "live_smoke fixed updates, card vs CPU", finals[str(dev)],
                    finals["cpu"])
    print("live_smoke.json, fixed updates, in process: card weights bitwise the CPU's")
    return out


def check_checkpoints(torch, dev) -> dict:
    """Phase D: full-width llama3.2-1b ``save_checkpoint`` with
    ``fmt="blockwise8"`` (B1 an item) and ``fmt="nf4"`` (B4 an item),
    ``iter_checkpoint`` back onto the card (B2 / B5 an item); the file
    must be bitwise the one written on the CPU (plain versions) from the
    same weights, and the loaded weights bitwise the CPU's load of it.
    Then a server checkpoint and ``--resume`` at smoke width (2 clients):
    round 0 checkpointed, then rounds 1.. resumed, ``--verify-sim``
    against an uninterrupted ``run_job``."""
    import filecmp
    import tempfile

    from repro_torch.checkpoint import iter_checkpoint, save_checkpoint
    from repro_torch.fl.job import initial_weights
    from repro_torch.kernels import ops

    release(torch)
    weights = initial_weights(load_job(LIVE_JOB, smoke=False), dev)
    host = {k: v.cpu() for k, v in weights.items()}
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_ckpt_") as tmp:
        card_path, cpu_path = os.path.join(tmp, "card.ckpt"), os.path.join(tmp, "cpu.ckpt")
        for fmt, quant, dequant in (("blockwise8", "quantize_blockwise8", "dequantize_blockwise8"),
                                    ("nf4", "quantize_4bit", "dequantize_4bit")):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            nbytes = save_checkpoint(card_path, weights, fmt=fmt)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = dict(iter_checkpoint(card_path, dev))
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            launches = ops.launch_counts()
            check_live_launches(f"checkpoint {fmt}", launches,
                                {quant: N_ITEMS, dequant: N_ITEMS})
            t0 = time.perf_counter()
            save_checkpoint(cpu_path, host, fmt=fmt)
            cpu_save_s = time.perf_counter() - t0
            if not filecmp.cmp(card_path, cpu_path, shallow=False):
                fail(f"checkpoint {fmt}: the card's file differs from the CPU's")
            compare_weights(torch, f"checkpoint {fmt} load, card vs CPU",
                            {k: v.cpu() for k, v in loaded.items()},
                            dict(iter_checkpoint(cpu_path, "cpu")))
            report[fmt] = {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
                           "cpu_save_s": cpu_save_s, "launches": launches}
            print(f"checkpoint {fmt}: {nbytes} bytes, card save {save_s:.3f} s, load "
                  f"{load_s:.3f} s (CPU save {cpu_save_s:.3f} s); file bitwise the CPU's, "
                  f"loads bitwise; launches {launches}")
            del loaded
        del weights, host
        release(torch)
        ckpt_dir = os.path.join(tmp, "rounds")
        base = ["--spec", LIVE_JOB, "--clients", "2", "--checkpoint-dir", ckpt_dir]
        run_federation_cli([*base, "--rounds", "1"], "live_smoke.json round 0, checkpointed")
        report["resume"] = run_federation_cli([*base, "--resume", "--verify-sim"],
                                              "live_smoke.json --resume --verify-sim")
    if report["resume"]["resumed_from"] != 0:
        fail(f"--resume restarted from {report['resume']['resumed_from']}, not round 0")
    return report


def bits_sum(torch, t):
    """The int64 sum of a tensor's 32-bit patterns, on its device: a leaf
    whose sum changed has moved (a copy to the host to compare would cost
    seconds at full width)."""
    return t.contiguous().view(torch.int32).sum(dtype=torch.int64)


def train_step_spans(events: list[dict]) -> list[float]:
    """Each ``train.step`` span's wall ms, in order."""
    return [e["dur"] / 1e3 for e in events if e.get("ph") == "X" and e["name"] == "train.step"]


def run_train(torch, dev, label: str, arch: str, batch: int, seq: int, layers,
              remat: bool = True) -> dict:
    """(T1) ``launch.train.train_loop`` on ``arch`` at full width (``layers``
    cuts the depth) from seeded weights, with zero frames or patches for
    the enc-dec and the VLM, the launch counters zeroed just before and
    read just after: no kernel launches (B7 has no gradient and every
    length here takes the masked softmax). Losses must be finite and
    every leaf must have moved. Step ms comes
    from the ``train.step`` spans (each ends in a synchronise), the peak
    from ``max_memory_allocated``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    from repro_torch.models import create_model
    from repro_torch.obs import trace as obs_trace
    from repro_torch.utils.trees import flatten_state_dict

    cfg = get_config(arch).with_overrides(remat=remat)
    if layers is not None:
        cfg = cfg.with_overrides(num_layers=layers)
    params = create_model(cfg).init(0, dev)
    initial = {k: bits_sum(torch, v) for k, v in flatten_state_dict(params).items()}
    extra = family_extra(torch, cfg, batch, "cpu")
    extra = None if extra is None else {k: v.numpy() for k, v in extra.items()}
    torch.cuda.synchronize()
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    tracer = obs_trace.Tracer(sync=torch.cuda.synchronize)
    ops.reset_launch_counts()
    print(f"{label}: {arch}{'' if remat else ' (remat off)'}, batch {batch} x {seq}"
          f"{'' if extra is None else ' + ' + str(list(extra))}, {TRAIN_STEPS} steps:")
    t0 = time.perf_counter()
    with obs_trace.activate(tracer):
        params, history = train_loop(cfg, steps=TRAIN_STEPS, batch_size=batch, seq_len=seq,
                                     params=params, log_every=1, extra_batch=extra,
                                     device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        fail(f"{label}: kernels launched on the training path: {launches}")
    if len(history) != TRAIN_STEPS or not all(math.isfinite(x) for x in history):
        fail(f"{label}: losses not finite: {history}")
    final = flatten_state_dict(params)
    moved = sum(not torch.equal(bits_sum(torch, final[k].detach()), v)
                for k, v in initial.items())
    if moved != len(initial):
        fail(f"{label}: only {moved} of {len(initial)} leaves moved")
    step_ms = train_step_spans(tracer.chrome_trace()["traceEvents"])
    median_ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    n_params = sum(v.numel() for v in final.values())
    report = {"arch": arch, "layers": cfg.num_layers, "params": n_params, "batch": batch,
              "seq": seq, "remat": remat, "losses": history,
              "step_ms": step_ms, "median_step_ms": median_ms,
              "tokens_per_s": batch * seq / (median_ms / 1e3), "wall_s": wall,
              "launches": launches, "max_memory_allocated_bytes": peak,
              "allocated_before_bytes": allocated_before}
    print(f"{label}: {n_params} params ({cfg.num_layers} layers), step ms "
          f"{[round(x, 3) for x in step_ms]}, median of steps 1-{TRAIN_STEPS - 1} "
          f"{median_ms:.3f} ms, {report['tokens_per_s']:.1f} tokens/s, wall {wall:.3f} s; "
          f"max_memory_allocated {peak} bytes ({allocated_before} before); no kernel launched")
    del params, final, initial
    release(torch)
    return report


def first_gradients(torch, model, init: dict, batch: dict, dev) -> dict:
    """``model``'s loss gradient at the flat weights ``init`` on ``batch``,
    computed on ``dev``, as a flat dict of CPU tensors."""
    from repro_torch.utils.trees import flatten_state_dict, tree_leaves, unflatten_state_dict

    params = unflatten_state_dict({k: v.to(dev).clone().requires_grad_(True)
                                   for k, v in init.items()})
    loss = model.loss(params, {k: v.to(dev) for k, v in batch.items()})[0]
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return {k: g.detach().cpu() for k, g in zip(flatten_state_dict(params), grads)}


def check_train_against_cpu(torch, dev) -> dict:
    """(T2) Each family of :data:`TRAIN_SMOKE` at smoke width, from the
    same seeded weights on the CPU and on the card, random frames /
    patches from a seed: the first step's gradient leaf by leaf
    (``testing.gradient_counts``: each leaf within :data:`TRAIN_GRAD_TOL`
    of its own largest, a leaf whose exact gradient is zero below
    ``testing.RESIDUE`` of the whole on both), then :data:`TRAIN_SMOKE_STEPS`
    ``train_loop`` steps: loss histories within :data:`TRAIN_HISTORY_TOL`
    relative (the last loss is taken after an update) and the weights
    under ``testing.trained_counts`` (C1's bound; a zero-gradient leaf
    within AdamW's sign-flip term), the CPU tests' tolerances."""
    from repro_torch import testing
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import train_loop
    from repro_torch.models import create_model
    from repro_torch.utils.trees import flatten_state_dict

    steps, batch, lr = TRAIN_SMOKE_STEPS, 2, 3e-4
    report = {}
    for family, arch in TRAIN_SMOKE:
        cfg = get_smoke_config(arch)
        model = create_model(cfg)
        zero = testing.zero_gradient_leaves(cfg)
        init = flatten_state_dict(model.init(0, "cpu"))
        extra = family_extra(torch, cfg, batch, "cpu", np.random.default_rng(5))
        extra = None if extra is None else {k: v.numpy() for k, v in extra.items()}
        first = {k: torch.as_tensor(v).long() for k, v in
                 SyntheticLMDataset(cfg.vocab_size, TRAIN_SMOKE_SEQ, seed=0).sample(batch).items()}
        first.update({k: torch.from_numpy(v) for k, v in (extra or {}).items()})
        grads = testing.gradient_counts(first_gradients(torch, model, init, first, "cpu"),
                                        first_gradients(torch, model, init, first, dev),
                                        zero, TRAIN_GRAD_TOL)
        outs = {}
        for d in ("cpu", dev):
            params, history = train_loop(cfg, steps=steps, batch_size=batch,
                                         seq_len=TRAIN_SMOKE_SEQ, lr=lr,
                                         params={k: v.clone() for k, v in init.items()},
                                         log_every=0, extra_batch=extra, device=d)
            outs[str(d)] = ({k: v.detach().cpu() for k, v in flatten_state_dict(params).items()},
                            history)
        (want, want_h), (got, got_h) = outs["cpu"], outs[str(dev)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got_h, want_h))
        counts = testing.trained_counts(want, got, zero, sign_flips=2 * lr * steps)
        if not grads["holds"]:
            fail(f"train {family} ({arch}) card vs CPU: first gradients {grads}")
        if rel > TRAIN_HISTORY_TOL or not counts["holds"]:
            fail(f"train {family} ({arch}) card vs CPU: losses {got_h} / {want_h}, {counts}")
        report[family] = {"arch": arch, "loss_rel": rel, "gradients": grads, **counts}
        print(f"train {family} ({arch}) smoke, card vs CPU: first gradients of "
              f"{grads['leaves']} leaves within {grads['worst_of_own'] * TRAIN_GRAD_TOL:.3g} of "
              f"their own largest (worst {grads['worst_leaf']}), zero-gradient leaves {zero} "
              f"below {grads['worst_zero_of_residue'] * testing.RESIDUE:.3g} of the whole; "
              f"{steps} steps: losses {got_h} within {rel:.3g} relative, weights within "
              f"{counts['worst_of_step']:.3g} quantization steps ({counts['beyond_step']} of "
              f"{counts['elements']} beyond one), zero-gradient leaves within "
              f"{counts['zero_max_abs']:.3g}")
    release(torch)
    return report


def check_train_forward_only(torch, dev) -> None:
    """(T3) A smoke-width llama3.2-1b ``train_loop`` step at seq 128 on the
    card routes attention to B7, whose backward must raise
    NotImplementedError (ROADMAP C13), as ``jax.grad`` through the
    reference's kernel fails: one launch a layer in the forward, and one
    more where the backward recomputes the last block (remat) before it
    reaches the kernel's backward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop

    cfg = get_smoke_config("llama3.2-1b")
    ops.reset_launch_counts()
    try:
        train_loop(cfg, steps=1, batch_size=2, seq_len=128, log_every=0, device=dev)
    except NotImplementedError as exc:
        flash = ops.launch_counts()["flash_attention"]
        print(f"train at seq 128 on the card raises NotImplementedError after {flash} B7 "
              f"launches: {exc}")
        if flash != cfg.num_layers + int(cfg.remat):
            fail(f"train at seq 128: {flash} B7 launches, expected "
                 f"{cfg.num_layers + int(cfg.remat)}")
    else:
        fail("a train_loop step at seq 128 on the card did not raise")
    release(torch)


def check_family_jobs_against_cpu(torch, dev) -> dict:
    """(T4) The first path's spec at smoke width for each arch of
    :data:`FAMILY_JOB_SMOKE`, with fixed updates (``testing.fixed_train_fn``)
    from the same weights on the CPU and on the card: final weights and
    wire bytes bitwise equal."""
    from repro_torch.fl.job import build_job, initial_weights
    from repro_torch.testing import fixed_train_fn

    report = {}
    for arch in FAMILY_JOB_SMOKE:
        spec = {**SPEC, "arch": arch, "smoke": True}
        init = {k: v.numpy() for k, v in initial_weights(spec, device="cpu").items()}
        outs = {}
        for d in ("cpu", dev):
            jb = build_job(spec, device=d, weights=init)
            for i, proxy in enumerate(jb.sim.proxies):
                proxy.executor.train_fn = fixed_train_fn(init, i, 0.05)
            out = jb.run()
            outs[str(d)] = ({k: v.cpu() for k, v in out["final_weights"].items()},
                            out["wire_bytes"])
        (want, want_bytes), (got, got_bytes) = outs["cpu"], outs[str(dev)]
        if got_bytes != want_bytes:
            fail(f"{arch} smoke job: wire bytes {got_bytes} on the card, {want_bytes} on the CPU")
        for name, w in want.items():
            if not torch.equal(bits(torch, got[name]), bits(torch, w)):
                fail(f"{arch} smoke job with fixed updates differs between card and CPU at "
                     f"{name}")
        report[arch] = {"items": len(want), "wire_bytes": want_bytes}
        print(f"{arch} smoke job, fixed updates, card vs CPU: {len(want)} items bitwise equal, "
              f"{want_bytes} wire bytes equal")
    return report


def load_example(name: str):
    """``examples/torch/<name>.py`` as a fresh module, its ``ROUNDS`` (if
    any) cut to :data:`EXAMPLE_ROUNDS`."""
    import importlib.util

    path = os.path.join(REPO, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if hasattr(module, "ROUNDS"):
        module.ROUNDS = EXAMPLE_ROUNDS
    return module


def captured(fn, *args):
    """``fn(*args)`` and what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


#: (E1) the kernels each example must launch on the card
EXAMPLE_KERNELS = {
    "quickstart": ("quantize_blockwise8", "dequantize_blockwise8"),
    "streaming_demo": ("quantize_4bit", "dequantize_4bit"),
    "async_federation": ("quantize_blockwise8", "dequantize_blockwise8"),
    "hetero_federation": ("quantize_blockwise8", "dequantize_blockwise8", "quantize_4bit",
                          "dequantize_4bit"),
    "serve_batch": ("slstm_scan",),
}
EXAMPLE_SECONDS = re.compile(r"\d+\.\d+s\b")
EXAMPLE_LOSS = re.compile(r"(site-\d): round (\d+) local loss ([\d.]+)")


def _example_on(torch, ex, name: str, device, state: dict):
    """One run of example ``name`` on ``device``: (what the comparison
    reads, the printed text). ``state`` carries the card's weights to
    the CPU run."""
    from repro_torch.models import create_model
    from repro_torch.utils.trees import flatten_state_dict, unflatten_state_dict

    def on(tree):
        flat = {k: v.to(device) for k, v in flatten_state_dict(tree).items()}
        return unflatten_state_dict(flat)

    if name == "quickstart":
        if "init" not in state:
            state["init"] = flatten_state_dict(create_model(ex.make_config()).init(0, device))
        (sim, final), text = captured(ex.run, device,
                                      {k: v.to(device, copy=True)
                                       for k, v in state["init"].items()})
        return {"messages": sim.stats.messages, "bytes": sim.stats.bytes_sent,
                "losses": EXAMPLE_LOSS.findall(text), "tensors": len(final)}, text
    if name == "streaming_demo":
        result, text = captured(ex.run, device)
        return {**result, "text": EXAMPLE_SECONDS.sub("_", text)}, text
    if name == "serve_batch":
        tokens, texts = {}, []
        for arch in ex.ARCHS:
            if arch not in state:
                state[arch] = ex.build(arch).init(0, device)
            out, text = captured(ex.serve, arch, device, on(state[arch]))
            tokens[arch] = out.cpu().numpy().tolist()
            texts.append(text)
        return {"tokens": tokens}, "".join(texts)
    _, text = captured(ex.main, ["--device", str(device)])     # async, hetero
    return {"stdout": text}, text


def run_examples(torch, dev) -> dict:
    """(E1) Each of the port's examples on the card, then on the CPU in
    this process from the card's weights, held to its CPU test's
    criteria: async and hetero the same printed bytes; streaming the same
    MemoryMeter peaks, nf4 checkpoint bytes and error (its text equal once
    the seconds are blanked); serve_batch the same greedy tokens;
    quickstart the same message count, each printed loss within
    :data:`EXAMPLE_LOSS_ATOL` and the wire bytes within
    :data:`EXAMPLE_BYTES_RTOL`. The launch counters are zeroed before
    each card run; every kernel of :data:`EXAMPLE_KERNELS` must launch.
    One torch thread: R1's dry runs run beside on the host's cores, and a
    pool of one thread a core then stalls at every barrier (quickstart's
    CPU run took 66.5 s with 8 threads beside one busy core on an 8-core
    CPU host, 3.2 s with one)."""
    from repro_torch.kernels import ops

    out = {}
    t_phase = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in EXAMPLES:
            out[name] = _run_example(torch, ops, dev, name)
    finally:
        torch.set_num_threads(threads)
    print(f"E1 phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def _run_example(torch, ops, dev, name: str) -> dict:
    """(E1) Example ``name`` on the card and then on the CPU; see
    :func:`run_examples`."""
    ex = load_example(name)
    state: dict = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card, card_text = _example_on(torch, ex, name, dev, state)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    t0 = time.perf_counter()
    cpu, _ = _example_on(torch, ex, name, torch.device("cpu"), state)
    cpu_s = time.perf_counter() - t0
    if name == "quickstart":
        ok = (card["messages"] == cpu["messages"] and card["tensors"] == cpu["tensors"]
              and [c[:2] for c in card["losses"]] == [c[:2] for c in cpu["losses"]]
              and all(abs(float(a[2]) - float(b[2])) <= EXAMPLE_LOSS_ATOL
                      for a, b in zip(card["losses"], cpu["losses"]))
              and abs(card["bytes"] - cpu["bytes"]) <= EXAMPLE_BYTES_RTOL * cpu["bytes"])
    else:
        ok = card == cpu
    if not ok:
        fail(f"E1 {name}: the card's run differs from the CPU's: {card} vs {cpu}")
    missing = [k for k in EXAMPLE_KERNELS[name] if not launches[k]]
    if missing:
        fail(f"E1 {name}: {missing} never launched on the card ({launches})")
    if name == "streaming_demo" and not (launches["quantize_4bit"]
                                         == launches["dequantize_4bit"] == 9):
        fail(f"E1 streaming_demo: nf4 checkpoint of 9 items launched {launches}")
    shown = {k: v for k, v in launches.items() if v}
    print(f"E1 {name}: card {card_s:.3f} s, CPU {cpu_s:.3f} s, equal to the CPU's run; "
          f"launches {shown}")
    for line in card_text.strip().splitlines():
        print(f"E1 {name} | {line}")
    return {"card_s": card_s, "cpu_s": cpu_s, "launches": launches,
            "card": card if name != "streaming_demo" else
            {k: v for k, v in card.items() if k != "text"}}


def measured_span_s(run: dict, kind: str) -> float:
    """The seconds ``run`` measured for one step of ``kind``: the median
    train step, the prefill span, or one decode step."""
    if kind == "train":
        return run["median_step_ms"] / 1e3
    if kind == "prefill":
        return run["prefill_s"]
    return run["decode_ms_per_token"] / 1e3


def check_rooflines(torch, card: str, runs: dict, dry_runs: dict) -> dict:
    """(R1) Each run of :data:`ROOFLINE_RUNS` dry-run on meta
    (``repro_torch.launch.dryrun.roofline``, one chip, fp32, TF32 off, the
    card's peaks from its name): counted FLOPs and bytes, compute and
    memory seconds, the bottleneck, the meta peak beside the run's
    ``max_memory_allocated``, and the share = max(compute_s, memory_s) /
    the measured seconds, which must not pass :data:`ROOFLINE_SHARE_MAX`.
    Then the command-line dry runs :func:`start_dry_runs` started
    (``--all`` at one chip, and each pair of :data:`ROOFLINE_MESH_PAIRS`
    on the (16, 16) mesh over a fake process group), a line a pair,
    timed; each must count every pair."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import ShapePlan

    name = torch.cuda.get_device_name(0)
    print(f"R1 rooflines on {card} (peaks of {name!r}; fp32, TF32 off, one chip):")
    out = {}
    for label, run_label, arch, kind, batch, length, remat in ROOFLINE_RUNS:
        cfg = get_config(arch).with_overrides(remat=remat)
        r = dryrun.roofline(cfg, ShapePlan(label, kind, length, batch, "paper"), arch=arch,
                            card=name)
        measured = measured_span_s(runs[run_label], kind)
        share = max(r["compute_s"], r["memory_s"]) / measured
        peak = r["memory_per_device"]["peak_bytes"]
        allocated = runs[run_label]["max_memory_allocated_bytes"]
        out[label] = {**r, "measured_s": measured, "share": share,
                      "max_memory_allocated_bytes": allocated}
        print(f"R1 {label}: {arch} {kind} {batch} x {length}: counted {r['counted_flops']:.6e} "
              f"FLOPs, {r['counted_bytes']:.6e} bytes; compute {r['compute_s'] * 1e3:.3f} ms, "
              f"memory {r['memory_s'] * 1e3:.3f} ms, bound by {r['bottleneck']}; measured "
              f"{measured * 1e3:.3f} ms: share {share:.4f}; meta peak {peak:.6e} bytes, "
              f"max_memory_allocated {allocated} bytes (the whole run); counted in "
              f"{r['count_s']:.2f} s")
        if not share <= ROOFLINE_SHARE_MAX:
            fail(f"R1 {label}: the roofline {max(r['compute_s'], r['memory_s']):.6f} s is "
                 f"{share:.3f} of the measured {measured:.6f} s (> {ROOFLINE_SHARE_MAX})")
    for key, (proc, t0, stdout, stderr, extra) in dry_runs.items():
        try:
            proc.wait(timeout=ROOFLINE_SWEEP_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        seconds = time.perf_counter() - t0
        stdout.seek(0)
        stderr.seek(0)
        text, errors = stdout.read().decode(), stderr.read().decode()
        stdout.close()
        stderr.close()
        lines = [ln for ln in text.splitlines() if ln.startswith(("[ok]", "[FAIL]"))]
        for line in lines:
            print(f"R1 {key} {line}")
        print(f"R1 {key}: {text.strip().splitlines()[-1] if text.strip() else ''}; the process "
              f"joined {seconds:.2f} s after it started (before T1, beside the training phases)")
        counted = proc.returncode == 0 and lines and not any(
            ln.startswith("[FAIL]") for ln in lines)
        if not counted:
            fail(f"R1 dry run {' '.join(extra)} exited {proc.returncode}: {errors[-2000:]}")
        out[key] = {"lines": lines, "seconds": seconds}
    return out


def start_dry_runs(torch) -> dict:
    """Start R1's command-line dry runs on the card's host (they use the
    CPU only): the ``--all`` sweep at one chip and each pair of
    :data:`ROOFLINE_MESH_PAIRS` on the (16, 16) mesh, the card's peaks,
    one thread each, their output in temporary files;
    :func:`check_rooflines` waits for them."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    name = torch.cuda.get_device_name(0)
    runs = {}
    for key, extra in (("sweep", ["--all"]),
                       *((f"mesh {arch} {shape}",
                          ["--arch", arch, "--shape", shape, "--mesh", "16x16"])
                         for arch, shape in ROOFLINE_MESH_PAIRS)):
        stdout, stderr = tempfile.TemporaryFile(), tempfile.TemporaryFile()
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *extra,
                                 "--card", name],
                                stdout=stdout, stderr=stderr, cwd=REPO, env=env)
        runs[key] = (proc, time.perf_counter(), stdout, stderr, extra)
    return runs


def run_family_round(torch, dev) -> dict:
    """(T4) The first path (blockwise8 + streaming fold, 2 clients, 1
    round) with :data:`FAMILY_JOB_ARCH` at full width through
    ``repro_torch.fl.job``, the counters zeroed before and checked after:
    one B1 a message, one B2 a downlinked item, one B3 an uplinked item."""
    from repro_torch.configs import get_config
    from repro_torch.models import create_model

    spec = {**SPEC, "arch": FAMILY_JOB_ARCH}
    n_items = len(create_model(get_config(FAMILY_JOB_ARCH)).param_shapes())
    clients, rounds = spec["clients"], spec["rounds"]
    return run_path(torch, dev, f"blockwise8_{FAMILY_JOB_ARCH}", spec, {
        "quantize_blockwise8": 2 * clients * rounds,
        "dequantize_blockwise8": clients * rounds * n_items,
        "dequant_accumulate8_into": clients * rounds * n_items}, n_items=n_items)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    ap.add_argument("--svd-drivers", action="store_true",
                    help="also time both exact cuSOLVER SVD drivers on the largest lora item")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32: off for matmul and cuDNN")

    t0 = time.perf_counter()
    probe = start_mma_probe_build(str(_build.BUILD_DIR))
    lib_path, log = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s ({len(_build.SOURCES)} sources in parallel) -> "
          f"{os.path.relpath(lib_path, REPO)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line \
                or line.startswith("== "):
            print(f"  ptxas: {line.strip()}")

    sass = check_sass(str(lib_path))
    rates = mma_sync_rates(torch, *probe)

    dev = torch.device("cuda")
    rows = check_kernels(torch, dev)
    rows.update(check_fourbit_kernels(torch, dev))
    clients, rounds = SPEC["clients"], SPEC["rounds"]
    bw8 = run_path(torch, dev, "blockwise8", SPEC, {
        "quantize_blockwise8": 2 * clients * rounds,
        "dequantize_blockwise8": clients * rounds * N_ITEMS,
        "dequant_accumulate8_into": clients * rounds * N_ITEMS})
    clients, rounds = SPEC_NF4["clients"], SPEC_NF4["rounds"]
    nf4 = run_path(torch, dev, "nf4", SPEC_NF4, {
        # one fused group per downlink and per uplink message; one decode
        # per item on the client (downlink) and on the server (uplink)
        "quantize_4bit": 2 * clients * rounds,
        "dequantize_4bit": 2 * clients * rounds * N_ITEMS})
    parity = check_against_cpu(torch, dev)
    parity_nf4 = check_nf4_against_cpu(torch, dev)
    legacy = run_legacy(torch, dev)
    parity_legacy = check_legacy_against_cpu(torch, dev)
    async_run = run_async(torch, dev)
    parity_async = check_async_against_cpu(torch, dev)
    secure_agg = check_secure_agg_against_cpu(torch, dev)
    svd = time_svd_drivers(torch, dev) if args.svd_drivers else None
    t_lora = time.perf_counter()
    lora_items = check_lora_items(torch, dev)
    lora = run_lora(torch, dev)
    lora["phases_wall_s"] = time.perf_counter() - t_lora
    print(f"lora phases at {LORA_LAYERS} of llama3.2-1b's 16 layers (items check and round): "
          f"{lora['phases_wall_s']:.3f} s")
    parity_lora = check_lora_against_cpu(torch, dev)
    topk_bf16 = check_topk_bf16(torch, dev)
    table2_rows, bw8_message = table2(torch, dev)
    table3_rows = table3(torch, bw8_message)
    del bw8_message

    flash = check_flash_kernel(torch, dev, rates, ptxas_report(log))
    serve = {label: run_serve(torch, dev, label, window, batch, prompt, gen)
             for label, window, batch, prompt, gen in SERVE_RUNS}
    serve_cpu = check_serve_against_cpu(torch, dev)
    check_forward_only(torch, dev)
    family = {label: run_family_serve(torch, dev, label, arch, batch, prompt, gen, layers,
                                      flash_n)
              for label, arch, batch, prompt, gen, layers, flash_n in FAMILY_SERVE_RUNS}
    family_cpu = check_family_serve_against_cpu(torch, dev)
    agg = check_agg_kernel(torch, dev)
    fl = run_fl_train(torch, agg["flat_elements"])

    slstm = check_slstm_kernel(torch, dev)
    label, batch, prompt, gen = SERVE_XLSTM
    serve_xlstm = run_serve_xlstm(torch, dev, label, batch, prompt, gen)
    xlstm_cpu = check_xlstm_serve_against_cpu(torch, dev)
    check_slstm_forward_only(torch, dev)
    live = run_live(torch, dev)
    chaos = run_chaos(torch, dev)
    live_cli = run_live_clis(torch, dev)
    checkpoints = check_checkpoints(torch, dev)
    dry_runs = start_dry_runs(torch)
    examples = run_examples(torch, dev)
    train = {label: run_train(torch, dev, label, arch, batch, seq, layers)
             for label, arch, batch, seq, layers in TRAIN_RUNS}
    label, arch, batch, seq, layers = TRAIN_RUNS[0]
    train[f"{label}_no_remat"] = run_train(torch, dev, label, arch, batch, seq, layers,
                                           remat=False)
    on, off = train[label], train[f"{label}_no_remat"]
    print(f"{label} remat on / off: peak {on['max_memory_allocated_bytes']} / "
          f"{off['max_memory_allocated_bytes']} bytes, step {on['median_step_ms']:.3f} / "
          f"{off['median_step_ms']:.3f} ms")
    train_cpu = check_train_against_cpu(torch, dev)
    check_train_forward_only(torch, dev)
    family_round = run_family_round(torch, dev)
    family_jobs = check_family_jobs_against_cpu(torch, dev)
    t_r1 = time.perf_counter()
    rooflines = check_rooflines(torch, card, {**train, **family, **serve}, dry_runs)
    print(f"R1 phase: {time.perf_counter() - t_r1:.1f} s")
    rows["slstm_scan"] = {
        **{k: slstm["serve_xlstm"][k] for k in ("shape", "ms", "us_per_step", "plain_ms",
                                                 "library_ms", "bound_ms", "bound_by",
                                                 "layout", "max_abs_err")},
        "long_prompt": slstm["long_prompt"], "cases_max_abs_err": slstm["cases_max_abs_err"]}
    rows["dequant_accumulate8"] = agg
    windowed = flash["serve_window"]
    rows["flash_attention"] = {
        **{k: flash["serve_full"][k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                "bound_ms", "bound_by", "bound_fp32_ms",
                                                "fp32_tflops", "max_abs_err")},
        "windowed": {**windowed, "launches": serve["serve_window"]["launches"]
                     ["flash_attention"]},
        "families": {label: {**flash[label], "launches": family[label]["launches"]
                             ["flash_attention"]} for label, *_ in FAMILY_FLASH_SHAPES},
        "cases_max_abs_err": flash["cases_max_abs_err"]}

    paths = {"blockwise8": bw8, "nf4": nf4, **serve, "fl_int8": fl["fl_int8"],
             "serve_xlstm": serve_xlstm}
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": paths[path]["launches"][name],
         "launches_async": async_run["launches"][name],
         "launches_lora": lora["launches"][name],
         "launches_live": live["launches"][name],
         "launches_families": {label: r["launches"][name] for label, r in family.items()},
         **rows[name]}
        for name, (source, replaces, path) in KERNELS.items()
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": build_s, "sass": sass,
                       "mma_sync_tflops": rates,
                       "kernels": kernels, "slice": bw8, "slice_nf4": nf4,
                       "cpu_parity": parity, "cpu_parity_nf4": parity_nf4,
                       "legacy": legacy, "cpu_parity_legacy": parity_legacy,
                       "async": async_run, "cpu_parity_async": parity_async,
                       "secure_agg": secure_agg, "svd_drivers": svd,
                       "lora_items": lora_items, "lora": lora,
                       "cpu_parity_lora": parity_lora, "topk_bf16": topk_bf16,
                       "table2": table2_rows, "table3": table3_rows,
                       "flash": flash, "serve": serve,
                       "serve_cpu_parity": serve_cpu, "family_serve": family,
                       "family_cpu_parity": family_cpu,
                       "fl_train": fl, "slstm": slstm, "serve_xlstm": serve_xlstm,
                       "serve_xlstm_cpu_parity": xlstm_cpu, "live": live,
                       "chaos": chaos, "live_cli": live_cli, "checkpoints": checkpoints,
                       "train": train, "train_cpu_parity": train_cpu,
                       "family_round": family_round, "family_jobs_cpu_parity": family_jobs,
                       "examples": examples, "rooflines": rooflines},
                      fh, indent=1)
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
