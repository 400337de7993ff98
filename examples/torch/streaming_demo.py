"""Paper §III / Table III demo on the PyTorch port: one global-weight
transmission under the three streaming settings, with byte-exact peak
transmission memory — plus the pull-mode ObjectRetriever, a streaming
nf4 checkpoint and a real-TCP driver round trip.

The weights are tensors on ``--device`` (the card by default): the
streamers copy each item to the host as they frame it, and the nf4
checkpoint quantizes and dequantizes there, through the hand-written
4-bit kernels on the card. The weights are drawn with numpy from seed 0,
as ``examples/streaming_demo.py`` draws them, so both report the same
peaks, checkpoint bytes and error.

    PYTHONPATH=src python examples/torch/streaming_demo.py
    PYTHONPATH=src python examples/torch/streaming_demo.py --device cpu
"""
import argparse
import os
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import iter_checkpoint, save_checkpoint
from repro_torch.core import serialization as ser
from repro_torch.core import streaming as sm
from repro_torch.utils.device import resolve_device
from repro_torch.utils.mem import MemoryMeter

MODES = ("regular", "container", "file")


def make_state(device: Any) -> dict[str, torch.Tensor]:
    """An embed-dominated model dict, like Llama's Table I layout."""
    rng = np.random.default_rng(0)
    sd = {"embed_tokens": rng.standard_normal((16384, 512)).astype(np.float32)}
    for i in range(8):
        sd[f"layers.{i}.w"] = rng.standard_normal((512, 2048)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in sd.items()}


def transmit(mode: str, sd: dict[str, torch.Tensor], src: str, tmp: str) -> int:
    """One transmission of ``sd`` in ``mode`` over loopback; returns the
    MemoryMeter's peak in bytes and prints it."""
    meter = MemoryMeter()
    t0 = time.time()
    with meter.activate():
        driver = sm.LoopbackDriver()
        if mode == "regular":
            recv = sm.BlobReceiver()
            driver.connect(recv.on_chunk)
            sm.ObjectStreamer(driver).send_container(sd)
        elif mode == "container":
            recv = sm.ContainerReceiver(consume=lambda n, v: None)
            driver.connect(recv.on_chunk)
            sm.ContainerStreamer(driver).send_container(sd)
        else:
            recv = sm.FileReceiver(os.path.join(tmp, "out.bin"))
            driver.connect(recv.on_chunk)
            sm.FileStreamer(driver).send_file(src)
    print(f"{mode:10s} peak transmission memory {meter.peak/1e6:8.2f} MB "
          f"({time.time()-t0:.2f}s)")
    return meter.peak


def run(device: Any) -> dict[str, Any]:
    """The demo; returns the numbers it prints: ``peaks`` by mode, the
    checkpoint's ``nbytes`` and its ``err``."""
    device = resolve_device(device)
    sd = make_state(device)
    total = sum(v.numel() * v.element_size() for v in sd.values())
    largest = max(v.numel() * v.element_size() for v in sd.values())
    print(f"model: {len(sd)} tensors, {total/1e6:.1f} MB "
          f"(largest item {largest/1e6:.1f} MB)\n")

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "model.bin")
        with open(src, "wb") as fh:
            fh.write(ser.serialize_container(sd))
        peaks = {mode: transmit(mode, sd, src, tmp) for mode in MODES}

        # pull-mode retrieval (paper contribution 2: ObjectRetriever)
        retr = sm.ObjectRetriever()
        retr.register_container("global_weights", sd)
        got = retr.retrieve("global_weights", mode="container")
        if set(got) != set(sd):
            raise RuntimeError(f"ObjectRetriever returned {sorted(got)}")
        print("\nObjectRetriever: container pulled OK")

        # streaming checkpoint: written item-by-item, servable by FileStreamer
        ck = os.path.join(tmp, "ckpt.stream")
        nbytes = save_checkpoint(ck, sd, fmt="nf4")  # 4-bit at rest
        err = max(float(torch.max(torch.abs(back - sd[k])))   # streamed off disk
                  for k, back in iter_checkpoint(ck, device))
        print(f"streaming checkpoint: {nbytes/1e6:.1f} MB on disk (nf4), "
              f"max dequant err {err:.3f}")

    # driver swap: same streamer over real TCP (127.0.0.1)
    driver = sm.TCPDriver()
    recv = sm.ContainerReceiver()
    driver.connect(recv.on_chunk)
    sm.ContainerStreamer(driver).send_container(sd)
    driver.close()
    if set(recv.result) != set(sd):
        raise RuntimeError(f"the TCP driver delivered {sorted(recv.result)}")
    print("TCP driver: container streamed over localhost OK")
    return {"peaks": peaks, "nbytes": nbytes, "err": err}


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the weights (default: cuda; cpu on request)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
