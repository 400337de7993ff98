"""Peak resident set of another process, sampled from outside it.

Run as a child process (``python hostmem.py PID``) so that the measured
process's interpreter lock cannot delay a sample past a short peak. It
reads ``VmRSS`` from ``/proc/PID/status`` every :data:`PERIOD_S` and keeps
the largest reading since the last ``reset``. Commands arrive one a line
on its standard input: ``reset`` answers with the current reading,
``stop`` with the peak and ends it. Readings are bytes.
"""
from __future__ import annotations

import os
import select
import subprocess
import sys
from pathlib import Path

PERIOD_S = 0.002


def rss_bytes(pid: int) -> int:
    with open(f"/proc/{pid}/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError(f"no VmRSS for process {pid}")


def serve(pid: int) -> None:
    peak = 0
    while True:
        ready, _, _ = select.select([sys.stdin], [], [], PERIOD_S)
        now = rss_bytes(pid)
        peak = max(peak, now)
        if not ready:
            continue
        cmd = sys.stdin.readline().strip()
        if cmd == "reset":
            peak = now
            print(now, flush=True)
        else:   # "stop", or the parent closed the pipe
            print(peak, flush=True)
            return


class HostSampler:
    """The parent's handle on the sampling child."""

    def __init__(self) -> None:
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(os.getpid())],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def _ask(self, cmd: str) -> int:
        if self.proc.stdin is None or self.proc.stdout is None:
            raise RuntimeError("the sampler's pipes are closed")
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return int(self.proc.stdout.readline())

    def reset(self) -> int:
        return self._ask("reset")

    def stop(self) -> int:
        try:
            return self._ask("stop")
        finally:
            self.close()

    def close(self) -> None:
        """End the child (its input closes, so it stops) and wait for it."""
        if self.proc.stdin is not None:
            self.proc.stdin.close()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        if self.proc.stdout is not None:
            self.proc.stdout.close()


if __name__ == "__main__":
    serve(int(sys.argv[1]))
