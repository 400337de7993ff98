"""The transmission buffers' high-water mark over the window, from the
program's ``MemoryMeter`` (the bytes the message layer holds live)."""


def read(r):
    return r.meter_peak_bytes / 1e6 if r.meter_peak_bytes > 0 else None
