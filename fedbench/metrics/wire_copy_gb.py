"""Gigabytes the wire layer copies a round on the host (joins, exports,
reassembly fills): the ``copied_bytes`` args of the program's
``wire.transmit`` spans, the ``MemoryMeter``'s count over each transfer,
per round. None when the spans carry no such count."""


def read(r):
    counts = [sp["args"]["copied_bytes"] for sp in r.trace.spans
              if sp["name"] == "wire.transmit" and "copied_bytes" in sp.get("args", {})]
    if not counts:
        return None
    return sum(counts) / r.rounds / 1e9
