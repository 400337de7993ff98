"""Seconds a round spends allocating the receive buffers of items that
span several chunks: the ``alloc_s`` args of the program's
``wire.reassemble`` spans (a fresh, zero-filled ``bytearray`` an item),
per round. None when no such span ran."""


def read(r):
    spans = [sp for sp in r.trace.spans if sp["name"] == "wire.reassemble"]
    if not spans:
        return None
    return sum(sp["args"]["alloc_s"] for sp in spans) / r.rounds
