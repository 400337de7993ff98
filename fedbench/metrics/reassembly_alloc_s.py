"""Seconds a round spends allocating the receive buffers of items that
span several chunks: the ``alloc_s`` args of the program's
``wire.reassemble`` spans (an uninitialised byte tensor an item, from
torch's caching host allocator, page-locked where the receiver's decoder
is on CUDA), per round. None when no such span ran."""


def read(r):
    spans = [sp for sp in r.trace.spans if sp["name"] == "wire.reassemble"]
    if not spans:
        return None
    return sum(sp["args"]["alloc_s"] for sp in spans) / r.rounds
