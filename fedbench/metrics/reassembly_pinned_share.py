"""Share (%) of the bytes reassembled from several chunks that the
receiver assembled in page-locked buffers: the ``bytes`` of the
program's ``wire.reassemble`` spans whose ``pinned`` arg is true, over
the ``bytes`` of all of them. None when no such span carries the arg."""


def read(r):
    spans = [sp for sp in r.trace.spans if sp["name"] == "wire.reassemble"]
    if not any("pinned" in sp["args"] for sp in spans):
        return None
    total = sum(sp["args"]["bytes"] for sp in spans)
    pinned = sum(sp["args"]["bytes"] for sp in spans if sp["args"].get("pinned"))
    return 100.0 * pinned / total if total else None
