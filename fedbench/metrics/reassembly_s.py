"""Seconds a round spends reassembling items that span several chunks on
the receiving side: the program's ``wire.reassemble`` spans (the buffer's
allocation and each chunk's copy into it, with the sender's chunk loop
for that item), per round. None when no such span ran."""


def read(r):
    s = r.trace.span_seconds("wire.reassemble")
    return s / r.rounds if s > 0 else None
