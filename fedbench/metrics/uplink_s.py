"""Seconds a round spends in the uplink: the program's ``wire.transmit``
spans of kind ``task_result`` (encode, crc32, framing and streaming, and
the server's streaming fold or decode), per round."""


def read(r):
    s = r.trace.span_seconds("wire.transmit", kind="task_result")
    return s / r.rounds if s > 0 else None
