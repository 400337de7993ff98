"""Seconds a round spends in the downlink: the program's ``wire.transmit``
spans of kind ``task_data`` (encode, framing and streaming, the client's
decode), summed over the traced window's rounds, per round."""


def read(r):
    s = r.trace.span_seconds("wire.transmit", kind="task_data")
    return s / r.rounds if s > 0 else None
