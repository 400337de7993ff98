"""Seconds a round spends in the clients' local training: the program's
``client.train`` spans (forward, backward and AdamW of every local
step), per round."""


def read(r):
    s = r.trace.span_seconds("client.train")
    return s / r.rounds if s > 0 else None
