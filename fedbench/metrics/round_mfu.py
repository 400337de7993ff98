"""The whole round's share of the card's TF32 tensor-core peak: the model
FLOPs of a round's local training (the benchmark's count, no recompute)
over the traced window's round time. None on a card with no peak in the
table."""


def read(r):
    if r.peaks is None:
        return None
    return 100.0 * r.flops_per_round / (r.round_s * r.peaks["tf32_flops"])
