"""The codec work's share of its HBM bound: the least time the round's
encodes, decodes and folds need at the card's HBM rate (bytes from the
message's shapes), over the device time of the work launched inside the
program's codec spans. Host-device copies are left out of that time:
they run over PCIe, not HBM. None when no codec span ran, or on a card
with no peak in the table."""

SPANS = ("kernel.quantize_batch", "stage.decode.quantize", "kernel.dequant_accumulate8")
PCIE_COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def read(r):
    if r.peaks is None:
        return None
    device_s = r.trace.device_s_launched_in(SPANS, skip_prefixes=PCIE_COPIES)
    if not device_s:
        return None
    least_s = r.codec_bytes_per_round * r.rounds / r.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / device_s
