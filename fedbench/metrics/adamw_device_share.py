"""AdamW's share of the local training's device time: the device time of
the work launched inside the program's ``train.optimizer`` spans over
that launched inside its ``client.train`` spans. None when either span
is absent or no device work was launched in training."""


def read(r):
    train_s = r.trace.device_s_launched_in(("client.train",))
    optimizer_s = r.trace.device_s_launched_in(("train.optimizer",))
    if not train_s or optimizer_s is None:
        return None
    return 100.0 * optimizer_s / train_s
