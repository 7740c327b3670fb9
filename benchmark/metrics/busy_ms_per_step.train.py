"""busy_ms_per_step.train: milliseconds per train step in which some
kernel, copy or set runs on the card, over the traced call
(torch.profiler): the device's work per step, steadier than the host's
pace."""

LAYER = "device"
UNIT = "ms"
MOVES = "train_images_per_s"


def read(obs):
    if obs.get("kind") != "train" or obs.get("trace") is None:
        return None
    return 1e3 * obs["trace"].busy_s / obs["traced_steps"]
