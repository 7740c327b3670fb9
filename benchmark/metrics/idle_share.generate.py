"""idle_share.generate: the per cent of the traced stretch during which no
kernel, copy or set runs on any stream of the card (torch.profiler)."""

from benchmark.trace import idle_share

LAYER = "device"
UNIT = "%"
MOVES = "generate_images_per_s"


def read(obs):
    if obs.get("kind") != "generate" or obs.get("trace") is None:
        return None
    return idle_share(obs["trace"].busy_s, obs["trace"].window_s)
