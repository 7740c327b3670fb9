"""busy_ms_per_request.generate: milliseconds per request in which some
kernel, copy or set runs on the card, over the traced requests
(torch.profiler): the device's work per request."""

LAYER = "device"
UNIT = "ms"
MOVES = "generate_images_per_s"


def read(obs):
    if obs.get("kind") != "generate" or obs.get("trace") is None:
        return None
    return 1e3 * obs["trace"].busy_s / obs["traced_requests"]
