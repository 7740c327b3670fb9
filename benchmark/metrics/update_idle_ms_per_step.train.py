"""update_idle_ms_per_step.train: milliseconds per train step with
nothing on the card while the host is inside ``eegan.train.update`` (the
seven optimizer updates a step: zeros, clipping, Adam): every idle
stretch of the traced call whose midpoint it covers
(``benchmark/spans.py``). Nothing when the program has no such span."""

from benchmark import spans

LAYER = "train step, training/steps.py"
UNIT = "ms"
MOVES = "train_images_per_s"
SPANS = ("train.update",)


def read(obs):
    s = spans.of_run(obs, "train")
    if s is None or not s.has(SPANS):
        return None
    return 1e3 * s.idle_s(SPANS) / obs["traced_steps"]
