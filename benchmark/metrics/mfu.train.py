"""mfu.train: the train step's operations (the benchmark's reference step
at the cell's shapes, counted on the meta device) times the window's
steps per second, over the H100's dense bf16 peak, in per cent."""

LAYER = "train step, training/steps.py"
UNIT = "%"
MOVES = "train_images_per_s"


def read(obs):
    if obs.get("kind") != "train" or "ops_per_step" not in obs:
        return None
    return 100.0 * obs["ops_per_step"] * obs["steps_per_s"] / obs["peak_flops"]
