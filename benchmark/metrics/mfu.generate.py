"""mfu.generate: a request's operations (the benchmark's reference
sampling at the cell's shapes, counted on the meta device) times the
window's requests per second, over the H100's dense bf16 peak, in per
cent."""

LAYER = "sample step, training/steps.py::make_sample_step"
UNIT = "%"
MOVES = "generate_images_per_s"


def read(obs):
    if obs.get("kind") != "generate" or "ops_per_request" not in obs:
        return None
    return (100.0 * obs["ops_per_request"] * obs["requests_per_s"]
            / obs["peak_flops"])
