"""affine_fwd_roofline.generate: the least time of kernel 1's launches in
the traced requests (bytes each launch must move, over 3.35 TB/s), over
the device time of the ``affine_fwd`` kernel in the trace, in per cent.
Nothing when the kernel did not run."""

from benchmark.counts import affine_bound_s

LAYER = "kernel 1, ops/affine.py"
UNIT = "%"
MOVES = "generate_images_per_s"


def read(obs):
    if obs.get("kind") != "generate" or obs.get("trace") is None:
        return None
    spent = obs["trace"].kernel_s("affine_fwd")
    if spent <= 0:
        return None
    a = obs["affine"]
    return (100.0 * obs["traced_requests"]
            * affine_bound_s(a["B"], a["ngf"], a["elem"]) / spent)
