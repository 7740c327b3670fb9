"""affine_mask_relu_roofline.generate: the least time of kernel 1's work
in the traced requests (as ``affine_fwd_roofline.generate`` counts it:
the bytes each of the 14 launches a generator forward must move, over
3.35 TB/s), over the device-busy time of the work launched under the op
entry's span (``eegan.ops.affine_mask_relu.fwd``, whatever kernel does
it), in per cent. Nothing when the program has no such span or it
launched nothing."""

from benchmark import spans
from benchmark.counts import affine_bound_s

LAYER = "kernel 1, ops/affine.py"
UNIT = "%"
MOVES = "generate_images_per_s"
SPANS = ("ops.affine_mask_relu.fwd",)


def read(obs):
    s = spans.of_run(obs, "generate")
    if s is None:
        return None
    spent = s.busy_s(SPANS)
    if spent <= 0:
        return None
    a = obs["affine"]
    return (100.0 * obs["traced_requests"]
            * affine_bound_s(a["B"], a["ngf"], a["elem"]) / spent)
