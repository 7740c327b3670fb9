"""damsm_words_roofline.train: the least time of the words similarity's
forward and regions' gradient that the traced steps' inputs need (valid
words only, no recomputation, each byte read once; float32 operations
over 67 TFLOP/s, bytes over 3.35 TB/s), over the device time of kernels
3-4 (damsm_words_fwd, damsm_dr_pair, damsm_dr_sum) in the trace, in per
cent. Nothing when those kernels did not run."""

from benchmark.counts import words_bound_s

LAYER = "kernels 3-4, ops/damsm.py"
UNIT = "%"
MOVES = "train_images_per_s"
KERNELS = ("damsm_words_fwd", "damsm_dr_pair", "damsm_dr_sum")


def read(obs):
    if obs.get("kind") != "train" or obs.get("trace") is None:
        return None
    spent = sum(obs["trace"].kernel_s(k) for k in KERNELS)
    if spent <= 0:
        return None
    return 100.0 * sum(words_bound_s(**d) for d in obs["damsm"]) / spent
