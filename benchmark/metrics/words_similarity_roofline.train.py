"""words_similarity_roofline.train: the least time of the words
similarity's forward and regions' gradient that the traced steps' inputs
need (as ``damsm_words_roofline.train`` counts it), over the device-busy
time of the work launched under the op entry's spans
(``eegan.ops.words_similarity.fwd``, ``.bwd_dr``: the operands' checks and
copies and whatever kernels do the work), in per cent. Nothing when the
program has no such span or it launched nothing."""

from benchmark import spans
from benchmark.counts import words_bound_s

LAYER = "kernels 3-4, ops/damsm.py"
UNIT = "%"
MOVES = "train_images_per_s"
SPANS = ("ops.words_similarity.fwd", "ops.words_similarity.bwd_dr")


def read(obs):
    s = spans.of_run(obs, "train")
    if s is None:
        return None
    spent = s.busy_s(SPANS)
    if spent <= 0:
        return None
    return 100.0 * sum(words_bound_s(**d) for d in obs["damsm"]) / spent
