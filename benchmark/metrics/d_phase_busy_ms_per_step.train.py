"""d_phase_busy_ms_per_step.train: milliseconds per train step in which
the card runs work launched under the D phase's spans
(``eegan.train.d_hinge.<scale>``, ``eegan.train.d_magp.<scale>``: the
hinge and the MAGP at every scale with their backward, not their Adam
updates), over the traced call (``benchmark/spans.py``). Nothing when the
program has no such span."""

from benchmark import spans

LAYER = "train step, training/steps.py"
UNIT = "ms"
MOVES = "train_images_per_s"
SPANS = ("train.d_hinge", "train.d_magp")


def read(obs):
    s = spans.of_run(obs, "train")
    if s is None or not s.has(SPANS):
        return None
    return 1e3 * s.busy_s(SPANS) / obs["traced_steps"]
