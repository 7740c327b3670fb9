"""g_phase_busy_ms_per_step.train: milliseconds per train step in which
the card runs work launched under the G phase's spans
(``eegan.train.text``, ``.generator``, ``.g_loss``, ``.ema``: the text
encoder, the generator's forward, the G loss through the discriminators
and the image encoder with the DAMSM losses and its backward, the EMA),
over the traced call (``benchmark/spans.py``). Nothing when the program
has no such span."""

from benchmark import spans

LAYER = "train step, training/steps.py"
UNIT = "ms"
MOVES = "train_images_per_s"
SPANS = ("train.text", "train.generator", "train.g_loss", "train.ema")


def read(obs):
    s = spans.of_run(obs, "train")
    if s is None or not s.has(SPANS):
        return None
    return 1e3 * s.busy_s(SPANS) / obs["traced_steps"]
