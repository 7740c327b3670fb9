"""sample_idle_ms_per_request.generate: milliseconds per traced request
with nothing on the card while the host is inside ``eegan.sample.step``
(the program's sampling call): every idle stretch of the traced requests
whose midpoint it covers (``benchmark/spans.py``). The rest of the idle
is the request loop's own (``drivers/generate.py``: drawing rows and
noise, the copy of the images to the host). Nothing when the program has no such span."""

from benchmark import spans

LAYER = "sample step, training/steps.py::make_sample_step"
UNIT = "ms"
MOVES = "generate_images_per_s"
SPANS = ("sample.step",)


def read(obs):
    s = spans.of_run(obs, "generate")
    if s is None or not s.has(SPANS):
        return None
    return 1e3 * s.idle_s(SPANS) / obs["traced_requests"]
