"""nccl_exposed_ms_per_step.train: of ``nccl_ms_per_step.train``, the
milliseconds per train step in which an NCCL kernel runs and no other
activity (kernel, copy or set) runs on any stream of the traced card:
the exchange between the cards that no computation hides. Nothing when
no NCCL kernel ran."""

from benchmark import spans

LAYER = "collectives, parallel/mesh.py"
UNIT = "ms"
MOVES = "train_images_per_s"


def read(obs):
    s = spans.of_run(obs, "train")
    if s is None:
        return None
    nccl = spans.nccl(s)
    if not nccl.any():
        return None
    alone = spans.union_s(s.acts[nccl]) - spans.overlap_s(s.acts[nccl],
                                                          s.acts[~nccl])
    return 1e3 * alone / obs["traced_steps"]
