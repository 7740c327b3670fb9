"""nccl_ms_per_step.train: milliseconds per train step in which an NCCL
kernel (by its symbol, ``nccl...``: the mesh's all-reduces and
all-gathers, waiting for the other cards included) runs on the traced
card, over the traced call (``benchmark/spans.py``'s activities of the
Chrome trace). Nothing when no NCCL kernel ran."""

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
    return 1e3 * spans.union_s(s.acts[nccl]) / obs["traced_steps"]
