"""d_graph_share.train: per cent of the D phase's units that replayed a
CUDA graph in the traced call: 100 x the ``eegan.train.d_graph`` spans
over twice the ``eegan.train.d_hinge.<scale>`` and
``eegan.train.d_magp.<scale>`` spans (per scale four units, the hinge,
the MAGP and their two updates, each replayed inside a ``train.d_graph``
span; ``training/d_graph.py``): 0 where the D phase ran eagerly, as on
a mesh. Nothing when the program has no D phase span."""

from benchmark import spans

LAYER = "train step, training/steps.py"
UNIT = "%"
MOVES = "train_images_per_s"
GRAPH = "train.d_graph"
D_PHASE = ("train.d_hinge", "train.d_magp")


def read(obs):
    s = spans.of_run(obs, "train")
    if s is None or not s.has(D_PHASE):
        return None
    graphs = int(sum(n == GRAPH for n in s.names))
    return 100.0 * graphs / (2 * int(s.selected(D_PHASE).sum()))
