"""The benchmark of the PyTorch and CUDA port, ``eegan_tpu_torch``
(``python3 -m benchmark.run``; ``BENCHMARK.json`` at the repository's
root names its cells and metrics)."""
