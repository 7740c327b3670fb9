"""Data parallelism: one process per GPU with the JAX package's global-batch
math (``mesh.py``), and the process-group set-up (``distributed.py``)."""

from eegan_tpu_torch.parallel.mesh import Mesh, data_axis_size, parse_mesh_spec

__all__ = ["Mesh", "data_axis_size", "parse_mesh_spec"]
