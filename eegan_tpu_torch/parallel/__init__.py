"""Data parallelism and FSDP: one process per GPU with the JAX package's
global-batch math (``mesh.py``), the train state sharded over the fsdp axis
(``fsdp.py``), and the process-group set-up (``distributed.py``)."""

from eegan_tpu_torch.parallel.mesh import Mesh, mesh_shape, parse_mesh_spec

__all__ = ["Mesh", "mesh_shape", "parse_mesh_spec"]
