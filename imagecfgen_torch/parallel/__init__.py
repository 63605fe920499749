"""Data and spatial parallelism over ``torch.distributed`` (port of
``imagecfgen_tpu/parallel``)."""
from .mesh import DataMesh, data_mesh, init_from_env

__all__ = ["DataMesh", "data_mesh", "init_from_env"]
