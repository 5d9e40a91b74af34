"""Device meshes and what runs over them (counterpart of
codec_tpu/parallel): mesh.py (make_mesh, make_mesh_2d, row_slices,
shard_batch, place, replicate) and pipeline.py (the GPipe backbone forward)."""

from .mesh import (Mesh, make_mesh, make_mesh_2d, place,  # noqa: F401
                   replicate, row_slices, shard_batch)
