"""Device meshes and what runs over them (counterpart of
codec_tpu/parallel): mesh.py (make_mesh, make_mesh_2d, dp_share,
row_slices, shard_batch, place, replicate) and pipeline.py (the GPipe
backbone forward)."""

from .mesh import (Mesh, dp_share, make_mesh, make_mesh_2d,  # noqa: F401
                   place, replicate, row_slices, shard_batch)
