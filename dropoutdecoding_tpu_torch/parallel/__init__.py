from .mesh import (
    make_mesh,
    shard_llava_params,
    shard_llavanext_params,
    shard_instructblip_params,
    shard_cache,
    mesh_of,
)
from .distributed import init_multihost, shard_work
