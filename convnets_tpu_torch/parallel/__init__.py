from convnets_tpu_torch.parallel.mesh import (  # noqa: F401
    Sharding,
    active_mesh,
    data_rank,
    data_sharding,
    data_size,
    init_distributed,
    make_mesh,
    mesh_scope,
    replicated,
    set_active_mesh,
    shard_batch,
)
