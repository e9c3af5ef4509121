from mvlpt_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    local_batch,
    shard_backbone,
    shard_blocks,
)
