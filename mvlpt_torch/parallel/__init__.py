from mvlpt_torch.parallel.mesh import (
    Mesh,
    copy_to_model,
    create_mesh,
    data_gather,
    local_batch,
    over_data_rows,
    reduce_from_model,
    shard_backbone,
    shard_blocks,
)
from mvlpt_torch.parallel.multihost import (
    allgather_tree,
    barrier,
    choose_backend,
    is_writer,
    local_batch_slice,
    maybe_initialize_distributed,
    rank_device,
    world,
)
