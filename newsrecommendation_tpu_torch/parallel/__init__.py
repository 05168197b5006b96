from newsrecommendation_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from newsrecommendation_tpu_torch.parallel.sharded_embedding import (  # noqa: F401
    gather_rows_sharded,
    shard_table,
)
