from gymothelloenv_tpu_torch.parallel.multihost import (  # noqa: F401
    assemble_global,
    host_batch_slice,
    initialize,
    make_pod_mesh,
)
from gymothelloenv_tpu_torch.parallel.sharding import (  # noqa: F401
    DataMesh,
    all_reduce_grads,
    all_reduce_mean,
    all_reduce_sum,
    assert_tree_allclose,
    make_mesh,
    place_replicated,
    replicated,
    shard_batch_axes,
    shard_batch_tree,
)
