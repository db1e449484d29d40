from gluon_e2e_asr.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch_arrays,
)
