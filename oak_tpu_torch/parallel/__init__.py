"""Several devices (``oak_tpu.parallel``): data-parallel training steps,
data-sharded and restart-sharded L-BFGS and sharded prediction, on
``torch.distributed`` with one process per device (``sharding``)."""

from .sharding import (
    data_parallel_elbo_step,
    data_parallel_natgrad_step,
    fit_lbfgs_multistart_sharded,
    fit_lbfgs_sharded,
    make_mesh,
    replicate,
    shard_batch,
    sharded_predict_f,
)

__all__ = ["make_mesh", "shard_batch", "replicate", "data_parallel_elbo_step",
           "data_parallel_natgrad_step", "sharded_predict_f",
           "fit_lbfgs_sharded", "fit_lbfgs_multistart_sharded"]
