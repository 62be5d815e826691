"""The parallel layer: data-parallel training over the ranks of a
``torch.distributed`` process group (:mod:`.mesh`), block-wise prediction
of big images with the block forwards spread over devices
(:mod:`.bigpredict`) or over ranks (:mod:`.multihost`), a launcher of
ranks (:mod:`.launch`) and a dry run of the data-parallel training step
(:mod:`.dryrun`)."""
from .bigpredict import predict_instances_big_sharded
from .dryrun import dryrun_multichip
from .launch import run_ranks
from .mesh import data_parallel_slice, world
from .multihost import predict_instances_big_multihost

__all__ = ["data_parallel_slice", "dryrun_multichip", "predict_instances_big_multihost",
           "predict_instances_big_sharded", "run_ranks", "world"]
