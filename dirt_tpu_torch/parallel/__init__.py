"""Multi-rank parallelism over torch.distributed: batch sharding and face
sharding (PyTorch port of dirt_tpu/parallel/).  `launch.run_ranks` starts
the ranks; `dryrun.dryrun_multichip` drives every sharded path once."""

from . import face_sharding, sharding

__all__ = ["face_sharding", "sharding"]
