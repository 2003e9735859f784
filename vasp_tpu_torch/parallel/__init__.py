"""Multi-device execution on torch.distributed: one process per rank.

Counterpart of vasp_tpu.parallel: ``bootstrap`` (the process group and the
rank's device), ``comm`` (the exchanges of vasp_tpu's shard_map programs,
built on all-reduce alone), ``shard`` (make_sharded_step: replicated state,
sharded element blocks), ``banded_shard`` (ShardedBandedStepper: the
dof-sharded Newton-Krylov path with the sharded banded preconditioner:
chain, Thomas or SPIKE) and ``steps`` (the timestep-sharded postprocessing
passes).
"""
