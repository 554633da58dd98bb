"""Data, tensor and sequence parallelism over a world of ranks (counterpart
of ``qasr/parallel``): the mesh, the sharding rules, the collectives, the
sharded train, eval and beam steps, the halo conv and the chunked-alpha
CTC."""

from qasr_torch.parallel.collectives import aggregate_per, allsum_across_hosts
from qasr_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    initialize_multihost,
    make_mesh,
    replicated,
)
from qasr_torch.parallel.seq_parallel import ctc_loss_seq_parallel, qconv2d_seq_parallel
from qasr_torch.parallel.sharding import (
    batch_shardings,
    param_shardings,
    param_spec,
    shard_batch,
    state_shardings,
    tree_shardings,
)
from qasr_torch.parallel.train import (
    create_sharded_train_state,
    host_rows,
    make_sharded_beam_decode_step,
    make_sharded_eval_step,
    make_sharded_train_step,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "initialize_multihost",
    "batch_sharding",
    "replicated",
    "param_spec",
    "param_shardings",
    "state_shardings",
    "tree_shardings",
    "batch_shardings",
    "shard_batch",
    "create_sharded_train_state",
    "host_rows",
    "make_sharded_train_step",
    "make_sharded_eval_step",
    "make_sharded_beam_decode_step",
    "aggregate_per",
    "allsum_across_hosts",
    "ctc_loss_seq_parallel",
    "qconv2d_seq_parallel",
]
