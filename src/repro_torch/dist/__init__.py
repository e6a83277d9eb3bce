"""Distribution layer: sharding rules (param / optimizer / cache partition
specs), collectives and the tensor-parallel scope, and int8 compression
for gradient sync and bundle shipping.  Port of ``repro.dist`` onto
``torch.distributed`` (one process per device, SPMD)."""
