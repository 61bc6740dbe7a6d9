"""Multi-process scaling with torch.distributed: the (dp, sp) device mesh,
the halo exchange along a sharded grid axis, the sp-sharded normal operator
and a multi-process dry run.  Port of the JAX package's parallel/."""
