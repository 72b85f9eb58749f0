"""Scaling within one process (PyTorch port of the JAX package's
``parallel/``): time sharding with halo exchange (:mod:`.time_shard`),
channel sharding of channelizer chains (:mod:`.channel_shard`) and a
stage per device, pipelined (:mod:`.pipeline`), over the device mesh of
:mod:`.mesh`, whose entries may repeat one card.  The data-parallel
serving axis (independent streams) lives in
``blocks.base.jit_step_sharded`` / ``RuntimeBlock(mesh=...)``."""
