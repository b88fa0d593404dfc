"""Tensor-parallel sharding rules and the compressed reduce.

Counterpart of ``repro/dist``: ``sharding`` holds the tensor-parallel role
rules (which weights split their output axis, which their input axis, how
the per-KV-head thresholds and the KV cache follow their heads) as
functions that slice trees of tensors or numpy arrays; ``collectives``
holds ``compressed_psum``, the reduce of the row-parallel int32
accumulators.  The reference's production-mesh rules (``ShardingRules``,
``param_specs``, ``to_shardings``, ``constraints.py``, ``compat.py``) place
arrays for XLA's GSPMD and have no counterpart here (ROADMAP item 18).
"""
