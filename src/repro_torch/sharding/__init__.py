"""Sharding rules of the port (port of ``repro.sharding``), as data and
pure functions: the parameter and activation spec tables (``specs``), the
serve-state and batch specs (``serve_specs``) and the rules context
(``api``).  A spec is the port's :class:`~repro_torch.sharding.api.
PartitionSpec`, a mesh anything with ``.shape`` (axis -> size) and
``.axis_names``.  Applying them to tensors (``shard``, a device mesh, a
sharded engine) is not ported yet: no model code calls a sharding hook."""
