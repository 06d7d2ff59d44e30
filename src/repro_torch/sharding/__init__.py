"""Sharding rules of the port (port of ``repro.sharding``), as data and
pure functions: the parameter and activation spec tables (``specs``), the
serve-state and batch specs (``serve_specs``) and the rules context
(``api``).  A spec is the port's :class:`~repro_torch.sharding.api.
PartitionSpec`, a mesh anything with ``.shape`` (axis -> size) and
``.axis_names`` (``repro_torch.launch.mesh``).  The serve engine applies
the serve-state specs' data axes on a mesh laid over one device
(``api.ShardLayout``, ``api.shard_map_compat``); ``shard``, the
activation hook, is not ported: no model code calls it."""
