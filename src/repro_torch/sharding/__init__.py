"""Sharding: the logical-axis rules (`partitioning`) and the fleet serving
mesh (`fleet`)."""

from repro_torch.sharding.fleet import (FLEET_RULES, FleetMesh, client_shards,
                                        current_fleet_mesh, fleet_axis_rules,
                                        fleet_shardings, fleet_totals, mesh_signature,
                                        replicate_fleet, resolve_mesh,
                                        shard_participation, shard_resident_bytes,
                                        shard_service_state, shard_slab_tables,
                                        slab_shardings, use_fleet_mesh)
from repro_torch.sharding.partitioning import (LOGICAL_RULES, axes_for_dim,
                                               logical_to_pspec, to_placements)
