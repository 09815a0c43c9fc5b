"""Replicated serving data plane: FleetRouter over N ServingEngines (the
port of ``repro.fleet``)."""
from repro_torch.fleet.affinity import (DEFAULT_BLOCK, PrefixAffinityIndex,
                                        prefix_fingerprints)
from repro_torch.fleet.router import (POLICIES, FleetHandle, FleetRequest,
                                      FleetRouter, ReplicaRef)

__all__ = [
    "DEFAULT_BLOCK",
    "FleetHandle",
    "FleetRequest",
    "FleetRouter",
    "POLICIES",
    "PrefixAffinityIndex",
    "ReplicaRef",
    "prefix_fingerprints",
]
