"""Decentralized-FL core: graphs, schedules, packing, rounds, engines, and
the two dynamic round axes -- ``dynamics`` (TopologyProgram: per-round
time-varying graphs) and ``heterogeneity`` (NodeProgram: per-node compute
rates and payload drops)."""

from repro_torch.core.dynamics import (
    EdgeFailureProgram,
    NodeChurnProgram,
    RGGRewireProgram,
    RoundRobinSubgraphsProgram,
    StaticProgram,
    TopologyProgram,
    get_program,
    parse_program,
    program_names,
    register_program,
    resolve_program,
    validate_program,
)
from repro_torch.core.heterogeneity import (
    HomogeneousProgram,
    NodeProgram,
    PayloadDropProgram,
    SlowNodesProgram,
    SlowUplinkProgram,
    StragglerProgram,
    compose_node_gate,
    get_node_program,
    node_program_names,
    parse_node_program,
    register_node_program,
    resolve_node_program,
)

__all__ = [
    "TopologyProgram",
    "StaticProgram",
    "EdgeFailureProgram",
    "NodeChurnProgram",
    "RoundRobinSubgraphsProgram",
    "RGGRewireProgram",
    "register_program",
    "get_program",
    "program_names",
    "parse_program",
    "resolve_program",
    "validate_program",
    "NodeProgram",
    "HomogeneousProgram",
    "StragglerProgram",
    "SlowNodesProgram",
    "SlowUplinkProgram",
    "PayloadDropProgram",
    "compose_node_gate",
    "register_node_program",
    "get_node_program",
    "node_program_names",
    "parse_node_program",
    "resolve_node_program",
]
