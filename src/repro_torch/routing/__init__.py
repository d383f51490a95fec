from .tables import (
    build_routing_table,
    dijkstra_lowest_id_table,
    dijkstra_lowest_id_table_reference,
    updown_random_table,
    updown_random_table_reference,
    route_walk,
    channel_dependency_cycle,
    ROUTING_ALGORITHMS,
)

__all__ = [
    "build_routing_table",
    "dijkstra_lowest_id_table",
    "dijkstra_lowest_id_table_reference",
    "updown_random_table",
    "updown_random_table_reference",
    "route_walk",
    "channel_dependency_cycle",
    "ROUTING_ALGORITHMS",
]
