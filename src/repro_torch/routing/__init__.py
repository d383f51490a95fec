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
from .hierarchical import (
    band_clusters,
    grid_clusters,
    hierarchical_hops_dist,
    hops_next_hop_auto,
    hops_next_hop_hierarchical,
    use_clusters,
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
    "band_clusters",
    "grid_clusters",
    "hierarchical_hops_dist",
    "hops_next_hop_auto",
    "hops_next_hop_hierarchical",
    "use_clusters",
]
