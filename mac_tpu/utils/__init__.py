from mac_tpu.utils.graphs import (
    Edge,
    edges_to_arrays,
    arrays_to_edges,
    weight_graph_lap_from_edge_list,
    weight_reduced_graph_lap_from_edge_list,
    weight_graph_lap_from_edges,
    select_edges,
    get_incidence_vector,
    set_incidence_vector_for_edge_inplace,
    get_edge_selection_as_binary_mask,
)

# networkx is needed only by the conversion helpers, not by the solve path:
# import them on first use (PEP 562) so `import mac_tpu.solvers` works with
# numpy, scipy and JAX alone.
_LAZY = {"nx_to_mac", "mac_to_nx"}


def __getattr__(name):
    if name in _LAZY:
        from mac_tpu.utils import conversions

        return getattr(conversions, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "Edge",
    "edges_to_arrays",
    "arrays_to_edges",
    "weight_graph_lap_from_edge_list",
    "weight_reduced_graph_lap_from_edge_list",
    "weight_graph_lap_from_edges",
    "select_edges",
    "get_incidence_vector",
    "set_incidence_vector_for_edge_inplace",
    "get_edge_selection_as_binary_mask",
    "nx_to_mac",
    "mac_to_nx",
]
