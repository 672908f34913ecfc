from .handlegraph import (  # noqa: F401
    Handle,
    HashGraph,
    handle_flip,
    handle_id,
    handle_is_reverse,
    handle_pack,
)
from .gfa import parse_gfa, graph_from_gfa  # noqa: F401
from .linearize import find_forward_sequence, find_graph_seq_length  # noqa: F401
