"""Path -> node-position JSON mappings (debug artifact).

Behavioral reference: generate_json_mappings (rs-vgaligner src/io.rs:
174-255) + store_mappings_in_file (serialization.rs:57-63).  Output is
{path_name: {node_id: {start, end}}} over the forward strand, with the
reference's quirk preserved: nodes of each path are iterated in
*sorted-handle* order (not path order) when accumulating positions
(io.rs:213-222).
"""

from __future__ import annotations

import json

from ..graph.handlegraph import handle_id


def generate_json_mappings(graph) -> str:
    out = {}
    for pid in graph.paths_iter():
        path = graph.get_path(pid)
        nodes = sorted(path.nodes)  # sorted by packed handle (io.rs:214)
        start = 0
        pos_map = {}
        for h in nodes:
            end = start + len(graph.sequence(h))
            pos_map[str(handle_id(h))] = {"start": start, "end": end}
            start = end
        out[path.name] = pos_map
    return json.dumps(out)


def store_mappings_in_file(mappings: str, file_name: str) -> None:
    with open(file_name, "w") as fh:
        fh.write(mappings)
