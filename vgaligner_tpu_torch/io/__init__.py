from .fastx import QuerySequence, read_seqs_from_file  # noqa: F401
from .gaf import GAFAlignment, write_gaf_to_file  # noqa: F401
