"""The k-mer index: host build and load (``build.py``, ``kmer_gen.py``)
and its device-resident view (``device_index.py``)."""

from .kmer_gen import GraphKmer, generate_kmers, generate_pos_on_ref  # noqa: F401
from .build import Index  # noqa: F401
