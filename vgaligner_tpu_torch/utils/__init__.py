from .dna import reverse_complement, encode_seq, decode_seq  # noqa: F401
