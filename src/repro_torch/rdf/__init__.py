"""RDF substrate: parsing, dictionary encoding, the TripleTensor main dataset,
and synthetic data generation (BSBM-style, as in the paper's evaluation)."""
from .parser import (Term, escape_literal, parse_lines, parse_ntriples,
                     parse_term, unescape_literal)
from .encoder import (TermDictionary, content_hash_batch, content_hash_keys,
                      encode, encode_ntriples)
from .ingest import parse_encode, stream_chunks, stream_chunks_text
from .triple_tensor import (
    TripleTensor, from_columns, empty, synthetic_term_hash,
    COL_S, COL_P, COL_O, COL_S_FLAGS, COL_P_FLAGS, COL_O_FLAGS,
    COL_S_LEN, COL_P_LEN, COL_O_LEN, COL_O_DT,
    COL_S_HASH, COL_P_HASH, COL_O_HASH, N_PLANES, PLANE_NAMES,
    PLANE_LAYOUT_VERSION)
from .generator import DirtProfile, bsbm_ntriples, synth_encoded
from . import vocab

__all__ = [
    "Term", "parse_lines", "parse_ntriples", "parse_term",
    "escape_literal", "unescape_literal",
    "TermDictionary", "encode", "encode_ntriples",
    "content_hash_batch", "content_hash_keys",
    "parse_encode", "stream_chunks", "stream_chunks_text",
    "TripleTensor", "from_columns", "empty", "synthetic_term_hash", "vocab",
    "DirtProfile", "bsbm_ntriples", "synth_encoded",
    "COL_S", "COL_P", "COL_O", "COL_S_FLAGS", "COL_P_FLAGS", "COL_O_FLAGS",
    "COL_S_LEN", "COL_P_LEN", "COL_O_LEN", "COL_O_DT",
    "COL_S_HASH", "COL_P_HASH", "COL_O_HASH", "N_PLANES", "PLANE_NAMES",
    "PLANE_LAYOUT_VERSION",
]
