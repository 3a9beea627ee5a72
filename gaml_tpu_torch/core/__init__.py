from .dna import (
    encode_seq,
    decode_seq,
    revcomp,
    revcomp_str,
    is_acgt,
    CODE_A,
    CODE_C,
    CODE_G,
    CODE_T,
    CODE_N,
)
from .graph import Graph, Node, convert_node_id, invert_node
from .paths import invert_path, reverse_path, path_len, total_len
