from .structural import break_path, local_change, local_change2, fix_self_loops, fix_multi_local, fix_rep
from .extend import extend_paths, extend_paths_alt, sample_path_by_length
from .advice import extend_paths_adv_paired, extend_paths_adv_pacbio
from .gaps import fix_gap_length, fix_random_gap_length
from .repeats import fix_big_reps, fix_some_big_reps, fix_rep_for_node2, fix_rep_for_node, split_on_node
