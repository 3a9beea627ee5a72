from .aligner import Alignment, SubpathAligner
