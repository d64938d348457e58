"""File I/O layer: feature/label/mixture/matrix/list/score formats.

Provides JAX-idiomatic equivalents of the ALIZE file surface the reference
depends on (SURVEY.md §1.1): FeatureServer (SPRO3/SPRO4/RAW .prm),
LabelServer/SegServer (.lbl), MixtureServer (.gmm XML/RAW), Matrix (.matx),
XList/NDX lists, and NIST score files (reference IOFormat.h:93-120).
"""

from .features import (
    FeatureFile,
    read_feature_file,
    write_feature_file,
    parse_mask,
    apply_mask,
    FeatureServer,
)
from .labels import (
    Segment,
    read_label_file,
    write_label_file,
    segments_to_frame_mask,
    frame_mask_to_segments,
    SegmentStore,
)
from .gmm_io import read_gmm_file, write_gmm_file
from .matrix import read_matrix_file, write_matrix_file
from .lists import read_xlist, read_ndx, write_xlist
from .nist import ScoreLine, read_nist_scores, write_nist_scores

__all__ = [
    "FeatureFile", "read_feature_file", "write_feature_file", "parse_mask",
    "apply_mask", "FeatureServer",
    "Segment", "read_label_file", "write_label_file",
    "segments_to_frame_mask", "frame_mask_to_segments", "SegmentStore",
    "read_gmm_file", "write_gmm_file",
    "read_matrix_file", "write_matrix_file",
    "read_xlist", "read_ndx", "write_xlist",
    "ScoreLine", "read_nist_scores", "write_nist_scores",
]
