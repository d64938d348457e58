"""Label (.lbl) files, segments, and frame-mask materialisation.

Replaces the ALIZE SegServer/SegCluster/LabelServer surface used throughout
the reference (SURVEY.md §1.1; reference ``LIA_SpkTools/include/SegTools.h``).

The on-disk format is "begin end label" in seconds, one segment per line
(reference fixture ``LIA_SpkDet/EnergyDetector/test/test1.validate.enr.lbl``:
``0.21 0.26 speech``).  The device representation of a selection is a
boolean frame mask; every downstream kernel weights frames by mask so that
ragged segment structure never reaches device code as dynamic shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def time_to_frame_idx(time: float, frame_length: float) -> int:
    """Reference timeToFrameIdx (SegTools.cpp:135-142): floor(time/fl)
    with a 0.99999 fractional guard against FP boundary error."""
    q = time / frame_length
    frac = q - int(q)
    return int(q) + 1 if frac > 0.99999 else int(q)


def frame_idx_to_time(idx: int, frame_length: float) -> float:
    """Reference frameIdxToTime (SegTools.cpp:143-148): millisecond-
    truncated idx*frameLength."""
    return int(idx * 1000 * frame_length) / 1000.0


@dataclasses.dataclass
class Segment:
    begin: float          # seconds
    end: float            # seconds
    label: str

    def frames(self, frame_length: float) -> tuple[int, int]:
        """[start, stop) frame indices.  The reference's label convention
        is END-INCLUSIVE: segFrameLength = timeToFrameIdx(end) − begin + 1
        (SegTools.cpp:208-209), so a "0 0.25" label at 10 ms frames covers
        frames 0..25 (26 frames)."""
        start = time_to_frame_idx(self.begin, frame_length)
        stop = time_to_frame_idx(self.end, frame_length) + 1
        return start, stop


def read_label_file(path: str) -> list[Segment]:
    segs: list[Segment] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            label = parts[2] if len(parts) > 2 else ""
            segs.append(Segment(float(parts[0]), float(parts[1]), label))
    return segs


def write_label_file(path: str, segs: list[Segment]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for s in segs:
            f.write(f"{_fmt_time(s.begin)} {_fmt_time(s.end)} {s.label}\n")


def _fmt_time(t: float) -> str:
    txt = f"{t:.6f}".rstrip("0").rstrip(".")
    return txt if txt else "0"


def segments_to_frame_mask(
    segs: list[Segment],
    nframes: int,
    frame_length: float = 0.01,
    label: str | None = None,
) -> np.ndarray:
    """Materialise segments (optionally filtered by label) as a bool mask."""
    mask = np.zeros(nframes, dtype=bool)
    for s in segs:
        if label is not None and s.label != label:
            continue
        a, b = s.frames(frame_length)
        a = max(a, 0)
        b = min(b, nframes)
        if b > a:
            mask[a:b] = True
    return mask


def frame_mask_to_segments(
    mask: np.ndarray,
    frame_length: float = 0.01,
    label: str = "speech",
) -> list[Segment]:
    """Inverse of segments_to_frame_mask: contiguous True runs → segments."""
    mask = np.asarray(mask, dtype=bool)
    if mask.size == 0:
        return []
    diff = np.diff(mask.astype(np.int8))
    starts = list(np.nonzero(diff == 1)[0] + 1)
    stops = list(np.nonzero(diff == -1)[0] + 1)
    if mask[0]:
        starts.insert(0, 0)
    if mask[-1]:
        stops.append(mask.size)
    # end time = START time of the last covered frame (end-inclusive
    # convention; reference outputLabelFile writes
    # frameIdxToTime(begin+length-1), SegTools.cpp:115)
    return [
        Segment(frame_idx_to_time(a, frame_length),
                frame_idx_to_time(b - 1, frame_length), label)
        for a, b in zip(starts, stops)
    ]


class SegmentStore:
    """Label-indexed segment clusters over one feature stream.

    Equivalent of the reference ``initializeClusters`` result
    (SegTools.h:123-129): a dict label → list of Segments, with
    ``addDefaultLabel``/``defaultLabel`` semantics (unlabelled streams get
    one segment spanning all frames).
    """

    def __init__(self, frame_length: float = 0.01) -> None:
        self.frame_length = frame_length
        self.clusters: dict[str, list[Segment]] = {}

    @classmethod
    def from_label_file(
        cls,
        path: str | None,
        nframes: int,
        frame_length: float = 0.01,
        add_default_label: bool = False,
        default_label: str = "speech",
    ) -> "SegmentStore":
        st = cls(frame_length)
        segs: list[Segment] = []
        if path is not None:
            segs = read_label_file(path)
        if not segs and add_default_label:
            segs = [Segment(0.0, nframes * frame_length, default_label)]
        for s in segs:
            st.clusters.setdefault(s.label, []).append(s)
        return st

    def labels(self) -> list[str]:
        return list(self.clusters.keys())

    def mask(self, label: str, nframes: int) -> np.ndarray:
        return segments_to_frame_mask(
            self.clusters.get(label, []), nframes, self.frame_length)

    def total_frames(self, label: str, nframes: int) -> int:
        """Reference totalFrame (SegTools.h:78)."""
        return int(self.mask(label, nframes).sum())

    def add(self, seg: Segment) -> None:
        self.clusters.setdefault(seg.label, []).append(seg)
