"""Forensic repair of CRLF-mangled binary fixtures.

Several binary fixtures in the reference tree were passed through a
line-ending normalizer at some point in their history: every ``\\r\\n``
pair became ``\\n`` (one byte DELETED) and every lone ``\\r`` became
``\\n`` (one byte FLIPPED).  Evidence: the files contain zero 0x0D bytes
(statistically impossible for ~0.5 MB of IEEE-754 data, expected ~2048),
and RAW mixture fixtures such as
``LIA_SpkDet/ComputeTest/test/wld`` are exactly 3 bytes shorter than the
size implied by their own ``[K:u32][D:u32]`` header
(549893 vs 8 + 8K + K*(17+16D) = 549896 for K=1024, D=32).

Deletions destroy the 8-byte alignment of every double downstream, so a
naive read yields garbage.  They are, however, recoverable: each deleted
byte was a ``0x0D`` sitting immediately before a ``0x0A`` that survived,
so the repair search space is "insert 0x0D before one of the existing
0x0A bytes".  The RAW mixture format
(``lia_ral/io/gmm_io.py``) gives strong alignment checkpoints — every
distrib record carries a flag byte that must be 0 or 1 plus positive
finite cst/det doubles — which localize each deletion to within a record
and make false re-insertions detectable over a lookahead window.

Flipped bytes (any current 0x0A that was originally 0x0D) cannot be
recovered: the repair leaves them in place and ``gmm_flip_report``
quantifies the residual damage via the cst/det ↔ covInv redundancy of the
format.  Golden-output comparisons therefore carry measured, documented
tolerances (see PARITY.md) instead of exact equality.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

_F8 = struct.Struct("<d")


def _sane_double(buf: bytes | bytearray, off: int, lo: float = 0.0,
                 hi: float = 1e30, allow_neg: bool = True) -> bool:
    if off + 8 > len(buf):
        return True  # can't judge past EOF mid-repair
    (v,) = _F8.unpack_from(buf, off)
    if v != v:  # NaN
        return False
    a = abs(v)
    if a > hi:
        return False
    if not allow_neg and v < -1e-12:
        return False
    if lo > 0.0 and a != 0.0 and a < lo:
        return False
    return True


@dataclass
class GmmLayout:
    """Byte layout of an ALIZE RAW mixture (gmm_io.py write_gmm_file)."""
    k: int
    d: int

    @property
    def weights_off(self) -> int:
        return 8

    @property
    def rec_size(self) -> int:
        return 17 + 16 * self.d

    def rec_off(self, i: int) -> int:
        return 8 + 8 * self.k + i * self.rec_size

    @property
    def total(self) -> int:
        return self.rec_off(self.k)


def _rec_aligned(buf: bytes | bytearray, lay: GmmLayout, i: int) -> bool:
    """Alignment checkpoint for record i: flag byte in {0,1} and positive
    finite cst/det.  Under misalignment the flag position holds a random
    byte, so P(false positive) per record is tiny; a lookahead window of
    several records makes it negligible."""
    off = lay.rec_off(i)
    if off + 17 > len(buf):
        return True
    if buf[off + 16] not in (0, 1):
        return False
    if not _sane_double(buf, off, lo=0.0, hi=1e30, allow_neg=False):
        return False  # cst
    if not _sane_double(buf, off + 8, lo=0.0, hi=1e300, allow_neg=False):
        return False  # det
    return True


def _rec_misaligned_at(buf: bytes | bytearray, lay: GmmLayout,
                       i: int) -> bool:
    """True misalignment at record i: it fails its checkpoint and so do at
    least 2 of the 3 following records.  A single isolated failure is a
    0x0D→0x0A byte flip inside cst/det (alignment intact); a deletion
    breaks every record downstream."""
    if _rec_aligned(buf, lay, i):
        return False
    fails = 1
    for j in range(i + 1, min(i + 4, lay.k)):
        fails += not _rec_aligned(buf, lay, j)
    return fails >= 3 or i >= lay.k - 2


def _weights_aligned(buf: bytes | bytearray, lay: GmmLayout, j: int,
                     window: int = 16, need: float = 0.75) -> bool:
    """Weight j and successors are plausible mixture weights in [0, 1.01]."""
    hits = total = 0
    for t in range(j, min(j + window, lay.k)):
        off = lay.weights_off + 8 * t
        total += 1
        (v,) = _F8.unpack_from(buf, off)
        hits += (v == v) and 0.0 <= v <= 1.01
    if total == 0:
        return True
    return hits / total >= need


def _local_value_sanity(buf: bytearray, lay: GmmLayout, p: int,
                        span: int = 3) -> int:
    """Count plausible model values in the records around byte p: covInv
    finite-positive below 1e9, |mean| below 1e6, weights in [0,1]."""
    first = 8 + 8 * lay.k
    if p < first:
        j0 = max(0, (p - 8) // 8 - 4)
        w = np.frombuffer(bytes(buf[8 + 8 * j0:8 + 8 * min(lay.k, j0 + 12)]),
                          "<f8")
        return int(np.sum((w == w) & (w >= 0) & (w <= 1.01)))
    i0 = max(0, (p - first) // lay.rec_size - 1)
    score = 0
    for i in range(i0, min(i0 + span, lay.k)):
        off = lay.rec_off(i)
        if off + lay.rec_size > len(buf):
            break
        vals = np.frombuffer(bytes(buf[off + 17:off + 17 + 16 * lay.d]),
                             "<f8")
        ci, mu = vals[:lay.d], vals[lay.d:]
        with np.errstate(all="ignore"):
            score += int(np.sum(np.isfinite(ci) & (ci > 0) & (ci < 1e9)))
            score += int(np.sum(np.isfinite(mu) & (np.abs(mu) < 1e6)))
    return score


def _first_misalignment(buf: bytearray, lay: GmmLayout) -> int | None:
    """Byte offset of the region where alignment first breaks, or None."""
    for j in range(lay.k):
        if not _weights_aligned(buf, lay, j):
            return lay.weights_off + 8 * j
    for i in range(lay.k):
        if _rec_misaligned_at(buf, lay, i):
            return lay.rec_off(i)
    return None


def repair_gmm_raw(raw: bytes, max_deletions: int = 16) -> bytes:
    """Restore the deleted 0x0D bytes of a CRLF-mangled RAW mixture file.

    Returns a buffer of the exact size implied by the header.  Raises
    ValueError if the file cannot be brought back into alignment (more
    deletions than ``max_deletions``, or a deletion not adjacent to a
    surviving 0x0A, which the CRLF→LF hypothesis excludes).
    """
    k, d = struct.unpack_from("<2I", raw, 0)
    lay = GmmLayout(k, d)
    missing = lay.total - len(raw)
    if missing == 0:
        return raw
    if missing < 0 or missing > max_deletions:
        raise ValueError(f"cannot repair: {missing} bytes missing")
    buf = bytearray(raw)
    for _ in range(missing):
        bad = _first_misalignment(buf, lay)
        if bad is None:
            # All checkpoints pass but the file is short: the deletion is
            # in the tail (last record past the last checkpoint window).
            bad = len(buf)
        # The deleted 0x0D preceded a surviving 0x0A at or before the
        # first bad offset.  Scan candidates backwards from just past the
        # bad region; keep the insertion that pushes the next misalignment
        # furthest downstream (deletions can sit close together, so a
        # fixed lookahead margin would reject the true fix).
        lo = max(8, bad - 8 * lay.rec_size)
        hi = min(len(buf), bad + 2 * lay.rec_size)
        candidates = [p for p in range(hi - 1, lo - 1, -1) if buf[p] == 0x0A]
        # Rank alignment-restoring candidates by how many doubles in the
        # surrounding records look like real model values: inserting at the
        # wrong 0x0A leaves the byte span between the true deletion point
        # and the chosen one shifted, which shows up as wild exponents.
        best = None
        best_key = (bad, -1)
        for p in candidates:
            trial = bytearray(buf)
            trial.insert(p, 0x0D)
            nxt = _first_misalignment(trial, lay)
            progress = lay.total + 1 if nxt is None else nxt
            if progress <= bad:
                continue
            sane = _local_value_sanity(trial, lay, p)
            key = (progress, sane)
            if key > best_key:
                best, best_key = trial, key
        if best is None:
            raise ValueError(
                f"no valid 0x0D re-insertion found near offset {bad}")
        buf = best
    if len(buf) != lay.total:
        raise ValueError("repair did not converge to the expected size")
    final = _first_misalignment(buf, lay)
    if final is not None:
        raise ValueError(f"repaired buffer still misaligned at {final}")
    return bytes(buf)


def read_gmm_file_repaired(path: str):
    """read_gmm_file with transparent CRLF-deletion repair."""
    from .gmm_io import _read_gmm_raw

    with open(path, "rb") as f:
        raw = f.read()
    return _read_gmm_raw(repair_gmm_raw(raw))


@dataclass
class FlipReport:
    """Residual (unrecoverable) 0x0D→0x0A byte-flip damage estimate."""
    n_components: int = 0
    n_cst_inconsistent: int = 0   # records where stored cst ≠ f(covInv)
    n_det_inconsistent: int = 0
    n_suspect_lf_bytes: int = 0   # 0x0A bytes anywhere in the payload
    suspect_components: list = field(default_factory=list)

    @property
    def frac_clean(self) -> float:
        if self.n_components == 0:
            return 1.0
        bad = len(self.suspect_components)
        return 1.0 - bad / self.n_components


def gmm_flip_report(raw: bytes, rel_tol: float = 1e-10) -> FlipReport:
    """Quantify flip corruption using the format's redundancy: each record
    stores cst and det which are pure functions of covInv
    (``gmm_io.gmm_cst_det``).  A mismatch implies at least one flipped
    byte in that record's cst, det, or covInv fields."""
    from .gmm_io import gmm_cst_det

    k, d = struct.unpack_from("<2I", raw, 0)
    lay = GmmLayout(k, d)
    if len(raw) != lay.total:
        raise ValueError("run repair_gmm_raw first")
    rep = FlipReport(n_components=k,
                     n_suspect_lf_bytes=raw.count(b"\x0a"))
    for i in range(k):
        off = lay.rec_off(i)
        cst, det = struct.unpack_from("<2d", raw, off)
        cov_inv = np.frombuffer(raw, "<f8", count=d, offset=off + 17)
        with np.errstate(all="ignore"):
            ok = np.isfinite(cov_inv).all() and (cov_inv > 0).all()
            if ok:
                cst_ref, det_ref = gmm_cst_det(cov_inv)
                cst_ok = abs(cst - cst_ref) <= rel_tol * max(abs(cst_ref),
                                                             1e-300)
                det_ok = abs(det - det_ref) <= rel_tol * max(abs(det_ref),
                                                             1e-300)
            else:
                cst_ok = det_ok = False
        if not cst_ok:
            rep.n_cst_inconsistent += 1
        if not det_ok:
            rep.n_det_inconsistent += 1
        if not (cst_ok and det_ok):
            rep.suspect_components.append(i)
    return rep
