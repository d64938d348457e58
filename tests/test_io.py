import os

import numpy as np
import pytest

from lia_ral.io import (
    FeatureServer, Segment, apply_mask, frame_mask_to_segments, parse_mask,
    read_feature_file, read_gmm_file, read_label_file, read_matrix_file,
    read_ndx, read_xlist, segments_to_frame_mask, write_feature_file,
    write_gmm_file, write_label_file, write_matrix_file,
)
from lia_ral.io.features import spro_total_dim
from lia_ral.io.nist import ScoreLine, read_nist_scores, write_nist_scores
from tests.conftest import REFERENCE, requires_reference

REF_PRM = os.path.join(REFERENCE, "LIA_SpkDet/TrainWorld/test/test1.prm")


# -- features ----------------------------------------------------------------

def test_spro_total_dim():
    assert spro_total_dim(16, 0x09) == 34     # E|D → (16+1)*2
    assert spro_total_dim(19, 0) == 19
    assert spro_total_dim(12, 0x01) == 13     # E
    assert spro_total_dim(12, 0x19) == 39     # E|D|A


@requires_reference
def test_read_reference_prm():
    ff = read_feature_file(REF_PRM, fmt="SPRO3")
    assert ff.data.shape == (50, 34)
    assert ff.kind == "FBCEPSTRA"
    # declared SPRO4 in TrainWorld.cfg but really SPRO3 — fallback must cope
    ff2 = read_feature_file(REF_PRM, fmt="SPRO4")
    assert ff2.data.shape == (50, 34)
    # energy column 16 should look like log-energy (monotonic-ish large vals)
    masked = apply_mask(ff.data, "0-15,17-32")
    assert masked.shape == (50, 32)


def test_feature_roundtrip(tmp_path, rng):
    data = rng.standard_normal((40, 19)).astype(np.float32)
    for fmt in ("SPRO3", "SPRO4", "RAW"):
        p = str(tmp_path / f"x_{fmt}.prm")
        write_feature_file(p, data, fmt=fmt)
        ff = read_feature_file(p, fmt=fmt, vect_size=19)
        np.testing.assert_array_equal(ff.data, data)


def test_parse_mask():
    assert parse_mask("0-3,5") == [0, 1, 2, 3, 5]
    assert parse_mask("16") == [16]


def test_feature_server(tmp_path, rng):
    a = rng.standard_normal((10, 4)).astype(np.float32)
    b = rng.standard_normal((7, 4)).astype(np.float32)
    pa, pb = str(tmp_path / "a.prm"), str(tmp_path / "b.prm")
    write_feature_file(pa, a, fmt="SPRO4")
    write_feature_file(pb, b, fmt="SPRO4")
    fs = FeatureServer([pa, pb], fmt="SPRO4")
    assert fs.nframes == 17
    assert fs.source_range(1) == (10, 17)
    np.testing.assert_array_equal(fs.source_frames(1), b)


# -- labels ------------------------------------------------------------------

def test_label_roundtrip(tmp_path):
    segs = [Segment(0.21, 0.26, "speech"), Segment(1.0, 2.5, "speech")]
    p = str(tmp_path / "x.lbl")
    write_label_file(p, segs)
    back = read_label_file(p)
    assert len(back) == 2
    assert back[0].label == "speech"
    assert abs(back[1].end - 2.5) < 1e-9


def test_mask_roundtrip():
    # end-inclusive label convention (SegTools.cpp:208-209, see PARITY.md):
    # 0.02-0.05 → frames 2..5 (4), 0.10-0.12 → frames 10..12 (3)
    segs = [Segment(0.02, 0.05, "s"), Segment(0.10, 0.12, "s")]
    mask = segments_to_frame_mask(segs, 20, 0.01)
    assert mask.sum() == 7
    back = frame_mask_to_segments(mask, 0.01, "s")
    assert len(back) == 2
    assert abs(back[0].begin - 0.02) < 1e-9
    # label round-trip: mask→segments→mask is the identity
    mask2 = segments_to_frame_mask(back, 20, 0.01)
    assert (mask == mask2).all()


@requires_reference
def test_read_reference_lbl():
    segs = read_label_file(os.path.join(
        REFERENCE, "LIA_SpkDet/EnergyDetector/test/test1.validate.enr.lbl"))
    assert segs == [Segment(0.21, 0.26, "speech")]


# -- gmm ---------------------------------------------------------------------

def test_gmm_roundtrip(tmp_path, rng):
    k, d = 8, 5
    w = rng.random(k); w /= w.sum()
    m = rng.standard_normal((k, d))
    ci = rng.random((k, d)) + 0.5
    for fmt in ("RAW", "XML"):
        p = str(tmp_path / f"m.{fmt}.gmm")
        write_gmm_file(p, w, m, ci, fmt=fmt)
        w2, m2, ci2 = read_gmm_file(p)
        np.testing.assert_allclose(w2, w, rtol=1e-12)
        np.testing.assert_allclose(m2, m, rtol=1e-12)
        np.testing.assert_allclose(ci2, ci, rtol=1e-12)


@requires_reference
def test_read_reference_xml_gmm():
    w, m, ci = read_gmm_file(os.path.join(
        REFERENCE, "LIA_SpkDet/TrainWorld/test/wld.validate"))
    assert w.shape == (10,) and m.shape == (10, 32)
    np.testing.assert_allclose(w.sum(), 1.0, atol=1e-6)
    assert (ci > 0).all()


@requires_reference
def test_read_reference_raw_gmm():
    # TrainTarget/test/wld is an uncorrupted RAW fixture
    w, m, ci = read_gmm_file(os.path.join(
        REFERENCE, "LIA_SpkDet/TrainTarget/test/wld"))
    assert w.shape == (128,) and m.shape == (128, 32)
    np.testing.assert_allclose(w.sum(), 1.0, atol=1e-5)
    assert (ci > 0).all()
    assert np.abs(m).max() < 100


# -- matrix ------------------------------------------------------------------

def test_matrix_roundtrip(tmp_path, rng):
    mat = rng.standard_normal((6, 9))
    for fmt in ("DB", "DT"):
        p = str(tmp_path / f"m.{fmt}.matx")
        write_matrix_file(p, mat, fmt=fmt)
        back = read_matrix_file(p)
        np.testing.assert_allclose(back, mat, rtol=1e-12)


@requires_reference
def test_read_reference_dt_matrix():
    mat = read_matrix_file(os.path.join(
        REFERENCE, "LIA_SpkDet/ComputeTest/test/zero.mat"))
    assert mat.shape == (32768, 5)
    assert (mat == 0).all()


# -- lists / nist ------------------------------------------------------------

@requires_reference
def test_read_reference_ndx():
    ndx = read_ndx(os.path.join(REFERENCE, "LIA_SpkDet/ComputeTest/test/ndx"))
    assert ndx[0] == ("test3", ["test1", "test2"])


def test_nist_roundtrip(tmp_path):
    lines = [ScoreLine("M", "spk1", "1", "seg1", 2.5),
             ScoreLine("F", "spk2", "0", "seg2", -1.25, begin=0.0, end=0.26)]
    p = str(tmp_path / "s.nist")
    write_nist_scores(p, lines)
    back = read_nist_scores(p)
    assert back[0].score == 2.5
    assert back[1].begin == 0.0 and back[1].end == 0.26


@requires_reference
def test_read_reference_scores():
    res = read_nist_scores(os.path.join(
        REFERENCE, "LIA_SpkDet/ComputeTest/test/test1.validate.res"))
    assert res[0].model == "test1" and res[0].seg == "test3"
    assert abs(res[0].score - 5.06601) < 1e-5
    nist = read_nist_scores(os.path.join(
        REFERENCE, "LIA_Utils/Scoring/test/score.nist"))
    assert nist[0].gender == "F" and nist[0].decision == "-"


def test_reference_result_line_formats():
    from lia_ral.io.nist import (format_etf_line, format_liaral_line,
                                     format_mdtm_line, format_nist04_line)
    assert format_liaral_line("F", "c1", "A", "t1", "0", "20", -0.02) == \
        "F c1 A t1 0 20 -0.02"
    assert format_nist04_line("1side", "n", "1side", "m", "c", "s", "t",
                              1.5) == "1side n 1side m c s t 1.5"
    assert format_etf_line("f", "1", "0.0", 2.5, "spk", "sub", "ev", 0.25,
                           "true") == "f 1 0.0 2.5 spk sub ev 0.25 true"
    assert format_mdtm_line("f", "1", "0.0", 2.5, "speaker", 0.9, "S0") == \
        "f 1 0.0 2.5 speaker 0.9 S0"


def test_svmlight_vector_roundtrip(tmp_path):
    import numpy as np
    from lia_ral.io.nist import (read_svmlight_vector,
                                     write_svmlight_vector)
    v = np.array([0.5, -1.25, 3.0])
    p = str(tmp_path / "vec.svml")
    write_svmlight_vector(p, v, label=1)
    lab, back = read_svmlight_vector(p)
    assert lab == 1
    np.testing.assert_allclose(back, v)


def test_fileinfo_binary_roundtrip(tmp_path):
    import numpy as np
    from lia_ral.fa.topgauss import read_fileinfo, write_fileinfo
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 512, size=(7, 10))
    lk = rng.standard_normal(7)
    w = rng.random(7)
    p = str(tmp_path / "side.info")
    write_fileinfo(p, idx, lk, w)
    # record layout parity: top*u8 + 2*f8 per frame (FileInfo.cpp:155-187)
    assert (tmp_path / "side.info").stat().st_size == 7 * (10 * 8 + 16)
    i3, lk3, w3 = read_fileinfo(p, top=10, frame=3)
    np.testing.assert_array_equal(i3, idx[3])
    assert lk3 == lk[3] and w3 == w[3]
    all_i, all_lk, all_w = read_fileinfo(p, top=10)
    np.testing.assert_array_equal(all_i, idx)
    np.testing.assert_allclose(all_lk, lk)
    np.testing.assert_allclose(all_w, w)


def test_topgauss_reference_binary_roundtrip(tmp_path):
    import numpy as np
    from lia_ral.fa.topgauss import TopGauss
    rng = np.random.default_rng(1)
    tg = TopGauss(
        indices=rng.integers(0, 64, size=(5, 3)).astype(np.int32),
        top_lse=np.zeros(5),
        residual_log=np.log(rng.random(5) + 1e-3),
        residual_weight=rng.random(5))
    p = str(tmp_path / "file.ngauss")
    tg.save_reference(p)
    back = TopGauss.load_reference(p)
    np.testing.assert_array_equal(back.indices, tg.indices)
    np.testing.assert_allclose(back.residual_log, tg.residual_log)
    np.testing.assert_allclose(back.residual_weight, tg.residual_weight)
