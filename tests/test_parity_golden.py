"""Golden numeric parity against the reference's own checked-in outputs.

The reference tests by golden-file integration runs (SURVEY.md §4).  This
suite runs OUR tools on the reference's own fixtures and compares the
NUMBERS, not just structure.  Caveat, established forensically (see
PARITY.md and lia_ral/io/repair.py): every binary fixture in the
reference tree went through a CRLF line-ending normalizer at some point —
0x0D bytes deleted when followed by 0x0A, flipped to 0x0A otherwise.
``repair_gmm_raw`` recovers the deletions exactly (alignment checkpoints);
the flips are unrecoverable and bound the achievable tolerance.  Each test
below documents its measured deviation.
"""

import os
import shutil

import numpy as np
import pytest

from lia_ral.config import Config
from lia_ral.io.gmm_io import _read_gmm_raw, write_gmm_file
from lia_ral.io.nist import read_nist_scores
from lia_ral.io.repair import gmm_flip_report, repair_gmm_raw
from tests.conftest import REFERENCE, requires_reference

CT = os.path.join(REFERENCE, "LIA_SpkDet/ComputeTest/test")
TOK = os.path.join(REFERENCE, "LIA_Utils/GmmTokenizer/test")
SCOR = os.path.join(REFERENCE, "LIA_Utils/Scoring/test")
FUS = os.path.join(REFERENCE, "LIA_Utils/FusionScore/test")


# ---------------------------------------------------------------------------
# fixture repair
# ---------------------------------------------------------------------------

@requires_reference
def test_gmm_repair_fixture_models():
    """wld/test1 are 3 bytes short of their own header's implied size; the
    repair must restore alignment to fully-sane model values, leaving only
    byte-flip noise (measured: 149/1024 components with ≥1 flipped byte in
    their cst/det/covInv chain at 1e-10 relative)."""
    for name in ("wld", "test1"):
        with open(os.path.join(CT, name), "rb") as f:
            raw = f.read()
        assert len(raw) == 549893  # 3 bytes missing vs 549896
        fixed = repair_gmm_raw(raw)
        assert len(fixed) == 549896
        w, m, ci = _read_gmm_raw(fixed)
        assert abs(w.sum() - 1.0) < 1e-4
        assert np.abs(m).max() < 10 and np.isfinite(m).all()
        assert ci.min() > 0 and ci.max() < 1e4
        rep = gmm_flip_report(fixed)
        assert rep.frac_clean > 0.8  # flips touch <20% of components


def _repaired_compute_test_dir(tmp_path) -> str:
    d = str(tmp_path)
    for name in ("wld", "test1", "test2"):
        with open(os.path.join(CT, name), "rb") as f:
            w, m, ci = _read_gmm_raw(repair_gmm_raw(f.read()))
        write_gmm_file(os.path.join(d, name), w, m, ci, fmt="RAW")
    # the ndx scores feature files test3/test4 whose .prm/.lbl are not in
    # the tree; the golden's identical scores for both confirm they were
    # copies of test1.prm/test1.lbl
    for t in ("test3", "test4"):
        shutil.copy(os.path.join(CT, "test1.prm"), os.path.join(d, t + ".prm"))
        shutil.copy(os.path.join(CT, "test1.lbl"), os.path.join(d, t + ".lbl"))
    return d


@requires_reference
def test_compute_test_golden_llrs(tmp_path):
    """ComputeTest on the reference's own cfg + repaired fixture models vs
    test1.validate.res (exact reference LLRs).

    Measured deviations: self-consistency trials (test2 ≡ wld ⇒ LLR 0;
    golden −5.5e-16) reproduce to <5e-5 (f32 floor); real trials
    (golden 5.06601 / 4.26793) reproduce to 0.014 / 0.007 — fully
    explained by the unrecoverable 0x0D→0x0A flips in the stored models
    (≈2 flipped bytes per component)."""
    from lia_ral.tools import compute_test

    d = _repaired_compute_test_dir(tmp_path)
    cfg = Config.load(os.path.join(CT, "ComputeTest.cfg"))
    cfg["featureFilesPath"] = d + "/"
    cfg["mixtureFilesPath"] = d + "/"
    cfg["labelFilesPath"] = d + "/"
    cfg["loadLabelFileExtension"] = ".lbl"
    cfg["ndxFilename"] = os.path.join(CT, "ndx")
    cfg["outputFilename"] = os.path.join(d, "test1.res")
    compute_test.main(cfg)

    golden = read_nist_scores(os.path.join(CT, "test1.validate.res"))
    got = read_nist_scores(os.path.join(d, "test1.res"))
    assert len(golden) == 8 and len(got) == 8
    by_key = {(r.model, r.seg, r.begin, r.end): r.score for r in got}
    for g in golden:
        key = (g.model, g.seg, g.begin, g.end)
        assert key in by_key, f"missing trial {key}"
        delta = abs(by_key[key] - g.score)
        if g.model == "test2":       # model == world: exact-zero trial
            assert delta < 5e-5, (key, by_key[key], g.score)
        else:
            assert delta < 0.03, (key, by_key[key], g.score)


# ---------------------------------------------------------------------------
# GmmTokenizer goldens (wld here is flip-corrupted but NOT truncated)
# ---------------------------------------------------------------------------

def _tok_cfg(tmp_path) -> Config:
    d = str(tmp_path)
    for f in ("test1.prm", "test1.lbl", "ndx"):
        shutil.copy(os.path.join(TOK, f), d)
    cfg = Config.load(os.path.join(TOK, "GmmTokenizer.cfg"))
    cfg["featureFilesPath"] = d + "/"
    cfg["mixtureFilesPath"] = TOK + "/"
    cfg["labelFilesPath"] = d + "/"
    cfg["loadLabelFileExtension"] = ".lbl"
    cfg["inputFeatureFilename"] = os.path.join(d, "ndx")
    cfg["symbolsFilesPath"] = d + "/"
    cfg["utilMode"] = "gmmTokenizer"
    return cfg


@requires_reference
def test_gmm_tokenizer_symbols_golden(tmp_path):
    """Winning-component symbol stream vs test1.sym.ref: EXACT match
    (9/9 symbols).  The golden is the run-length-collapsed stream — 37
    selected frames → 9 runs; the argmax is robust to the flip noise."""
    from lia_ral.tools.utils_tools import gmm_tokenizer_main

    out = gmm_tokenizer_main(_tok_cfg(tmp_path))
    with open(os.path.join(TOK, "test1.sym.ref")) as f:
        golden = [int(t) for t in f.read().split()]
    got = [int(s) for s in out["test1"]]
    assert got == golden, (got, golden)
    with open(os.path.join(str(tmp_path), "test1.sym")) as f:
        assert [int(t) for t in f.read().split()] == golden


@requires_reference
def test_gmm_tokenizer_confusion_golden(tmp_path):
    """Confusion matrix vs mce_matrix.mat.ref: EXACT integer match
    (0/16384 cells differ).  The golden's total count is 740 = 37
    frames × 20, i.e. it was produced with topDistribsCount 20 (the
    checked-in cfg says 6 — the golden predates it)."""
    from lia_ral.io.matrix import read_matrix_file
    from lia_ral.tools.utils_tools import gmm_tokenizer_main

    cfg = _tok_cfg(tmp_path)
    cfg["confusionMatrix"] = "true"
    cfg["topDistribsCount"] = 20
    cfg["matrixOutputName"] = os.path.join(str(tmp_path), "mce_matrix.mat")
    mce = gmm_tokenizer_main(cfg)
    golden = read_matrix_file(
        os.path.join(TOK, "mce_matrix.mat.ref")).astype(np.int64)
    np.testing.assert_array_equal(mce, golden)
    back = read_matrix_file(cfg.get_str("matrixOutputName")).astype(np.int64)
    np.testing.assert_array_equal(back, golden)


# ---------------------------------------------------------------------------
# Scoring / FusionScore goldens (pure-text fixtures, undamaged → exact)
# ---------------------------------------------------------------------------

@requires_reference
def test_scoring_nist_golden(tmp_path):
    """Scoring --mode NIST on score.nist vs score.final.nist: exact
    field-level parity (reference cmdline in test1.sh: threshold 2,
    segTypeTest/trainTypeTest 1side, adaptationMode n)."""
    from lia_ral.tools.utils_tools import scoring_main

    out = os.path.join(str(tmp_path), "score.final.nist")
    cfg = Config({
        "utilMode": "scoring", "mode": "NIST",
        "inputFile": os.path.join(SCOR, "score.nist"),
        "outputFile": out, "threshold": 2,
        "segTypeTest": "1side", "trainTypeTest": "1side",
        "adaptationMode": "n",
    })
    scoring_main(cfg)
    with open(os.path.join(SCOR, "score.final.nist")) as f:
        golden = [ln.split() for ln in f if ln.strip()]
    with open(out) as f:
        got = [ln.split() for ln in f if ln.strip()]
    assert len(got) == len(golden)
    for g, o in zip(golden, got):
        assert o[:7] == g[:7], (o, g)
        assert float(o[7]) == pytest.approx(float(g[7]))


@requires_reference
def test_fusion_identity_golden(tmp_path):
    """FusionScore with the reference's fixture (score.nist fused with
    itself at weights 0.5/0.5) must reproduce the input scores exactly
    (test1.sh: 'Check if fusion.nist and score.nist are the same')."""
    from lia_ral.tools.utils_tools import fusion_main

    d = str(tmp_path)
    shutil.copy(os.path.join(FUS, "score.nist"), d)
    with open(os.path.join(d, "fusion.lst"), "w") as f:
        f.write(os.path.join(d, "score.nist") + "\n")
        f.write(os.path.join(d, "score.nist") + "\n")
    shutil.copy(os.path.join(FUS, "weights"), d)
    cfg = Config({
        "utilMode": "fusion",
        "inputFileList": os.path.join(d, "fusion.lst"),
        "weights": os.path.join(d, "weights"),
        "fusionMethod": "ArithMean", "format": "lia",
        "outputFile": os.path.join(d, "fusion.nist"),
    })
    fusion_main(cfg)
    src = read_nist_scores(os.path.join(FUS, "score.nist"))
    fused = read_nist_scores(os.path.join(d, "fusion.nist"))
    src_map = {(l.model, l.seg): l.score for l in src}
    fused_map = {(l.model, l.seg): l.score for l in fused}
    assert fused_map == pytest.approx(src_map)


# ---------------------------------------------------------------------------
# EnergyDetector golden (quantified boundaries)
# ---------------------------------------------------------------------------

@requires_reference
def test_energy_detector_reference_math_exact(tmp_path):
    """EnergyDetector parity is pinned to the CURRENT reference code, not
    the stale golden: with the checked-in cfg (K=2, deterministic
    energyMixtureInit means −2/+2, meanStd, α=0.25) the reference EM —
    re-simulated exactly in float64 — yields threshold 14.1016 selecting
    frames {2, 17..25} of the 26 'male' frames; the golden
    ``0.21 0.26`` cannot be produced by that code (its fixed init is a
    later change than the golden; the file's own history comment shows
    the random init it replaced).  What the golden DOES still validate is
    the selectFrames tail quirk: an open run at input-segment end extends
    one frame past the label (…0.26 from a 0-0.25 label), which this
    output reproduces (0.17 → 0.26)."""
    from lia_ral.io import read_label_file
    from lia_ral.tools import energy_detector

    ED = os.path.join(REFERENCE, "LIA_SpkDet/EnergyDetector/test")
    d = str(tmp_path)
    shutil.copy(os.path.join(ED, "test1.prm"), d)
    shutil.copy(os.path.join(ED, "test1.lbl"), d)
    cfg = Config.load(os.path.join(ED, "EnergyDetector.cfg"))
    for k in ("featureFilesPath", "mixtureFilesPath", "labelFilesPath",
              "lstPath"):
        cfg[k] = d + "/"
    cfg["loadLabelFileExtension"] = ".lbl"
    energy_detector.main(cfg)
    got = read_label_file(os.path.join(d, "test1.enr.lbl"))
    assert [(s.begin, s.end, s.label) for s in got] == [
        (0.02, 0.02, "speech"), (0.17, 0.26, "speech")]
    # the tail quirk the golden exhibits (end one frame past the label)
    golden = read_label_file(os.path.join(ED, "test1.validate.enr.lbl"))
    assert golden[0].end == got[-1].end == 0.26


# ---------------------------------------------------------------------------
# Dormant reference fixtures (round-4: SequenceExtractor, PolyExp,
# LabelNGram test/ dirs were never read by any test).  No golden outputs
# are checked in for these tools, so the tests pin (a) exact format
# compatibility with the real fixture files and (b) hand-derivable
# behavioural invariants, plus regression-pinned outputs.

SEQ = os.path.join(REFERENCE, "LIA_Utils/SequenceExtractor/test")
POLY = os.path.join(REFERENCE, "LIA_Utils/PolyExp/test")
LNG = os.path.join(REFERENCE, "LIA_Utils/LabelNGram/test")


@requires_reference
def test_sequence_extractor_fixture(tmp_path):
    """Drive the real ngram1-3.dta per test1.sh's CLI args
    (SequenceExtractor.cpp:732-827).  The unigrams are four symbols of
    count 50 (total 200); with nbOutputSymb=4 the equal-probability
    carve MUST give each output symbol exactly count 200/4=50 — a
    hand-derivable invariant, not just a snapshot."""
    from lia_ral.tools.utils_tools import sequence_extract_main
    from lia_ral.utils.seqtree import CommonPartTree, SequenceDecoder

    tree = CommonPartTree.from_ngram_files(
        os.path.join(SEQ, "ngram"), ".dta", 3, 10000)
    assert tree.total_child_count == 200    # 4 unigrams × count 50

    cfg = Config({
        "maxOrder": 3, "maxNgram": 10000, "nbInputSymb": 128,
        "nbOutputSymb": 4,
        "ngramFilename": os.path.join(SEQ, "ngram"), "ngramExt": ".dta",
        "outputFilename": str(tmp_path / "output"),
        "outputInfoFilename": str(tmp_path / "output.info"),
    })
    dec, info = sequence_extract_main(cfg)
    assert info == [(0, 50), (1, 50), (2, 50), (3, 50)]
    # decoder tree round-trips through the reference text format
    saved = (tmp_path / "output").read_text()
    with open(tmp_path / "output") as f:
        dec2 = SequenceDecoder.load(f)
    out2 = tmp_path / "output2"
    with open(out2, "w") as f:
        dec2.save(f)
    assert out2.read_text() == saved
    # the info file exists with one line per output symbol
    lines = (tmp_path / "output.info").read_text().split()
    assert len(lines) == 8


@requires_reference
def test_polyexp_fixture(tmp_path):
    """Run PolyExpand.cfg verbatim on test1.prm (SPRO3 format,
    featureServerMask 0-15,17-32 → 32 dims) through both test.sh passes
    (--computeR then --normalize, PolyExpand.cpp:164-211)."""
    from lia_ral.tools.utils_tools import poly_exp_main
    from lia_ral.utils.polyexp import poly_expansion_size

    base = Config.load(os.path.join(POLY, "PolyExpand.cfg"))
    for k, v in {
            "featureFilesPath": POLY + "/", "labelFilesPath": POLY + "/",
            "lstPath": POLY + "/", "vectorFilesPath": str(tmp_path) + "/",
            "inputFeatureFilename": os.path.join(POLY, "test.lst")}.items():
        base[k] = v
    assert base.get_str("loadFeatureFileFormat") == "SPRO3"

    # pass 1: R accumulation over the list (cpp:201-207)
    c1 = base.copy()
    c1["computeR"] = str(tmp_path / "R.mat")
    r = poly_exp_main(c1)["R"]
    exp_size = poly_expansion_size(32)          # mask keeps 32 of 33 dims
    assert r.shape == (2, exp_size) and exp_size == 6545
    # constant term: E[1²]=1 → R=1, mean=1 (computeRSqrt cpp:131-136)
    assert r[0, 0] == pytest.approx(1.0) and r[1, 0] == pytest.approx(1.0)
    r_lines = [ln for ln in
               (tmp_path / "R.mat").read_text().splitlines() if ln]
    assert len(r_lines) == exp_size and len(r_lines[0].split()) == 2

    # pass 2: normalized SVMLight vectors (cpp:147-156, exType 1)
    c2 = base.copy()
    c2["normalize"] = str(tmp_path / "R.mat")
    v = poly_exp_main(c2)["test1"]
    assert v.shape == (exp_size,)
    assert v[0] == pytest.approx(1.0)           # 1 · R[0]
    toks = (tmp_path / "test1.vect").read_text().split()
    assert toks[0] == "1"                       # exType
    assert toks[1].startswith("1:") and len(toks) == exp_size + 1
    # normalized values have unit scale (z-ish norm by 1/sqrt(E[x²]))
    assert np.all(np.abs(v) < 50)


@requires_reference
def test_label_ngram_fixture(tmp_path):
    """Process the real test.sym (30994 symbols) with
    codebook.16.3gram.des per config.cfg (LabelNGram.cpp:160-268)."""
    from lia_ral.tools.utils_tools import label_ngram_main
    from lia_ral.utils import read_ngram_codebook

    codebook = read_ngram_codebook(
        os.path.join(LNG, "codebook.16.3gram.des"), 3, 16)
    assert len(codebook) == 16
    assert codebook[0] == (0, 22, 0)            # top trigram, count 1928

    def run(label_dir):
        cfg = Config.load(os.path.join(LNG, "config.cfg"))
        for k, v in {
                "NGramFilename": os.path.join(LNG, "codebook.16.3gram.des"),
                "NGramOrder": 3, "NGramSelected": 16, "inputFilename": "test",
                "symbolPath": LNG + "/", "symbolFileExtension": ".sym",
                "labelInputPath": str(label_dir) + "/",
                "labelFileExtension": ".lbl",
                "labelOutputPath": str(tmp_path) + "/",
                "saveLabelFileExtension": ".sym.lbl"}.items():
            cfg[k] = v
        return label_ngram_main(cfg)

    # fixture window 100.00-100.20 s decodes as oov against the top-16
    # codebook (regression-pinned; frame convention per PARITY.md)
    segs = run(LNG)
    assert [(round(s.begin, 2), round(s.end, 2), s.label)
            for s in segs] == [(100.0, 100.21, "oov")]

    # a window covering an actual occurrence of the top codebook trigram
    # must emit its 1-based codebook index as the label
    from lia_ral.io.lists import read_simple_list
    syms = [-1 if s == "oov" else int(s) for s in
            read_simple_list(os.path.join(LNG, "test.sym"))]
    runs, pos = [], []
    for i, s in enumerate(syms):
        if not runs or runs[-1] != s:
            runs.append(s)
            pos.append(i)
    hit = next(j for j in range(len(runs) - 2)
               if tuple(runs[j:j + 3]) == (0, 22, 0))
    b, e = pos[hit], pos[hit + 3] if hit + 3 < len(pos) else len(syms)
    (tmp_path / "test.lbl").write_text(f"{b * 0.01:.2f} {e * 0.01:.2f} x\n")
    segs = run(tmp_path)
    assert any(s.label == "1" for s in segs)    # codebook index 1 (1-based)
