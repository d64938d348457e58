"""Native liaio library: build, parity with the Python readers."""

import os

import numpy as np
import pytest

from lia_ral.io.features import read_feature_file, write_feature_file
from lia_ral.io.native import (apply_mask_native, available,
                                   read_features_native)
from tests.conftest import REFERENCE, requires_reference

pytestmark = pytest.mark.skipif(not available(),
                                reason="native toolchain unavailable")


def test_native_matches_python(tmp_path, rng):
    data = rng.standard_normal((37, 13)).astype(np.float32)
    for fmt in ("SPRO3", "SPRO4", "RAW"):
        p = str(tmp_path / f"x_{fmt}.prm")
        write_feature_file(p, data, fmt=fmt)
        nat = read_features_native(p, fmt, vect_size=13)
        assert nat is not None, fmt
        np.testing.assert_array_equal(nat, data)
        # full reader (native path on) == python path
        py = read_feature_file(p, fmt=fmt, vect_size=13, use_native=False)
        full = read_feature_file(p, fmt=fmt, vect_size=13, use_native=True)
        np.testing.assert_array_equal(full.data, py.data)


@requires_reference
def test_native_reads_reference_fixture():
    p = os.path.join(REFERENCE, "LIA_SpkDet/TrainWorld/test/test1.prm")
    nat = read_features_native(p, "SPRO3")
    assert nat is not None and nat.shape == (50, 34)
    py = read_feature_file(p, fmt="SPRO3", use_native=False)
    np.testing.assert_array_equal(nat, py.data)
    ff = read_feature_file(p, fmt="SPRO3", use_native=True)
    assert ff.kind == "FBCEPSTRA" and ff.flag == 9


def test_native_mask(rng):
    data = rng.standard_normal((20, 10)).astype(np.float32)
    idx = [0, 2, 5, 9]
    nat = apply_mask_native(data, idx)
    assert nat is not None
    np.testing.assert_array_equal(nat, data[:, idx])


def test_native_bad_file_falls_back(tmp_path):
    p = str(tmp_path / "garbage.prm")
    with open(p, "wb") as f:
        f.write(b"\x01\x02\x03")
    assert read_features_native(p, "SPRO3") is None


def test_native_batch_loader_matches_sequential(tmp_path, rng):
    """liaio_read_batch (parallel worker pool) == per-file reads, with
    None for unreadable entries and featureServerMask applied through
    load_files_batch."""
    import numpy as np
    from lia_ral.config import Config
    from lia_ral.io.features import read_feature_file, write_feature_file
    from lia_ral.io.native import read_features_batch_native
    from lia_ral.tools.common import load_files_batch

    names, mats = [], []
    for i, n in enumerate([37, 512, 5, 129]):
        m = rng.standard_normal((n, 9)).astype(np.float32)
        nm = f"bf{i}"
        write_feature_file(str(tmp_path / (nm + ".prm")), m, fmt="SPRO4")
        names.append(nm)
        mats.append(m)
    paths = [str(tmp_path / (n + ".prm")) for n in names]
    out = read_features_batch_native(paths + [str(tmp_path / "nope.prm")],
                                    "SPRO4")
    if out is None:
        import pytest
        pytest.skip("native library unavailable")
    for m, o in zip(mats, out):
        np.testing.assert_array_equal(m, o)
    assert out[-1] is None
    # through the config-driven helper with a column mask
    cfg = Config({
        "featureFilesPath": str(tmp_path) + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".prm",
        "featureServerMask": "0-3,5",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
    })
    loaded = load_files_batch(names + ["nope"], cfg, batch=2)
    for m, o in zip(mats, loaded):
        np.testing.assert_array_equal(m[:, [0, 1, 2, 3, 5]], o)
    assert loaded[-1] is None


@requires_reference
def test_batch_loader_reads_reference_fixtures():
    """The parallel batch loader parses the reference's own .prm
    fixtures identically to the per-file reader."""
    import glob
    import numpy as np
    from lia_ral.io.features import read_feature_file
    from lia_ral.io.native import read_features_batch_native
    paths = sorted(glob.glob(
        REFERENCE + "/LIA_SpkDet/TrainWorld/test/*.prm"))[:4]
    assert paths
    out = read_features_batch_native(paths, "SPRO4")
    if out is None:
        import pytest
        pytest.skip("native library unavailable")
    assert any(o is not None for o in out), "no fixture parsed natively"
    for p, o in zip(paths, out):
        ref = read_feature_file(p, fmt="SPRO4").data
        if o is None:     # SPRO3-headered fixture → python fallback path
            continue
        np.testing.assert_array_equal(o, ref)
