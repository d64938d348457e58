import os

import numpy as np
import pytest

import jax.numpy as jnp

from lia_ral.config import Config
from lia_ral.frontend.normfeat import feature_mapping
from lia_ral.gmm import GmmDiag
from lia_ral.utils.logging import configure_from, timed, verbose_level


def test_feature_mapping(rng):
    d = 3
    ch = GmmDiag.create(np.ones(2) / 2,
                        np.asarray([[5.0] * d, [-5.0] * d]),
                        np.full((2, d), 4.0))     # σ_ch = 0.5
    ref = GmmDiag.create(np.ones(2) / 2,
                         np.asarray([[1.0] * d, [-1.0] * d]),
                         np.full((2, d), 1.0))    # σ_ref = 1
    x = jnp.asarray(np.asarray([[5.2] * d, [-4.9] * d]), jnp.float32)
    y = np.asarray(feature_mapping(x, ch, ref))
    # frame 0 maps through comp 0: 1 + 2*(5.2-5) = 1.4
    np.testing.assert_allclose(y[0], 1.4, rtol=1e-5)
    np.testing.assert_allclose(y[1], -1.0 + 2 * (-4.9 + 5.0), rtol=1e-4)


def test_logging_config():
    configure_from(Config({"verbose": True, "verboseLevel": 2}))
    from lia_ral.utils import logging as L
    assert L.verbose and L.verbose_level == 2
    with timed("noop"):
        pass
    configure_from(Config({}))
    assert not L.verbose


def test_norm_feat_featmap_mode(tmp_path, rng):
    from lia_ral.io.features import write_feature_file
    from lia_ral.io.gmm_io import write_gmm_file
    from lia_ral.tools import norm_feat
    d = str(tmp_path)
    data = (rng.standard_normal((100, 4)) + 3).astype(np.float32)
    write_feature_file(os.path.join(d, "u.prm"), data, fmt="SPRO4")
    write_gmm_file(os.path.join(d, "chan.gmm"), np.ones(1),
                   np.full((1, 4), 3.0), np.ones((1, 4)))
    write_gmm_file(os.path.join(d, "root.gmm"), np.ones(1),
                   np.zeros((1, 4)), np.ones((1, 4)))
    cfg = Config({
        "featureFilesPath": d + "/", "labelFilesPath": d + "/",
        "mixtureFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO4", "loadFeatureFileExtension": ".prm",
        "saveFeatureFileFormat": "SPRO4",
        "saveFeatureFileExtension": ".map.prm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "inputFeatureFilename": "u", "mode": "featMap",
        "channelMixture": "chan", "inputWorldFilename": "root",
    })
    out = norm_feat.main(cfg)
    # mapped data centered near 0 instead of 3
    assert abs(out["u"].mean()) < 0.3
