import os

import pytest

from lia_ral.config import Config, ConfigChecker, ConfigError
from tests.conftest import REFERENCE, requires_reference


def test_roundtrip(tmp_path):
    c = Config({"mixtureDistribCount": 16, "verbose": True, "name": "x y"})
    p = tmp_path / "a.cfg"
    c.save(str(p))
    c2 = Config.load(str(p))
    assert c2.get_int("mixtureDistribCount") == 16
    assert c2.get_bool("verbose") is True
    assert c2.get_str("name") == "x y"


def test_cli_overrides_file(tmp_path):
    p = tmp_path / "a.cfg"
    Config({"nbTrainIt": 5, "alpha": 0.5}).save(str(p))
    c = Config.from_cli(["--config", str(p), "--nbTrainIt", "7", "--flag"])
    assert c.get_int("nbTrainIt") == 7
    assert c.get_float("alpha") == 0.5
    assert c.get_bool("flag") is True


def test_checker():
    ck = ConfigChecker().add_integer("n", mandatory=True).add_float("x")
    ck.check(Config({"n": 3, "x": 1.5}))
    with pytest.raises(ConfigError):
        ck.check(Config({"x": 1.5}))
    with pytest.raises(ConfigError):
        ck.check(Config({"n": "notanint"}))


@requires_reference
def test_reads_reference_config():
    cfg = Config.load(os.path.join(
        REFERENCE, "LIA_SpkDet/TrainWorld/test/TrainWorld.cfg"))
    assert cfg.get_int("mixtureDistribCount") == 20
    assert cfg.get_str("featureServerMask") == "0-15,17-32"
    assert cfg.get_bool("bigEndian") is False
    assert cfg.get_float("finalVarianceFlooring") == 0.5


def test_umbrella_cli_lists_and_dispatches(tmp_path, capsys):
    """python -m lia_ral maps reference binary names onto the tools."""
    import numpy as np
    from lia_ral.__main__ import TOOLS, main
    from lia_ral.io.features import write_feature_file
    assert main([]) == 0
    out = capsys.readouterr().out
    for name in ("TrainWorld", "EigenVoice", "GmmTokenizer"):
        assert name in out
    assert main(["NoSuchTool"]) == 2
    # dispatch a real LIA_Utils binary name through its mode preset
    write_feature_file(str(tmp_path / "a.prm"),
                       np.arange(6, dtype=np.float32).reshape(2, 3),
                       fmt="RAW")
    assert main(["ReadFeatFile", "--inputFeatureFilename",
                 str(tmp_path / "a.prm"), "--loadFeatureFileFormat",
                 "RAW", "--loadFeatureFileVectSize", "3"]) in (0, None)
