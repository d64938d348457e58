"""SimpleSpkDetSystem + TCP server/client end-to-end over a real socket."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lia_ral.api import RemoteSpkDetClient, SimpleSpkDetSystem, SpkDetServer
from lia_ral.config import Config
from lia_ral.gmm import GmmDiag, TrainCfg, mixture_init, train_model


@pytest.fixture(scope="module")
def world_and_data():
    rng = np.random.default_rng(42)
    d, k = 8, 16
    centers = rng.standard_normal((k, d)) * 2

    def utt(shift, n=1500):
        comp = rng.integers(0, k, n)
        return (centers[comp] + shift
                + rng.standard_normal((n, d)) * 0.5).astype(np.float32)

    bg = utt(0.0, 8000)
    xj = jnp.asarray(bg)
    w = jnp.ones(bg.shape[0], jnp.float32)
    init = mixture_init(jax.random.key(0), xj, w, k, 1.0)
    ubm = train_model(jax.random.key(1), xj, w, init, TrainCfg(nb_train_it=4))
    spk1 = rng.standard_normal(d) * 1.0
    spk2 = -spk1
    return ubm, (lambda s, n=1500: utt(s, n)), spk1, spk2


def test_simple_system_verify_identify(world_and_data):
    ubm, utt, spk1, spk2 = world_and_data
    sysm = SimpleSpkDetSystem()
    sysm.set_background_model(ubm)
    sysm.add_features(utt(spk1))
    sysm.create_speaker_model("alice")
    sysm.reset_features()
    sysm.add_features(utt(spk2))
    sysm.create_speaker_model("bob")
    # test: alice's new session
    sysm.reset_features()
    sysm.add_features(utt(spk1, 800))
    ok, score = sysm.verify_speaker("alice")
    assert ok and score > 0
    ok2, score2 = sysm.verify_speaker("bob")
    assert score2 < score
    dec, s, uid = sysm.identify_speaker()
    assert uid == "alice"


def test_score_accumulation(world_and_data):
    ubm, utt, spk1, _ = world_and_data
    sysm = SimpleSpkDetSystem()
    sysm.set_background_model(ubm)
    sysm.add_features(utt(spk1))
    sysm.create_speaker_model("alice")
    sysm.reset_features()
    sysm.add_features(utt(spk1, 400))
    _, s1 = sysm.verify_speaker("alice", with_score_accumulation=True)
    sysm.reset_features()
    sysm.add_features(utt(spk1, 400))
    _, s2 = sysm.verify_speaker("alice", with_score_accumulation=True)
    assert np.isfinite(s1) and np.isfinite(s2)
    sysm.reset_accumulated_scores()


def test_audio_path():
    rng = np.random.default_rng(0)
    sysm = SimpleSpkDetSystem()
    sysm.add_audio(rng.standard_normal(16000).astype(np.float32))
    assert sysm.feature_count() > 90
    assert sysm.features.shape[1] == 40   # 19+1 ceps × 2 (deltas)
    sysm.normalize_features(energy_column=19)
    assert sysm.feature_count() > 0


def test_tcp_server_client(world_and_data, tmp_path):
    ubm, utt, spk1, spk2 = world_and_data
    wld_path = str(tmp_path / "ubm.gmm")
    ubm.save(wld_path)
    srv = SpkDetServer(Config(), port=0)
    port = srv.start()
    try:
        cli = RemoteSpkDetClient(port=port)
        assert "I_DET" in cli.list_commands()
        cli.load_world(wld_path)
        cli.send_features(utt(spk1))
        cli.train_speaker("alice")
        cli.reset_features()
        cli.send_features(utt(spk2))
        cli.train_speaker("bob")
        cli.reset_features()
        cli.send_features(utt(spk1, 800))
        ok, score = cli.verify("alice")
        assert ok and score > 0
        dec, s, uid = cli.identify()
        assert uid == "alice"
        assert "alice" in cli.status()
        # cumulated identification list (I_IDCUMGETLIST,
        # SpkDetServerConstants.h:46): empty before any *CUM command,
        # best-first entries for every scored speaker afterwards
        assert cli.cumulated_results() == []
        cli.identify(cumulative=True)
        cum = cli.cumulated_results()
        assert [u for u, _ in cum] == ["alice", "bob"]
        assert cum[0][1] >= cum[1][1]
        cli.reset_accumulated_scores()
        assert cli.cumulated_results() == []
        # model save/load roundtrip over the wire
        mp = str(tmp_path / "alice.gmm")
        cli.save_speaker("alice", mp)
        cli.delete_speaker("alice")
        cli.load_speaker("alice2", mp)
        ok2, score2 = cli.verify("alice2")
        assert abs(score2 - score) < 1e-4
        cli.close()
    finally:
        srv.stop()


def test_server_error_handling(world_and_data):
    srv = SpkDetServer(Config(), port=0)
    port = srv.start()
    try:
        cli = RemoteSpkDetClient(port=port)
        with pytest.raises(RuntimeError):
            cli.verify("ghost")       # no UBM, no model → server error
        # connection still usable afterwards
        assert "features=0" in cli.status()
        cli.close()
    finally:
        srv.stop()


def test_tcp_audio_commands(tmp_path):
    """A_* protocol: stream PCM packets, zero-size packet parameterizes;
    A_SAVE/A_LOAD round-trip the raw audio (SpkDetServer.cpp:294-337)."""
    rng = np.random.default_rng(1)
    srv = SpkDetServer(Config(), port=0)
    port = srv.start()
    try:
        cli = RemoteSpkDetClient(port=port)
        sig = rng.standard_normal(16000).astype(np.float32) * 0.1
        cli.send_audio(sig, chunk_frames=4000)   # 2 packets + terminator
        assert "features=" in cli.status()
        n1 = int(cli.status().split("features=")[1].split()[0])
        assert n1 > 90                            # ~1 s of 10 ms frames
        # save buffered audio (empty after parameterization) then reload
        pcm_path = str(tmp_path / "sig.pcm")
        (np.clip(sig, -1, 1) * 32767).astype("<i2").tofile(pcm_path)
        cli.load_audio_file(pcm_path)
        n2 = int(cli.status().split("features=")[1].split()[0])
        assert n2 > n1
        cli.reset_audio()
        cli.close()
    finally:
        srv.stop()
