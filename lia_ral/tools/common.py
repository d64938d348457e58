"""Shared tool plumbing: feature/label loading per config, device setup.

Replaces the per-tool boilerplate of the reference mains
(FeatureServer construction + initializeClusters + verifyClusterFile,
e.g. TrainWorld.cpp:66-77).
"""

from __future__ import annotations

import os

import numpy as np

from ..config import Config
from ..io.features import FeatureServer, server_from_config
from ..io.labels import SegmentStore
from ..io.lists import read_simple_list


def resolve_list(cfg: Config, key: str) -> list[str]:
    """A config value that is either a list file (one name per line) or a
    direct basename (reference inputFeatureFilename semantics)."""
    val = cfg.get_str(key)
    lst_path = os.path.join(cfg.get_str("lstPath", "./"), val)
    for p in (val, lst_path):
        if os.path.isfile(p) and not p.endswith(
                cfg.get_str("loadFeatureFileExtension", ".prm")):
            try:
                names = read_simple_list(p)
                if names:
                    return names
            except UnicodeDecodeError:
                pass
    return [val]


def label_path(name: str, cfg: Config, save: bool = False) -> str:
    root = cfg.get_str("labelFilesPath", "./")
    key = "saveLabelFileExtension" if save else "loadLabelFileExtension"
    ext = cfg.get_str(key, ".lbl")
    return os.path.join(root, name + ext)


def load_features_and_mask(
    names: list[str], cfg: Config
) -> tuple[FeatureServer, np.ndarray]:
    """FeatureServer over the listed files + the frame selection mask from
    the per-file label files (labelSelectedFrames / addDefaultLabel)."""
    fs = server_from_config(names, cfg)
    frame_length = cfg.get_float("frameLength", 0.01)
    label = cfg.get_str("labelSelectedFrames", "speech")
    add_default = cfg.get_bool("addDefaultLabel", False)
    default_label = cfg.get_str("defaultLabel", label)
    mask = np.zeros(fs.nframes, dtype=np.float32)
    for i, name in enumerate(names):
        a, b = fs.source_range(i)
        lp = label_path(name, cfg)
        store = SegmentStore.from_label_file(
            lp if os.path.isfile(lp) else None,
            b - a, frame_length, add_default, default_label)
        m = store.mask(label, b - a)
        if not m.any() and add_default and label == default_label:
            m[:] = True
        mask[a:b] = m.astype(np.float32)
    return fs, mask


def file_frame_mask(name: str, nframes: int, cfg: Config) -> np.ndarray:
    """Frame-selection mask of ONE file from its label file (the per-file
    slice of load_features_and_mask)."""
    frame_length = cfg.get_float("frameLength", 0.01)
    label = cfg.get_str("labelSelectedFrames", "speech")
    add_default = cfg.get_bool("addDefaultLabel", False)
    default_label = cfg.get_str("defaultLabel", label)
    lp = label_path(name, cfg)
    store = SegmentStore.from_label_file(
        lp if os.path.isfile(lp) else None, nframes, frame_length,
        add_default, default_label)
    m = store.mask(label, nframes)
    if not m.any() and add_default and label == default_label:
        m[:] = True
    return m.astype(np.float32)


def load_files_batch(names: list[str], cfg: Config, batch: int = 64
                     ) -> list[np.ndarray | None]:
    """Per-file feature arrays for a name list, read in parallel by the
    native batched loader (liaio_read_batch thread pool) with per-file
    Python fallback — the framework's data-loader hot path for
    thousands-of-files NIST runs.  Returns (T,D) float32 arrays in input
    order (featureServerMask applied), None for unreadable files."""
    from ..io.features import (apply_mask, feature_path, read_feature_file)
    from ..io.native import read_features_batch_native
    fmt = cfg.get_str("loadFeatureFileFormat", "SPRO4")
    mask_cfg = (cfg.get_str("featureServerMask")
                if cfg.exists("featureServerMask") else None)
    big_endian = cfg.get_bool("bigEndian", False)
    vect_size = cfg.get_int("loadFeatureFileVectSize", 0)
    paths = [feature_path(n, cfg) for n in names]
    out: list[np.ndarray | None] = [None] * len(names)
    for s0 in range(0, len(paths), batch):
        grp = paths[s0:s0 + batch]
        res = read_features_batch_native(grp, fmt, big_endian, vect_size)
        for j in range(len(grp)):
            x = res[j] if res is not None else None
            if x is None:
                # per-file fallback keeps the SPRO3/SPRO4 header-sniffing
                # and HTK paths of read_feature_file
                try:
                    x = read_feature_file(grp[j], fmt=fmt,
                                          big_endian=big_endian,
                                          vect_size=vect_size).data
                except Exception:
                    continue
            out[s0 + j] = apply_mask(x, mask_cfg)
    return out


def feature_buffer_size(cfg: Config) -> int | None:
    """Parse ``featureServerBufferSize``: frame count, or None for
    ALL_FEATURES (the reference's bounded feature buffer,
    TrainWorld.cfg)."""
    val = cfg.get_str("featureServerBufferSize", "ALL_FEATURES")
    return int(val) if val.isdigit() else None


def feature_chunk_loader(names: list[str], cfg: Config, buffer_size: int):
    """Streaming loader over a file list: a zero-arg callable yielding
    fixed-shape ``(x[buffer,D], w[buffer])`` chunks per epoch, each built
    from at most ``buffer_size`` frames of host RAM (short tails are
    zero-weight padded).  Honouring featureServerBufferSize lets corpora
    larger than host RAM train (reference FeatureServer semantics)."""

    def loader():
        pend_x: list[np.ndarray] = []
        pend_w: list[np.ndarray] = []
        pending = 0

        def flush(pad: bool):
            nonlocal pend_x, pend_w, pending
            x = np.concatenate(pend_x) if pend_x else None
            w = np.concatenate(pend_w) if pend_w else None
            pend_x, pend_w, pending = [], [], 0
            if x is None or x.shape[0] == 0:
                return None
            if pad and x.shape[0] < buffer_size:
                short = buffer_size - x.shape[0]
                x = np.concatenate(
                    [x, np.zeros((short, x.shape[1]), x.dtype)])
                w = np.concatenate([w, np.zeros((short,), w.dtype)])
            return x, w

        for name in names:
            fs, mask = load_features_and_mask([name], cfg)
            x, w = fs.data, mask
            off = 0
            while off < x.shape[0]:
                take = min(buffer_size - pending, x.shape[0] - off)
                pend_x.append(x[off:off + take])
                pend_w.append(w[off:off + take])
                pending += take
                off += take
                if pending == buffer_size:
                    yield flush(pad=False)
        tail = flush(pad=True)
        if tail is not None:
            yield tail

    return loader


def mixture_path(name: str, cfg: Config, save: bool = False) -> str:
    root = cfg.get_str("mixtureFilesPath", "./")
    key = "saveMixtureFileExtension" if save else "loadMixtureFileExtension"
    ext = cfg.get_str(key, ".gmm")
    return os.path.join(root, name + ext)


def setup_verbose(cfg: Config) -> bool:
    return cfg.get_bool("verbose", False)


def resolve_mesh(cfg: Config):
    """numThread → a ("data",) device mesh, or None for single-device.

    The reference's pthread-pool size knob (numThread,
    AccumulateTVStat.cpp:1694, PldaTools.cpp:2647) maps to data-parallel
    sharding over min(numThread, visible devices) — used by the TV/JFA/
    PLDA stages the same way resolve_stats_fn feeds EM."""
    n_thread = cfg.get_int("numThread", 1)
    if n_thread <= 1:
        return None
    import jax

    from ..parallel.mesh import make_mesh

    n = min(n_thread, len(jax.devices()))
    if n <= 1:
        return None
    return make_mesh(n_data=n, devices=jax.devices()[:n])


def resolve_stats_fn(cfg: Config):
    """Honour the reference's ``numThread`` knob (AccumulateStat.cpp:236):
    the pthread pool maps to data-parallel sharding — shard the frame axis
    over min(numThread, available devices) and psum the stats.  Returns
    None (single-device default kernel) when no parallelism is requested
    or only one device is visible; the fastMath/fastStats keys set the
    precision flags of gmm.stats_path either way."""
    from ..gmm.em import default_stats_fn

    flags = dict(fast_math=cfg.get_bool("fastMath", False),
                 fast_stats=cfg.get_bool("fastStats", False))
    mesh = resolve_mesh(cfg)
    if mesh is None:
        return default_stats_fn(**flags) if any(flags.values()) else None
    from ..parallel.sharding import sharded_stats_fn

    return sharded_stats_fn(mesh, **flags)
