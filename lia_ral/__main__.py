"""Umbrella CLI: ``python -m lia_ral <Tool> --config file.cfg ...``.

Maps the reference's binary names (LIA_SpkDet/LIA_SpkSeg/LIA_Utils
executables — the names a LIA_RAL user already knows) onto the tool
modules, with mode-dispatched tools (EigenVoice → jfa_tools, Svm →
utils_tools, ...) pre-seeding their mode key.  ``python -m lia_ral``
with no arguments lists everything.
"""

from __future__ import annotations

import sys

# tool name → (module, {preset config keys}); names match the reference
# binaries (SURVEY.md §2.2-2.4)
TOOLS: dict[str, tuple[str, dict[str, str]]] = {
    "NormFeat": ("norm_feat", {}),
    "EnergyDetector": ("energy_detector", {}),
    "TrainWorld": ("train_world", {}),
    "TrainTarget": ("train_target", {}),
    "ComputeTest": ("compute_test", {}),
    "ComputeNorm": ("compute_norm", {}),
    "TotalVariability": ("total_variability", {}),
    "IvExtractor": ("iv_extractor", {}),
    "IvNorm": ("iv_norm", {}),
    "IvTest": ("iv_test", {}),
    "PLDA": ("plda_tool", {}),
    "SpkAdapt": ("spk_adapt", {}),
    "ComputeJFAStats": ("jfa_tools", {"jfaMode": "stats"}),
    "ComputeTVStats": ("jfa_tools", {"jfaMode": "stats"}),
    "EigenVoice": ("jfa_tools", {"jfaMode": "eigenVoice"}),
    "EigenChannel": ("jfa_tools", {"jfaMode": "eigenChannel"}),
    "EstimateDMatrix": ("jfa_tools", {"jfaMode": "estimateD"}),
    "AcousticSegmentation": ("spkseg_tools", {"segMode": "acoustic"}),
    "TurnDetection": ("spkseg_tools", {"segMode": "turnDetection"}),
    "Segmentation": ("spkseg_tools", {"segMode": "segmentation"}),
    "ReSegmentation": ("spkseg_tools", {"segMode": "resegmentation"}),
    # LIA_Utils binaries → utils_tools modes
    "Scoring": ("utils_tools", {"utilMode": "scoring"}),
    "FusionScore": ("utils_tools", {"utilMode": "fusion"}),
    "ScoreWarp": ("utils_tools", {"utilMode": "scoreWarp"}),
    "Hist": ("utils_tools", {"utilMode": "hist"}),
    "ModelToSv": ("utils_tools", {"utilMode": "modelToSv"}),
    "NAPSV": ("utils_tools", {"utilMode": "napSv"}),
    "CovIntra": ("utils_tools", {"utilMode": "covIntra"}),
    "ReadFeatFile": ("utils_tools", {"utilMode": "readFeatFile"}),
    "ReadModel": ("utils_tools", {"utilMode": "readModel"}),
    "ExtractParams": ("utils_tools", {"utilMode": "extractParams"}),
    "PolyExp": ("utils_tools", {"utilMode": "polyExp"}),
    "GmmTokenizer": ("utils_tools", {"utilMode": "gmmTokenizer"}),
    "BNGram": ("utils_tools", {"utilMode": "bNgram"}),
    "LabelNGram": ("utils_tools", {"utilMode": "labelNgram"}),
    "SequenceDecode": ("utils_tools", {"utilMode": "sequenceDecode"}),
    "SequenceExtractor": ("utils_tools", {"utilMode": "sequenceExtract"}),
    "LabelFusion": ("utils_tools", {"utilMode": "labelFusion"}),
    "TimeCluster": ("utils_tools", {"utilMode": "timeCluster"}),
    "SvmTrain": ("utils_tools", {"utilMode": "svmTrain"}),
    "SvmPredict": ("utils_tools", {"utilMode": "svmPredict"}),
    "SpkDetServer": ("", {}),      # handled specially below
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        width = max(len(n) for n in TOOLS)
        print("usage: python -m lia_ral <Tool> [--config FILE] "
              "[--key value ...]\n\ntools (reference binary names):")
        for name, (mod, preset) in sorted(TOOLS.items()):
            target = f"tools/{mod}" if mod else "api/server"
            mode = next(iter(preset.values()), "")
            print(f"  {name:<{width}}  -> {target}"
                  + (f" [{mode}]" if mode else ""))
        return 0
    name, rest = argv[0], argv[1:]
    if name not in TOOLS:
        print(f"unknown tool {name!r} — run with no arguments for the list",
              file=sys.stderr)
        return 2
    from .config import Config
    if name == "SpkDetServer":
        from .api.server import serve_forever
        cfg = Config.from_cli(rest)
        serve_forever(cfg, port=cfg.get_int("port", 32114))
        return 0
    mod_name, preset = TOOLS[name]
    import importlib
    mod = importlib.import_module(f".tools.{mod_name}", __package__)
    cfg = Config.from_cli(rest)
    for k, v in preset.items():
        if not cfg.exists(k):
            cfg[k] = v
    mod.main(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
