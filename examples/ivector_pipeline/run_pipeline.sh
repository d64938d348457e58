#!/bin/sh
# End-to-end i-vector pipeline through the CLI tools, driven by
# reference-style .cfg files.  Each stage is a separate process (the
# file-DAG operational model); the persistent XLA compile cache makes
# stages 2+ and re-runs nearly compile-free.
#
# Expects: ./data/*.prm features (+ optional .lbl labels), ./lists/*.lst
# and *.ndx lists.  See scripts/milestone_eer.py for a synthetic corpus
# generator exercising the same DAG.
set -e
python -m lia_ral.tools.norm_feat          --config 00_NormFeat.cfg
python -m lia_ral.tools.train_world        --config 01_TrainWorld.cfg
python -m lia_ral.tools.total_variability  --config 02_TotalVariability.cfg
python -m lia_ral.tools.iv_extractor       --config 03_IvExtractor.cfg
python -m lia_ral.tools.iv_test            --config 04_IvTest_plda.cfg
echo "scores written to ./scores_plda.nist"
