"""Generate CONFIG_KEYS.md: every config key the framework reads.

Scans lia_ral/ for cfg.get_str/get_int/get_float/get_bool/exists
calls, collects (key, type, default, modules) and emits a markdown
table — the audit surface for key-level parity with the reference's
config vocabulary (ALIZE Config/ConfigChecker).

Usage: python scripts/gen_config_keys.py [> CONFIG_KEYS.md]
"""

from __future__ import annotations

import os
import re
import sys
from collections import defaultdict

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "lia_ral")

PAT = re.compile(
    r"""(?:cfg|ccfg|cfg2)\.(get_str|get_int|get_float|get_bool|exists)\(\s*
        ["']([A-Za-z0-9_]+)["']\s*
        (?:,\s*((?:[^()]|\([^()]*\))+?))?\s*\)""",
    re.VERBOSE)

TYPES = {"get_str": "str", "get_int": "int", "get_float": "float",
         "get_bool": "bool", "exists": "(presence)"}


def main() -> None:
    keys: dict[str, dict] = defaultdict(
        lambda: {"types": set(), "defaults": set(), "modules": set()})
    for dirpath, _, files in os.walk(ROOT):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, ROOT)
            text = open(path, encoding="utf-8").read()
            for m in PAT.finditer(text):
                getter, key, default = m.groups()
                e = keys[key]
                e["types"].add(TYPES[getter])
                if default:
                    e["defaults"].add(default.strip())
                e["modules"].add(rel.replace(os.sep, "/")[:-3])
    out = sys.stdout
    out.write("# Config keys — the framework's full config vocabulary\n\n")
    out.write("Generated by `scripts/gen_config_keys.py` (scan of every "
              "`cfg.get_*` call).\nKeys are the reference's own names "
              "(ALIZE Config vocabulary) plus the\ndocumented "
              "additions (numThread semantics, fastMath/fastStats,\n"
              "statsBucketFrames/statsBatchSize, speakerChunk, ...).\n\n")
    out.write(f"{len(keys)} keys.\n\n")
    out.write("| key | type(s) | default(s) | read by |\n|---|---|---|---|\n")
    for key in sorted(keys, key=str.lower):
        e = keys[key]
        types = ", ".join(sorted(t for t in e["types"]
                                 if t != "(presence)")) or "(presence)"
        defaults = "; ".join(sorted(e["defaults"]))[:60] or "—"
        mods = ", ".join(sorted(e["modules"]))
        out.write(f"| `{key}` | {types} | {defaults} | {mods} |\n")


if __name__ == "__main__":
    main()
