#!/usr/bin/env python3
"""Time variants of the warpgroup flash kernels on the card: other tile
choices, and probes that take a piece of work out to show what binds.

    python3 scripts/flash_variants.py [--parent ROOT] [NAME ...]

Each NAME is a preset of PRESETS: text substitutions in
``msa_tpu_torch/csrc/flash_kernels.cuh`` (the script fails if one no
longer matches).  It copies ``msa_tpu_torch/`` and ``chip_smoke.py`` into
``build/variants/NAME`` (git-ignored), applies the substitutions, builds
this tree and every copy concurrently (one process a tree, each with its
own ``build/``), prints ptxas's registers, spills and wgmma notices for
each copy's warpgroup kernels, then times the trees in turns with
``chip_smoke.py --flash-times`` (``time_flash_backwards``): the parent
ROOT if given, this tree, each variant, this tree, the parent (with no
NAME: the parent and this tree in turns).  A probe's output is wrong by
design; only its time means something.  Needs nvcc and a card.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
KERNELS = Path("msa_tpu_torch") / "csrc" / "flash_kernels.cuh"

_DQ_GROUPS = ("constexpr int kDqGroups = kDropout ? 1 : 2;",
              "constexpr int kDqMinBlocks = kDropout ? 3 : 2;")
PRESETS = {
    # tile choices
    "fwd_keys128": {"kFwdKeys = 64,": "kFwdKeys = 128,"},
    "fwd_groups1": {"constexpr int kFwdGroups = 2,": "constexpr int kFwdGroups = 1,"},
    "fwd_min1": {"kFwdMinBlocks = 2;": "kFwdMinBlocks = 1;"},
    "dq_groups1": {_DQ_GROUPS[0]: "constexpr int kDqGroups = 1;",
                   _DQ_GROUPS[1]: "constexpr int kDqMinBlocks = 3;"},
    "dq_groups2": {_DQ_GROUPS[0]: "constexpr int kDqGroups = 2;",
                   _DQ_GROUPS[1]: "constexpr int kDqMinBlocks = 2;"},
    "dkv_groups2": {"constexpr int kDkvGroups = 1,": "constexpr int kDkvGroups = 2,"},
    # probes: the exponentials of the softmax taken out (forward, dq, dk/dv)
    "no_exp": {
        "const float p0 = exp2f(s[n][e] - m_run[0]);": "const float p0 = s[n][e] - m_run[0];",
        "const float p1 = exp2f(s[n][2 + e] - m_run[1]);":
            "const float p1 = s[n][2 + e] - m_run[1];",
        "const float p = exp2f(fmaf(s[n][2 * r + e], score_mult, bb) - lse_r[r]);":
            "const float p = fmaf(s[n][2 * r + e], score_mult, bb) - lse_r[r];",
        "const float p = exp2f(fmaf(st_[nn][2 * r + e], score_mult, bias2[r]) - l);":
            "const float p = fmaf(st_[nn][2 * r + e], score_mult, bias2[r]) - l;"},
    # probe: the forward without its P V product
    "no_pv": {"    wg_nn<kD, kN / 2>(acc.x, pa, vt);\n": ""},
}

_BUILD = r"""
import subprocess, sys
sys.path.insert(0, sys.argv[1])
from msa_tpu_torch import _build
secs = {}
_build.build_all(["flash2", "flash_attention", "fused_joint_embed"], seconds=secs)
lines = [f"{sys.argv[2]}: nvcc s {json.dumps({k: round(v, 1) for k, v in secs.items()})}"]
usage = [u for u in _build.resource_usage(["flash2", "flash_attention"])
         if "_wg_kernel" in u["kernel"]]
names = subprocess.run(["c++filt"], input="\n".join(u["kernel"] for u in usage),
                       capture_output=True, text=True, check=True).stdout.splitlines()
for u, n in zip(usage, names):
    n = n.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
    lines.append(f"  {u['source']} {n}: {u['registers']} registers, spill "
                 f"{u['spill_stores']} B, stack {u['stack']} B, wgmma serialised: "
                 f"{'; '.join(u['serialized']) or 'no'}")
print("\n".join(lines), flush=True)
"""


def main() -> int:
    args = sys.argv[1:]
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    unknown = [n for n in args if n not in PRESETS]
    if unknown:
        print(f"usage: flash_variants.py [--parent ROOT] [NAME ...] (NAME in "
              f"{sorted(PRESETS)}); unknown: {unknown}", file=sys.stderr)
        return 2
    trees = {"tree": HERE}
    for name in args:
        root = HERE / "build" / "variants" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(HERE / "msa_tpu_torch", root / "msa_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(HERE / "chip_smoke.py", root)
        text = (root / KERNELS).read_text()
        for old, new in PRESETS[name].items():
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        (root / KERNELS).write_text(text)
        trees[name] = root
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "import json\n" + _BUILD, str(root), name],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, root in trees.items()}
    if parent is not None:  # the parent's kernels, built by its own _build
        builds["parent"] = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
             "from msa_tpu_torch import _build; _build.build_all(['flash2', "
             "'flash_attention', 'fused_joint_embed'])", str(parent)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        trees["parent"] = parent
    for name, proc in builds.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"build of {name} failed:\n{out}")
        if name != "parent":
            print(out, end="", flush=True)
    order = ["tree", *args, "tree"]
    if parent is not None:
        order = ["parent", *order, "parent"]
    for name in order:
        run = subprocess.run([sys.executable, str(HERE / "chip_smoke.py"),
                              "--flash-times", str(trees[name])],
                             capture_output=True, text=True, cwd=HERE)
        times = [line for line in run.stdout.splitlines()
                 if line.startswith("flash kernels")]
        if run.returncode != 0 or not times:
            raise SystemExit(f"--flash-times {name} failed:\n{run.stdout[-3000:]}"
                             f"{run.stderr[-3000:]}")
        print(f"{name}: {times[0].split(': ', 1)[1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
