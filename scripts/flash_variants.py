#!/usr/bin/env python3
"""Time variants of the warpgroup flash kernels on the card: other tile
choices, and probes that take a piece of work out to show what binds.

    python3 scripts/flash_variants.py [--parent ROOT] [NAME ...]

Each NAME is a preset of PRESETS: text substitutions in
``msa_tpu_torch/csrc/flash_kernels.cuh``, each replaced wherever it
occurs (the script fails if one no longer matches).  It copies ``msa_tpu_torch/`` and ``chip_smoke.py`` into
``build/variants/NAME`` (git-ignored), applies the substitutions, builds
this tree and every copy concurrently (one process a tree, each with its
own ``build/``), prints ptxas's registers, spills and wgmma notices for
each copy's warpgroup kernels, then times the trees in turns with
``chip_smoke.py --flash-times`` (``time_flash_path``: the flash kernels
at head dims 64, 32 and 16, flash at 128, 256 and 192, the frame-level step
at 4 heads of 256 on flash2 and under ``USE_FLASH2 = False`` and bert-large's
on flash2): the parent ROOT
if given, this tree, each variant, this tree, the parent (with no NAME:
the parent and this tree in turns).  A
probe's output is wrong by design; only its time means something.  Needs
nvcc and a card.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
KERNELS = Path("msa_tpu_torch") / "csrc" / "flash_kernels.cuh"

# the split pair's choices above head dim 128 (flash_kernels.cuh)
_WIDE_DQ = ("constexpr int kWideDqGroups = 1, kWideDqRowGroups = 1, kWideDqKeys = 32;",
            "constexpr int kWideDqStages = 1, kWideDqMinBlocks = 2;")
_TWO_STAGES = "constexpr int kWideDqStages = 2, kWideDqMinBlocks = 1;"
_WIDE_ROLE = "constexpr bool kWideDkvByRole = true;"
_DQ_GROUPS = ("kDqGroups = kD > kMaxWholeDkvHeadDim ? kWideDqGroups : kDropout ? 1 : 2;",
              "kD == 128 ? 1 : kDropout ? 3 : 2;")
# the fused sweep's choices (flash_kernels.cuh)
_FUSED_NARROW = "constexpr int kNarrowFusedKeyGroups = 2, kNarrowFusedStages = 2;"
_FUSED_EXP = "const float p = exp2f(fmaf(st[nn][2 * r + e], score_mult, bias2[r]) - l);"
_FUSED_ATOMIC = "if (row < seq) atomicAdd(reinterpret_cast<float4*>(dst + n * 8), val);"
_FUSED_DQ_COLS = ("constexpr int kFusedDqCols = kD > kMaxWholeDkvHeadDim ? 64 : "
                  "kFusedDqWidth<kD>;")
PRESETS = {
    # tile choices
    "fwd_keys128": {"kFwdKeys = 64;": "kFwdKeys = 128;"},
    "fwd_groups1": {"constexpr int kFwdGroups = 2,": "constexpr int kFwdGroups = 1,"},
    "fwd_min1": {"kFwdMinBlocks = kD >= 128 ? 1 : 2;": "kFwdMinBlocks = 1;"},
    "dq_groups1": {_DQ_GROUPS[0]: "kDqGroups = kD > kMaxWholeDkvHeadDim ? kWideDqGroups : 1;",
                   _DQ_GROUPS[1]: "kD == 128 ? 1 : 3;"},
    "dq_groups2": {_DQ_GROUPS[0]: "kDqGroups = kD > kMaxWholeDkvHeadDim ? kWideDqGroups : 2;",
                   _DQ_GROUPS[1]: "kD == 128 ? 1 : 2;"},
    "dkv_groups2": {"constexpr int kDkvGroups = 1,":
                    "constexpr int kDkvGroups = MSA_HEAD_DIM > 128 ? 1 : 2,"},
    # the split pair at 256, in place of its dq launch over a one-stage ring
    # of 32-key tiles at two CTAs an SM: two 64-key stages at one CTA an SM
    # (one warpgroup; or two on the halves of each key tile, their partial
    # dQ summed through shared memory; or two on 128 query rows over
    # 32-key tiles); and the dk/dv launch split by columns (each warpgroup
    # forming S^T and dP^T whole) in place of by role
    "dq256_straight": {_WIDE_DQ[0]: "constexpr int kWideDqGroups = 1, kWideDqRowGroups = 1, "
                                    "kWideDqKeys = 64;", _WIDE_DQ[1]: _TWO_STAGES},
    "dq256_keyhalves": {_WIDE_DQ[0]: "constexpr int kWideDqGroups = 2, kWideDqRowGroups = 1, "
                                     "kWideDqKeys = 64;", _WIDE_DQ[1]: _TWO_STAGES},
    "dq256_rows128": {_WIDE_DQ[0]: "constexpr int kWideDqGroups = 2, kWideDqRowGroups = 2, "
                                   "kWideDqKeys = 32;", _WIDE_DQ[1]: _TWO_STAGES},
    "dkv256_cols": {_WIDE_ROLE: "constexpr bool kWideDkvByRole = false;"},
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
    # the forward at head dim 256 under dropout as flash_fwd_wg_kernel (S,
    # softmax and P V in series) in place of the overlapped
    # flash_fwd_wg_overlap_kernel; and the overlapped form at rate 0 too
    # (whose products ptxas serialises)
    "fwd256_straight": {"constexpr bool kFwdOverlap = kD == 256 && kDropout;":
                        "constexpr bool kFwdOverlap = false;"},
    "fwd256_overlap_rate0": {"constexpr bool kFwdOverlap = kD == 256 && kDropout;":
                             "constexpr bool kFwdOverlap = kD == 256;"},
    # flash2's fused backward at 256 with dQ in one product of a warpgroup's
    # 128 columns (64 more registers beside dK and dV) in place of two of 64
    "fused256_dq128": {_FUSED_DQ_COLS: "constexpr int kFusedDqCols = kD > "
                                       "kMaxWholeDkvHeadDim ? 128 : kFusedDqWidth<kD>;"},
    # flash2's fused warpgroup sweep at 64 and 128: dQ added to dq32 by
    # each warpgroup's 16-byte atomics in place of the staged tile's bulk
    # tensor reductions; one warpgroup (64 keys) a CTA in place of two on
    # 128; a third ring stage at 64; dQ at 128 in two products of 32
    # columns a warpgroup in place of one of 64; and the warpgroup sweep at
    # 16 and 32 too (one warpgroup a CTA), in place of flash2_bwd_fused_kernel
    "fused_atomics": {"constexpr bool kFusedTmaDq = kD <= kMaxWholeDkvHeadDim;":
                      "constexpr bool kFusedTmaDq = false;"},
    "fused_keys64": {_FUSED_NARROW: _FUSED_NARROW.replace("KeyGroups = 2", "KeyGroups = 1")},
    "fused_stages3": {"constexpr int kFusedStages = kD > kMaxWholeDkvHeadDim ? 2 : kNarrowFusedStages;":
                      "constexpr int kFusedStages = kD < kMaxWholeDkvHeadDim ? 3 : 2;"},
    "fused128_dq32": {_FUSED_DQ_COLS: "constexpr int kFusedDqCols = kD > kMaxWholeDkvHeadDim ? 64 : "
                                      "kD == 128 ? 32 : kFusedDqWidth<kD>;"},
    "fused_wg_narrow": {"constexpr int kFusedMmaMaxDim = 32;": "constexpr int kFusedMmaMaxDim = 0;",
                        "constexpr int kFusedKeyGroups = kD > kMaxWholeDkvHeadDim ? 1 : "
                        "kNarrowFusedKeyGroups;":
                        "constexpr int kFusedKeyGroups = kD > kMaxWholeDkvHeadDim || kD < 64 ? 1 : "
                        "kNarrowFusedKeyGroups;"},
    # probes of it (outputs wrong by design): its exponentials, its dq32
    # atomics, its dQ products and atomics taken out
    "fused_no_exp": {_FUSED_EXP: "const float p = fmaf(st[nn][2 * r + e], score_mult, bias2[r]) - l;"},
    "fused_no_atomics": {_FUSED_ATOMIC: _FUSED_ATOMIC.replace("row < seq", "row < 0"),
                         "if (kTma && t > 0 && tid == 0)": "if (kTma && t < 0 && tid == 0)",
                         "      reduce_dq((n_tiles - 1) * kQ);": ""},
    "fused_no_dq": {"for (int h = 0; h < kDqW / kDqC; ++h) {": "for (int h = 0; h < 0; ++h) {",
                    "if (kTma && t > 0 && tid == 0)": "if (kTma && t < 0 && tid == 0)",
                    "      reduce_dq((n_tiles - 1) * kQ);": ""},
}

_BUILD = r"""
import subprocess, sys
sys.path.insert(0, sys.argv[1])
from msa_tpu_torch import _build
sources, kernels = json.loads(sys.argv[3]), json.loads(sys.argv[4])
secs = {}
_build.build_all(sources, seconds=secs)
lines = [f"{sys.argv[2]}: nvcc s {json.dumps({k: round(v, 1) for k, v in secs.items()})}"]
usage = [u for u in _build.resource_usage(sources)
         if any(k in u["kernel"] for k in kernels)]
names = subprocess.run(["c++filt"], input="\n".join(u["kernel"] for u in usage),
                       capture_output=True, text=True, check=True).stdout.splitlines()
for u, n in zip(usage, names):
    n = n.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
    lines.append(f"  {u['source']} {n}: {u['registers']} registers, spill "
                 f"{u['spill_stores']} B, stack {u['stack']} B, wgmma serialised: "
                 f"{'; '.join(u['serialized']) or 'no'}")
print("\n".join(lines), flush=True)
"""


def variant_tree(name, subs, kernels_file):
    """``build/variants/name``: a copy of ``msa_tpu_torch/`` and
    ``chip_smoke.py`` with each text of ``subs`` replaced in
    ``kernels_file`` wherever it occurs (none matching is an error)."""
    root = HERE / "build" / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "msa_tpu_torch", root / "msa_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", root)
    text = (root / kernels_file).read_text()
    for old, new in subs.items():
        if not text.count(old):
            raise SystemExit(f"{name}: {old!r} matches nothing")
        text = text.replace(old, new)
    (root / kernels_file).write_text(text)
    return root


def run_variants(argv, presets, kernels_file, sources, kernels, times_flag,
                 times_line):
    """The driver above for ``presets`` of substitutions in
    ``kernels_file``: ``sources`` built in every tree, ptxas printed for the
    kernels whose names hold one of ``kernels``, each tree timed by
    ``chip_smoke.py <times_flag> ROOT`` and its lines starting with
    ``times_line`` (a prefix or a tuple of them) printed.  ``argv``: [--parent ROOT] [NAME ...]."""
    script = Path(sys.argv[0]).name
    args = list(argv)
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    unknown = [n for n in args if n not in presets]
    if unknown:
        print(f"usage: {script} [--parent ROOT] [NAME ...] (NAME in "
              f"{sorted(presets)}); unknown: {unknown}", file=sys.stderr)
        return 2
    trees = {"tree": HERE}
    for name in args:
        trees[name] = variant_tree(name, presets[name], kernels_file)
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "import json\n" + _BUILD, str(root), name,
         json.dumps(sources), json.dumps(kernels)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, root in trees.items()}
    if parent is not None:  # the parent's kernels, built by its own _build
        builds["parent"] = subprocess.Popen(
            [sys.executable, "-c", "import json, sys; sys.path.insert(0, "
             "sys.argv[1]); from msa_tpu_torch import _build; "
             "_build.build_all(json.loads(sys.argv[2]))", str(parent),
             json.dumps(sources)],
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
                              times_flag, str(trees[name])],
                             capture_output=True, text=True, cwd=HERE)
        times = [line for line in run.stdout.splitlines()
                 if line.startswith(times_line)]
        if run.returncode != 0 or not times:
            raise SystemExit(f"{times_flag} {name} failed:\n{run.stdout[-3000:]}"
                             f"{run.stderr[-3000:]}")
        for line in times:
            print(f"{name}: {line}", flush=True)
    return 0


def main() -> int:
    return run_variants(sys.argv[1:], PRESETS, KERNELS,
                        ["flash2", "flash_attention", "fused_joint_embed",
                         "short_attention_d256"],
                        ["_wg_kernel", "_wg_overlap_kernel"], "--flash-times",
                        ("flash kernels", "flash at head dims", "wide heads frame step",
                         "bert-large frame step"))


if __name__ == "__main__":
    sys.exit(main())
