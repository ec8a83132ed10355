#!/usr/bin/env python3
"""nvcc's wall time for each CUDA library of msa_tpu_torch (an attention
source once a head dim), and what ptxas reports (registers, stack frame,
spills, and any notice that it serialised a kernel's wgmma products) for
each kernel of the sources named, for the checkout at ROOT (default: this
one).  ``flash2 flash_attention`` lists
the warpgroup kernels of rows 10, 12 and 13 (flash_fwd_wg_kernel,
flash_bwd_dq_wg_kernel, flash_bwd_dkv_wg_kernel) beside the f32 kernels
and row 11's fused sweep.

    python3 scripts/build_report.py [ROOT] [SOURCE ...]

The sources are compiled by this checkout's ``msa_tpu_torch._build`` (its
flags; one nvcc a library, all started together, as ``chip_smoke.py``'s
build) into a temporary directory that is thrown away, so two trees are
compared by the same build when it is run once for each.  Prints one JSON
object {library: seconds}, then one line a kernel.  Needs nvcc (the CUDA
toolkit), not a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(HERE))
    from msa_tpu_torch import _build

    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    _build.CSRC = root / "msa_tpu_torch" / "csrc"
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        _build.BUILD_DIR = Path(tmp)
        _build.build_all(seconds=seconds)
        print(json.dumps({name: round(s, 1) for name, s in seconds.items()}),
              flush=True)
        usage = _build.resource_usage(sys.argv[2:])  # the build's reports
    names = subprocess.run(["c++filt"], input="\n".join(
        u["kernel"] for u in usage), capture_output=True, text=True,
        check=True).stdout.splitlines()
    for u, name in zip(usage, names):
        name = name.replace("(anonymous namespace)::", "").split("(")[0]
        serial = u["serialized"]
        print(f"{u['source']} {name}: {u['registers']} registers, stack "
              f"{u['stack']} B, spill stores {u['spill_stores']} B, loads "
              f"{u['spill_loads']} B"
              f"{', wgmma serialised: ' + '; '.join(serial) if serial else ''}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
