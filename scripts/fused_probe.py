#!/usr/bin/env python3
"""Hold flash2's fused backward (row 11) against its rounded rule at every
head dim and time it, for this tree, the parent and presets of the fused
sweep.

    python3 scripts/fused_probe.py [--parent ROOT] [NAME ...]

Each NAME is a preset of ``scripts/flash_variants.py`` (text substitutions
in ``msa_tpu_torch/csrc/flash_kernels.cuh``), copied into
``build/variants/NAME`` (git-ignored).  Every tree builds its flash2
libraries concurrently (its own ``build/``); then, one tree at a time, a
process of its own prints ptxas's registers, spills and wgmma notices for
its fused sweeps and runs ``chip_smoke.check_flash2_backward`` (both routes
against JAX's rounded rule, f32 autograd and each other) at head dims 64,
32, 16, 128, 256 and 26, bf16, at [32,1024,H] (rate 0 and 26/256, both
routes timed beside SDPA's backward) and at [2,S,H] for S = 1024, 1000,
2048, 70 and 129; a preset whose name holds ``_no_`` is a probe (its
output wrong by design) and is only timed.  Last, the device ms a call of
both routes by kernel at d = 64.  A tree's full output goes to
``build/fused_probe/NAME.log``.  Needs nvcc and a card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE / "scripts"))

import flash_variants  # noqa: E402

# (H, heads): head dims 64, 32, 16, 128, 256 and 26 (padded onto 32)
WIDTHS = ((1024, 16), (64, 2), (128, 8), (1024, 8), (1024, 4), (312, 12))
# (B, S, rate on): [32, 1024] is timed
CASES = ((32, 1024, False), (32, 1024, True), (2, 1024, True), (2, 1000, False),
         (2, 1000, True), (2, 2048, False), (2, 2048, True), (2, 70, False),
         (2, 129, True))


def probe(root: str, check: bool) -> int:
    """The checks and times of the tree at ``root`` (on sys.path first)."""
    sys.path.insert(0, root)
    import re

    import torch

    import chip_smoke as cs
    from msa_tpu_torch import _build
    from msa_tpu_torch.ops import flash2 as F2
    from msa_tpu_torch.ops.dropout import keep_mask_plain

    for u in _build.resource_usage(["flash2"]):
        m = re.search(r"(flash2_bwd_fused\w*_kernel)I", u["kernel"])
        if m:
            print(f"ptxas {u['library']} {m.group(1)}<"
                  f"{','.join(cs.template_args(u['kernel'], m))}>: "
                  f"{u['registers']} regs, stack {u['stack']}, spill "
                  f"{u['spill_stores']}/{u['spill_loads']}, serialised "
                  f"{u['serialized'] or 'no'}", flush=True)
    failed = []
    for hidden, heads in WIDTHS:
        d = hidden // heads
        try:
            with cs.head_widths(hidden, heads):
                gen = torch.Generator(device="cuda").manual_seed(14)
                for b, s, on in CASES:
                    rate = cs.phase_rate() if on else 0.0
                    q, k, v, bias, live = cs.attention_inputs(gen, b, s, torch.bfloat16)
                    dout = torch.randn(b, s, hidden, device="cuda",
                                       generator=gen).to(torch.bfloat16)
                    seed = 4321 + s
                    if not check and b != 32:
                        continue
                    line = f"d={d} [{b},{s},{hidden}] rate {rate:g}"
                    if check:
                        keep = (keep_mask_plain(seed, rate, b, heads, s, device="cuda")
                                if rate else None)
                        errs, _, between, o32, lse = cs.check_flash2_backward(
                            f"probe {line}", q, k, v, bias, live, dout, seed, rate, keep)
                        line += (f": fused {errs[True]:.3e} split {errs[False]:.3e} "
                                 f"vs {between:.3e}")
                    else:
                        _, lse, o32 = F2._forward_kernel(q, k, v, bias, heads, seed, rate,
                                                         True)
                    if b == 32:
                        ms = {f: cs.cuda_ms(lambda f=f: F2.flash_attention2_backward(
                            q, k, v, bias, o32, lse, dout, heads, seed, rate, fused=f),
                            iters=10) for f in (True, False)}
                        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
                        sp = lambda x: x.view(b, s, heads, -1).transpose(1, 2)  # noqa: E731
                        out = torch.nn.functional.scaled_dot_product_attention(
                            sp(qq), sp(kk), sp(vv),
                            attn_mask=bias[:, None, None, :].to(torch.bfloat16))
                        lib = cs.cuda_ms(lambda: torch.autograd.grad(
                            out, (qq, kk, vv), sp(dout), retain_graph=True), iters=10)
                        line += (f"; ms fused {ms[True]:.4f} split {ms[False]:.4f} "
                                 f"sdpa {lib:.4f}")
                    print(line, flush=True)
        except AssertionError as e:
            failed.append(d)
            print(f"FAILED d={d}: {str(e)[:2000]}", flush=True)
    with cs.head_widths(1024, 16):
        gen = torch.Generator(device="cuda").manual_seed(3)
        q, k, v, bias, _ = cs.attention_inputs(gen, 32, 1024, torch.bfloat16)
        dout = torch.randn(32, 1024, 1024, device="cuda", generator=gen).to(torch.bfloat16)
        _, lse, o32 = F2._forward_kernel(q, k, v, bias, 16, 0, 0.0, True)
        for fused in (True, False):
            parts = cs.device_ms_by_kernel(lambda: F2.flash_attention2_backward(
                q, k, v, bias, o32, lse, dout, 16, 0, 0.0, fused=fused))
            print(f"by kernel ms {'fused' if fused else 'split'}: {parts}", flush=True)
    print("FAILED" if failed else "ALL OK", failed, flush=True)
    return 1 if failed else 0


def main(argv) -> int:
    if argv[:1] == ["--child"]:  # --child ROOT [--no-check]
        return probe(argv[1], "--no-check" not in argv)
    trees = {"tree": HERE}
    if argv[:1] == ["--parent"]:
        trees["parent"], argv = Path(argv[1]).resolve(), argv[2:]
    unknown = [n for n in argv if n not in flash_variants.PRESETS]
    if unknown:
        print(f"usage: fused_probe.py [--parent ROOT] [NAME ...] (NAME in "
              f"{sorted(flash_variants.PRESETS)}); unknown: {unknown}", file=sys.stderr)
        return 2
    for name in argv:
        trees[name] = flash_variants.variant_tree(name, flash_variants.PRESETS[name],
                                                  flash_variants.KERNELS)
    t0 = time.perf_counter()
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from msa_tpu_torch import _build; _build.build_all(['flash2'])", str(root)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, root in trees.items()}
    for name, proc in builds.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"build of {name} failed:\n{out[-6000:]}")
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    logs = HERE / "build" / "fused_probe"
    logs.mkdir(parents=True, exist_ok=True)
    rc = 0
    for name, root in trees.items():
        print(f"===== {name}", flush=True)
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", str(root)]
            + (["--no-check"] if "_no_" in name else []),
            capture_output=True, text=True, cwd=HERE)
        (logs / f"{name}.log").write_text(run.stdout + run.stderr)
        print("\n".join(line for line in run.stdout.splitlines()
                        if line.startswith(("ptxas", "FAILED", "ALL OK", "by kernel"))
                        or " ms " in line), flush=True)
        if run.returncode != 0:
            print(run.stderr[-3000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
