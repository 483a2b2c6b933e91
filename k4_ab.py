"""K4 (the training flash attention) on the card, one tree at a time: its
gates and device times at the four cases of PERF.md §6 (the train
phase's shapes, the long case, qwen3-30b-a3b's rep 8 layout, a packed
batch of ppo-like rows), optionally on a named variant of its sources and
with the train phase's gradient-gate sweep.

It drives the ``chip_smoke.py`` beside it, and that smoke's
``polyrl_tpu_torch``. Run it from the root of the tree to measure, on one
card; to measure another commit, unpack it by ``git archive`` into a
git-ignored directory, copy this file beside its ``chip_smoke.py`` and run
it there::

    python3 k4_ab.py --tag change
    python3 k4_ab.py --tag one-term --variant one_term --grad-seeds 0,1,2
    cp k4_ab.py parent_tree/ && (cd parent_tree && python3 k4_ab.py --tag parent)

Compare two trees only inside one call, in turns (parent, change, change,
parent). Prints the smoke's K4 lines (``kernel flash_attention ...``) and
a ``GATE FAILED`` line for each gate that fails; the run goes on. A
variant copies the tree's ``csrc/`` under its build directory, applies
the named edit and builds from the copy:

- ``one_term``: P and dS go to their products as one bf16 term, not two;
- ``mask_every_tile``: the bf16 kernels build the per-element mask on
  every tile pair, uniform ones too, and OR in the uniform flag (the same
  result, without the branch that skips the work).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import time

_MASK = (re.compile(r"uint32_t ok = 0xffffffffu;([^\n]*)\n(\s*)if \(!tile_is_uniform\("
                    r"qr, kr, qt, kt, T_, causal\)\)\n(\s*)ok = visible_bits\("),
         r"uint32_t ok = tile_is_uniform(qr, kr, qt, kt, T_, causal) ? 0xffffffffu : 0u;"
         r"\1\n\3ok |= visible_bits(")

# variant -> [(file in csrc/, pattern, replacement, matches it must make)]
VARIANTS = {
    "one_term": [("flash_wgmma.cuh",
                  re.compile(re.escape("    mma_rs(acc, lo[kk], desc_mn(b, kk));\n")), "", 1)],
    "mask_every_tile": [("flash_attention_fwd.cu", *_MASK, 1),
                        ("flash_attention_bwd.cu", *_MASK, 2)],
}


def use_variant(cuda_build, name: str) -> None:
    """Point ``cuda_build`` at a copy of the sources with edit ``name``."""
    root = cuda_build.BUILD_DIR / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, root / "csrc")
    for fname, pattern, repl, count in VARIANTS[name]:
        path = root / "csrc" / fname
        text, n = pattern.subn(repl, path.read_text())
        if n != count:
            raise SystemExit(f"variant {name}: {n} edits in {fname}, not {count}")
        path.write_text(text)
    cuda_build.CSRC_DIR = root / "csrc"
    cuda_build.BUILD_DIR = root / "build"


def ppo_like_ids(np):
    """4 rows of 1024 ids: trajectories of 150-450 tokens while they fit
    under 1000, then pads (id 0); about a quarter of the causal pairs
    visible, as in the ppo phase's packs."""
    rng = np.random.default_rng(3)
    seg = np.zeros((4, 1024), np.int32)
    for r in range(4):
        pos, sid = 0, 1
        while True:
            n = int(rng.integers(150, 450))
            if pos + n > 1000:
                break
            seg[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", required=True, help="label of this tree in the output")
    ap.add_argument("--variant", choices=sorted(VARIANTS), default=None)
    ap.add_argument("--grad-seeds", default="",
                    help="comma-separated trainer.seed values for the train "
                         "phase's gradient-gate sweep (chip_smoke --grad-seeds)")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("k4_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    if args.variant:
        use_variant(cs.cuda_build, args.variant)
    tree = os.path.dirname(os.path.abspath(cs.__file__))
    print(f"[{args.tag}] {smi}; variant {args.variant}; tree {tree}", flush=True)
    t0 = time.monotonic()
    cs.cuda_build.build(list(cs.K4_NAMES))
    print(f"[{args.tag}] build {time.monotonic() - t0:.1f} s", flush=True)
    for name in cs.K4_NAMES:
        for r in cs.cuda_build.ptxas_report(name):
            print(f"[{args.tag}] build {r}", flush=True)

    def gated(fn):
        try:
            fn()
        except cs.SmokeFailure as e:
            print(f"[{args.tag}] GATE FAILED: {e}", flush=True)

    gated(lambda: cs.check_flash(dev))
    with cs.head_layout(cs.MOE_HQ, cs.MOE_HKV, cs.MOE_MODEL):
        gated(lambda: cs.flash_case_check(dev, 4, 512, 7, "moe layout, train phase shapes",
                                          reps=10, repeat=True))
    gated(lambda: cs.flash_case_check(dev, 4, 1024, 9, "ppo-like packed rows", reps=5,
                                      seg_np=ppo_like_ids(np)))
    if args.grad_seeds:
        cs.grad_gate_sweep(dev, [int(x) for x in args.grad_seeds.split(",")])
    print(f"[{args.tag}] done {time.monotonic() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
