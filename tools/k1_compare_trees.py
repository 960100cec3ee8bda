"""The production K1 in two source trees on one card: the 18 blocks of one
localizer forward (``chip_smoke.PROD_BLOCKS``), bf16, device ms (each block
replayed as a CUDA graph, ``chip_smoke.device_ms``), summed, at B = 16, 64
and 512; the trees in turns a, b, b, a, each in a process of its own that
builds its own kernel library under its ``build/kernels/``.

    python3 tools/k1_compare_trees.py PARENT_TREE CHANGED_TREE [--out FILE]

A tree is a checkout of the repository (``git archive`` of a commit unpacked
into a folder). Prints each run and the mean of each tree with the change in
percent; ``--out`` writes them as JSON. Needs one card."""

import argparse
import json
import os
import subprocess
import sys

BATCHES = (16, 64, 512)

RUN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c
smi = c.phase_build()
out = {"card": smi}
for b in %r:
    total = 0.0
    for names, mode, t, window in c.PROD_BLOCKS:
        x, xo, mask, packed = c.block_case(mode, t, window, b, torch.bfloat16, "cuda", seed=t)
        with torch.no_grad():
            total += len(names) * c.device_ms(
                lambda: c.run_block("kernel", x, xo, mask, packed, mode, window))
        del x, xo, mask, packed
    out[str(b)] = total
print("RESULT " + json.dumps(out))
""" % (BATCHES,)


def run_tree(tree):
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                         f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="the first tree (the parent)")
    ap.add_argument("b", help="the second tree (the change)")
    ap.add_argument("--out", help="JSON file for the runs and means")
    args = ap.parse_args(argv)
    runs = []
    for name in ("a", "b", "b", "a"):
        tree = os.path.abspath(getattr(args, name))
        res = run_tree(tree)
        runs.append(dict(tree=name, path=tree, **res))
        print(f"{name} {' '.join(f'B={b} {res[str(b)]:.3f} ms' for b in BATCHES)} ({res['card']})",
              flush=True)
    means = {name: {str(b): sum(r[str(b)] for r in runs if r["tree"] == name) / 2
                    for b in BATCHES} for name in ("a", "b")}
    change = {str(b): 100.0 * (means["b"][str(b)] / means["a"][str(b)] - 1.0) for b in BATCHES}
    print("mean a " + " ".join(f"B={b} {means['a'][str(b)]:.3f}" for b in BATCHES))
    print("mean b " + " ".join(f"B={b} {means['b'][str(b)]:.3f}" for b in BATCHES))
    print("b vs a " + " ".join(f"B={b} {change[str(b)]:+.2f}%" for b in BATCHES))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(runs=runs, means=means, change_percent=change), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
