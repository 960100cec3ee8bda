"""Why K7's bf16 route past its tiled kernel takes the plain version's steps
in order (CPU only, no card).

A tensor-core attention in the manner of K1's (``csrc/fused_block_attend.cu``)
rounds each score to bf16 as the plain version does, but keeps the softmax
in f32 and sums the context P.V in f32, rounding once at the end.
``band_attention_plain`` rounds the running sum of the exps and the running
context to bf16 after every offset. This script renders the f32-context
attention in torch and holds it against the plain version under
``chip_smoke.check_k7``'s bf16 rule (atol = rtol = 2e-2 per element, and no
further than 1.5x the plain version from the f32 function), at each
``chip_smoke.DOMAIN_K7`` shape and ``DOMAIN_K7_W`` half window with
``chip_smoke.k7_case``'s inputs (seeds t + w and w). Per case it prints the
elements past the per-element bound, the largest distance from the plain
version, and each one's largest distance from the f32 function.
``--small`` runs (5, 1, 150, 512) alone (seconds).

    python3 tools/k7_bf16_order.py [--small]
"""

import argparse
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from audio_visual_deepfake_detection_tpu_torch.ops.attention import NEG_PENALTY  # noqa: E402


def f32_context(q, k, v, valid, w):
    """Banded attention with bf16 scores (exact products summed in f32,
    rounded; the penalty added in bf16 on masked keys), an f32 softmax, p
    rounded to bf16 and the context summed in f32, rounded once; rows whose
    own key is masked zero. q, k, v: (B, H, T, D) bf16; valid (B, T)."""
    bf = torch.bfloat16
    t = q.shape[2]
    w = min(w, t - 1)
    rows = torch.arange(t)
    scores, keys = [], []
    for o in range(-w, w + 1):
        at = (rows + o).clamp(0, t - 1)
        s = (q.float() * k[:, :, at].float()).sum(-1).to(bf)
        s = torch.where(valid[:, at][:, None], s, s + torch.tensor(NEG_PENALTY, dtype=bf))
        inseq = (rows + o >= 0) & (rows + o < t)
        scores.append(torch.where(inseq, s.float(), -math.inf))
        keys.append(at)
    s = torch.stack(scores)                                   # (2w + 1, B, H, T)
    e = torch.exp(s - s.amax(0))
    p = (e * (1.0 / e.sum(0))).to(bf).float()
    acc = torch.zeros(q.shape)
    for i, at in enumerate(keys):
        acc += p[i][..., None] * v[:, :, at].float()
    return (acc * valid[:, None, :, None]).to(bf)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="only (5, 1, 150, 512)")
    args = ap.parse_args()
    torch.set_num_threads(min(4, torch.get_num_threads()))
    shapes = [s for s in c.DOMAIN_K7 if not args.small or s[2] <= 150]
    for bb, h, t, d in shapes:
        for w in c.DOMAIN_K7_W:
            for seed in (t + w, w):
                q, k, v, valid = c.k7_case(bb, t, torch.bfloat16, "cpu", seed=seed, h=h, d=d)
                with torch.no_grad():
                    ref = c.run_k7("plain", q, k, v, valid, w)
                    exact = c.run_k7("plain", q.float(), k.float(), v.float(), valid, w)
                    got = f32_context(q, k, v, valid, w)
                err, ok, rule = c.check_k7(got, ref, q, k, v, valid, w)
                far = lambda x: (x.float() - exact).abs().max().item()  # noqa: E731
                print(f"({bb}, {h}, {t}, {d}) w={w} seed={seed}: check_k7 "
                      f"{'passes' if ok else 'FAILS'} ({rule.split(';')[0]}), max |d| from "
                      f"plain {err:.3e}; from f32: f32 context {far(got):.3e}, plain "
                      f"{far(ref):.3e}", flush=True)


if __name__ == "__main__":
    main()
