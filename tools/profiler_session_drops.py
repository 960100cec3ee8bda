"""How many kernel events a torch.profiler session keeps once other
processes have used the card. One process runs a bf16 dense K1 call (C 512,
4 heads, B=2, T=2304: three launches) three times a session and counts the
session's device-side events (9 when none is lost): fresh, after
``--children`` short processes that each make a CUDA context, and after
that with an idle gap at the session's start. ``--env`` sets a CUPTI
variable before torch is imported (TEARDOWN_CUPTI=0,
DISABLE_CUPTI_LAZY_REINIT=1). Needs one card.

    python3 tools/profiler_session_drops.py [--children 4] [--env NAME=VALUE]

Prints one JSON line: the torch and CUDA versions, the card, and the count
of each session."""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--children", type=int, default=4)
    ap.add_argument("--env", action="append", default=[], help="NAME=VALUE, set before torch")
    args = ap.parse_args(argv)
    for kv in args.env:
        name, value = kv.split("=", 1)
        os.environ[name] = value
    sys.path.insert(0, REPO)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c

    x, xo, mask, packed = c.block_case("self", 2304, -1, 2, torch.bfloat16, "cuda", 512, c=512,
                                       n_head=4)
    log = []

    def run():
        return c.run_block("kernel", x, xo, mask, packed, "self", -1, 4)

    def session(label, gap=0.0):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if gap:
                time.sleep(gap)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
        log.append((label, sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)))

    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        session("fresh")
        for _ in range(args.children):
            subprocess.run([sys.executable, "-c", "import torch; torch.zeros(1, device='cuda'); "
                            "torch.cuda.synchronize()"], check=True)
        session(f"after {args.children} other processes")
        session("gap 10 ms", 0.01)
        session("gap 100 ms", 0.1)
        session("again")
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          card=torch.cuda.get_device_name(0), env=args.env, expected=9,
                          sessions=log)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
