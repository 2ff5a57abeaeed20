"""Phases of ``chip_smoke.py``, one checkout against another, on the
card.

    python3 paddle_tpu_torch/tools/chip_ab.py [--phases P,...] ROOT [ROOT ...]

Each ROOT is a checkout of this repo (for an A/B on one card: parent,
change, change, parent).  For each, in the order given and in a process
of its own that imports that ROOT's ``chip_smoke`` and
``paddle_tpu_torch`` (and fails if it imported another's), it runs the
phases named in ``--phases`` (default ``decode``), in this order:

- ``ctr``: phase 3's embedding kernels (``phase_kernels_ctr``: the
  gather-pool forward and the scatter-add gradient, checked and timed);
- ``dropout``: phase 3e (``phase_kernels_dropout``: the five dropout
  kernels, checked and timed);
- ``momentum``: phase 3's fused Momentum (``phase_kernels_momentum``:
  the CTR bucket's op checked against the per-param lowering, the
  kernel, the op and the library call timed), then the CTR path served
  and trained (phases 4c and 4d: launches, step ms, peak device memory)
  and phase 5's CTR profile (device busy ms by kernel class);
- ``decode``: the ``paged_attention`` wrapper's host cost per call at
  the decode step's shapes (pools of 16,400 rows of 768, 512 positions a
  slot, 300 valid; 1, 8 and 32 slots): the seconds to enqueue 200 calls
  with no sync among them, over 200, beside the wall seconds per call
  once the card has finished; then phase 4f (the decode path served,
  with its checks) and phase 5's decode profile (host and device ms of
  one paged step at 1, 8 and 32 slots).

Each tree builds the kernels its phases launch from its own sources.
Prints the card's name and power limit; exits non-zero if a ROOT's run
fails.
"""

import os
import subprocess
import sys
import time

CALLS = 200


def _wrapper_host_us(card):
    import torch
    from paddle_tpu_torch.ops import cuda_kernels

    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(0)
    d, s, ps, rows = 768, 512, 16, 16400
    kp, vp = (torch.randn(rows, d, generator=g).to(dev) for _ in range(2))
    for b in (1, 8, 32):
        q = torch.randn(b, d, generator=g).to(dev)
        pages = torch.randperm(rows // ps - 1, generator=g)[:b * s // ps] + 1
        idx = ((pages.reshape(b, s // ps, 1) * ps + torch.arange(ps))
               .reshape(b, s).int().to(dev))
        valid = (torch.arange(s) < 300).float().expand(b, s).contiguous()
        valid = valid.to(dev)

        def call():
            return cuda_kernels.paged_attention(q, kp, vp, idx, valid,
                                                d ** -0.5, 1e30)

        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"paged_attention wrapper, {b} slots: host "
              f"{(t1 - t0) / CALLS * 1e6:.2f} us a call to enqueue, wall "
              f"{(t2 - t0) / CALLS * 1e6:.2f} us a call  [{card}]",
              flush=True)


PHASES = ("ctr", "dropout", "momentum", "decode")


def _child(root, phases):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke
    import paddle_tpu_torch

    for mod in (chip_smoke, paddle_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise SystemExit(f"chip_ab: imported {mod.__file__}, "
                             f"not {root}'s")
    print(f"== {root}", flush=True)
    _, _, card = chip_smoke.phase_device()
    if "ctr" in phases:
        chip_smoke.phase_kernels_ctr()
    if "dropout" in phases:
        chip_smoke.phase_kernels_dropout()
    if "momentum" in phases:
        chip_smoke.phase_kernels_momentum()
        _, arrays, served = chip_smoke.phase_serve_ctr(card)
        _, trained = chip_smoke.phase_train_ctr(arrays, card)
        del arrays
        chip_smoke.phase_profile_ctr(served, trained, card)
    if "decode" in phases:
        _wrapper_host_us(card)
        _, served = chip_smoke.phase_serve_decode(card)
        chip_smoke.phase_profile_decode(served, card)


def main(argv):
    if len(argv) >= 3 and argv[0] == "--child":
        _child(argv[1], argv[2].split(","))
        return 0
    phases = "decode"
    if argv[:1] == ["--phases"] and len(argv) >= 2:
        phases, argv = argv[1], argv[2:]
    unknown = set(phases.split(",")) - set(PHASES)
    if not argv or unknown:
        raise SystemExit(__doc__ + (f"\nunknown phases: {sorted(unknown)}"
                                    if unknown else ""))
    for root in map(os.path.abspath, argv):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--child", root, phases], cwd=root, timeout=900
                            ).returncode
        if rc:
            print(f"chip_ab: {root} exited {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
