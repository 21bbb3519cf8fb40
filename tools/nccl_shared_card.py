#!/usr/bin/env python3
"""What NCCL does with two ranks on one card.

    python3 tools/nccl_shared_card.py

Starts two processes that join one NCCL group (FileStore rendezvous under
build/), both on cuda:0, and all-reduce one tensor; NCCL_DEBUG=WARN.  Each
rank's exit code and the tail of its output are printed as one JSON line.
A rank that has not finished within TIMEOUT_S is killed.  This is why
bfqzip_tpu_torch.parallel never puts two NCCL ranks on one card: ranks that
share a card take a gloo group (parallel/comm.py stages its collectives
through the host).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

RANK = """
import datetime, sys, torch, torch.distributed as dist
rank, path = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("nccl", store=dist.FileStore(path, 2), rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
x = torch.ones(4, device="cuda:0")
dist.all_reduce(x)
torch.cuda.synchronize()
print("all_reduce gave", x.tolist(), flush=True)
dist.destroy_process_group()
"""


def main() -> int:
    work = os.path.join(ROOT, "build", "nccl_probe")
    os.makedirs(work, exist_ok=True)
    store = os.path.join(work, f"store_{os.getpid()}")
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), store], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    deadline = time.monotonic() + TIMEOUT_S
    ranks = []
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
            timed_out = False
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
            timed_out = True
        lines = [ln for ln in out.splitlines() if ln.strip()]
        ranks.append({"rank": r, "rc": p.returncode, "timed_out": timed_out,
                      "tail": lines[-12:]})
    if os.path.exists(store):
        os.remove(store)
    print(json.dumps({"probe": "nccl_two_ranks_one_card", "ranks": ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
