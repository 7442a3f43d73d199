#!/usr/bin/env python3
"""Which torch.distributed collectives the gloo backend runs on CUDA
tensors, and how long each takes, in two processes that share one card.

    python3 scripts/probe_gloo_cuda.py                # on a CUDA machine
    python3 scripts/probe_gloo_cuda.py --device cpu   # rehearsal on the CPU

Each rank tries all_reduce (SUM and MAX), broadcast, all_gather (list
form), all_gather_into_tensor, reduce_scatter and all_to_all on tensors of
`--device`, checks the result against what the collective defines, and
times the ones that run (host clock around the call, after a
synchronize, median of 20) at 4 KiB and 8 MiB of float32. Prints one JSON
line per rank; exits non-zero if a worker fails.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time


def worker(rank: int, world: int, port: int, device: str) -> dict:
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def full(n, v):
        return torch.full((n,), float(v), device=dev)

    def all_reduce_sum(n):
        t = full(n, rank + 1)
        dist.all_reduce(t)
        return bool((t == world * (world + 1) / 2).all())

    def all_reduce_max(n):
        t = full(n, rank + 1)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool((t == world).all())

    def broadcast(n):
        t = full(n, rank + 1)
        dist.broadcast(t, src=0)
        return bool((t == 1).all())

    def all_gather(n):
        parts = [full(n, 0) for _ in range(world)]
        dist.all_gather(parts, full(n, rank + 1))
        return all(bool((p == r + 1).all()) for r, p in enumerate(parts))

    def all_gather_into_tensor(n):
        out = full(n * world, 0)
        dist.all_gather_into_tensor(out, full(n, rank + 1))
        return all(bool((out[r * n:(r + 1) * n] == r + 1).all())
                   for r in range(world))

    def reduce_scatter(n):
        out = full(n, 0)
        dist.reduce_scatter(out, [full(n, rank + 1) for _ in range(world)])
        return bool((out == world * (world + 1) / 2).all())

    def all_to_all(n):
        outs = [full(n, 0) for _ in range(world)]
        dist.all_to_all(outs, [full(n, rank + 1) for _ in range(world)])
        return all(bool((o == r + 1).all()) for r, o in enumerate(outs))

    result = {"rank": rank, "device": str(dev)}
    if dev.type == "cuda":
        result["card"] = torch.cuda.get_device_name(0)
    for name, fn in (("all_reduce_sum", all_reduce_sum),
                     ("all_reduce_max", all_reduce_max),
                     ("broadcast", broadcast), ("all_gather", all_gather),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter", reduce_scatter),
                     ("all_to_all", all_to_all)):
        try:
            ok = fn(16)
        except Exception as exc:  # noqa: BLE001 - the refusal is the result
            result[name] = {"runs": False,
                            "error": f"{type(exc).__name__}: {exc}"[:300]}
            dist.barrier()
            continue
        entry = {"runs": True, "correct": ok}
        for label, n in (("4KiB", 1024), ("8MiB", 2 << 20)):
            times = []
            for _ in range(22):
                sync()
                t0 = time.perf_counter()
                fn(n)
                sync()
                times.append(time.perf_counter() - t0)
            entry[f"ms_{label}"] = statistics.median(times[2:]) * 1e3
        result[name] = entry
        dist.barrier()
    dist.destroy_process_group()
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--port", type=int, default=None)
    args = parser.parse_args()
    if args.rank is not None:
        print(json.dumps(worker(args.rank, 2, args.port, args.device)),
              flush=True)
        return 0
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--device", args.device,
         "--rank", str(r), "--port", str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    rc = 0
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                print(err[-3000:], file=sys.stderr)
                rc = 1
            else:
                print(out.strip().splitlines()[-1], flush=True)
    finally:
        for p in procs:
            p.kill()
    return rc


if __name__ == "__main__":
    sys.exit(main())
