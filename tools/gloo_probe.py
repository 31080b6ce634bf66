"""Which gloo collectives take CUDA tensors, and how fast gloo moves them.

    python3 tools/gloo_probe.py

Card only. Each collective runs in its own spawn of two gloo ranks that
share the card (``repro_torch.launch.mesh.run_peers``), first on CUDA
tensors and then on host tensors, because a call gloo cannot serve on a
CUDA tensor may abort the rank rather than raise; such a call shows as
the ``PeerError`` that ``run_peers`` raises. Then ``all_reduce`` and
``broadcast`` of 16 MiB, 256 MiB and 1 GiB of f32 on the card, three
timed calls each (host clock around synchronised calls, after a
barrier). Every figure is gloo through host memory, not NVLink or NCCL.
"""
import json
import os
import sys
import time

import torch
import torch.distributed as dist

OPS = ("broadcast", "all_reduce_f32", "all_reduce_i32", "all_gather",
       "all_to_all_single", "batch_isend_irecv")


def _op(rank, name, kind):
    """One collective on ``kind`` tensors; returns what this rank got."""
    d = torch.device("cuda", 0) if kind == "cuda" else torch.device("cpu")
    world = dist.get_world_size()
    if name == "broadcast":
        x = torch.full((1024,), float(rank + 1), device=d)
        dist.broadcast(x, src=1)
        return float(x[0])
    if name in ("all_reduce_f32", "all_reduce_i32"):
        dt = torch.float32 if name.endswith("f32") else torch.int32
        x = torch.full((1024,), rank + 1, dtype=dt, device=d)
        dist.all_reduce(x)
        return float(x[0])
    if name == "all_gather":
        out = [torch.empty(4, device=d) for _ in range(world)]
        dist.all_gather(out, torch.full((4,), float(rank), device=d))
        return [float(t[0]) for t in out]
    if name == "all_to_all_single":
        out = torch.empty(4 * world, device=d)
        dist.all_to_all_single(out, torch.arange(
            4 * world, dtype=torch.float32, device=d) + 10 * rank)
        return out.tolist()
    buf = torch.empty(4, device=d)
    ops = [dist.P2POp(dist.isend, torch.full((4,), float(rank), device=d),
                      (rank + 1) % world),
           dist.P2POp(dist.irecv, buf, (rank - 1) % world)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return float(buf[0])


def _timing(rank):
    out = {}
    for mib in (16, 256, 1024):
        z = torch.ones(mib << 18, device="cuda")
        for name, fn in (("all_reduce", lambda: dist.all_reduce(z)),
                         ("broadcast", lambda: dist.broadcast(z, src=0))):
            ms = []
            for _ in range(3):
                dist.barrier()
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append(round((time.perf_counter() - t) * 1e3, 3))
            out[f"{name} {mib} MiB ms"] = ms
        del z
    return out


def main():
    if not torch.cuda.is_available():
        print("gloo_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.launch.mesh import PeerError, run_peers
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    table = {}
    for kind in ("cuda", "cpu"):
        for name in OPS:
            try:
                got = run_peers(_op, 2, device="cuda", timeout_s=60,
                                args=(name, kind))
                table[f"{kind} {name}"] = f"ok {got}"
            except PeerError as e:
                table[f"{kind} {name}"] = "fails: " + str(e).splitlines()[0]
            print(f"[gloo {kind}] {name}: {table[f'{kind} {name}']}",
                  flush=True)
    times = run_peers(_timing, 2, device="cuda", timeout_s=300)[0]
    print("[gloo timing] " + json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
