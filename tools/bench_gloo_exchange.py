#!/usr/bin/env python3
"""Time the ways ranks of one host can exchange float32 parts over gloo,
as ``core.distributed.ordered_psum`` does: 4 ranks on a 2 x 2 ``(data,
model)`` mesh (``launch.mesh.make_lm_mesh``), each moving 1 GiB to its
``data`` peer, staged in page-locked host memory from the card.

    python3 tools/bench_gloo_exchange.py          (needs an NVIDIA GPU)

Ways, each over the same 1 GiB a rank:

- ``all_gather sync``: one blocking ``dist.all_gather`` a piece (16, 128
  and 512 MB pieces), the transport ``ordered_psum`` had before;
- ``all_gather async``: ``async_op=True``, a window of pieces in flight;
- ``isend/irecv``: each rank sends its piece to its peer and receives
  theirs (``dist.batch_isend_irecv``), a window of pieces in flight;
- ``ordered_psum``: the port's own, in its own pieces and window.

Each rank prints one JSON line, GB/s by way (bytes moved to the peer over
seconds, from a barrier to the last piece's arrival; ``ordered_psum`` also
copies the sum back to the card); the launcher prints the card, then every
rank's line. Every way is warmed up first (a custom op's first call
imports ``torch._dynamo``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RANKS, ELEMENTS = 4, 1 << 28


def _rank() -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import (host_copy, host_empty,
                                              ordered_psum)
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.launch.multiprocess import initialize_from_env

    assert initialize_from_env()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // RANKS))
    rank = dist.get_rank()
    mesh = make_lm_mesh(2, 2)
    group = mesh.group("data")
    peer = [r for r in dist.get_process_group_ranks(group) if r != rank][0]
    g = torch.randn(ELEMENTS, device="cuda")

    def gather(piece: int, window: int = 0):
        pending = []
        for at in range(0, ELEMENTS, piece):
            host = host_copy(g[at: at + piece])
            parts = [host_empty(host.shape, host) for _ in range(2)]
            work = dist.all_gather(parts, host, group=group,
                                   async_op=window > 0)
            if window:
                pending.append((work, host, parts))
                if len(pending) >= window:
                    pending.pop(0)[0].wait()
        for work, *_ in pending:
            work.wait()

    def sendrecv(piece: int, window: int):
        pending = []
        for at in range(0, ELEMENTS, piece):
            host = host_copy(g[at: at + piece])
            got = host_empty(host.shape, host)
            pending.append((dist.batch_isend_irecv([
                dist.P2POp(dist.isend, host, peer, group=group),
                dist.P2POp(dist.irecv, got, peer, group=group)]), host, got))
            if len(pending) >= window:
                for work in pending.pop(0)[0]:
                    work.wait()
        for works, *_ in pending:
            for work in works:
                work.wait()

    ways = {
        "all_gather sync 16 MB": lambda: gather(1 << 22),
        "all_gather sync 128 MB": lambda: gather(1 << 25),
        "all_gather sync 512 MB": lambda: gather(1 << 27),
        "all_gather async 128 MB, 4 in flight": lambda: gather(1 << 25, 4),
        "isend/irecv 16 MB, 16 in flight": lambda: sendrecv(1 << 22, 16),
        "isend/irecv 128 MB, 4 in flight": lambda: sendrecv(1 << 25, 4),
        "ordered_psum, 128 MB calls": lambda: [
            ordered_psum(g[at: at + (1 << 25)], mesh, "data")
            for at in range(0, ELEMENTS, 1 << 25)],
    }
    gather(1 << 25)                 # the host allocator's blocks, warm
    ordered_psum(g[: 1 << 20], mesh, "data")   # its first call's imports
    out = {"rank": rank}
    for name, fn in ways.items():
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = round(ELEMENTS * 4 / (time.perf_counter() - t0) / 1e9,
                          4)
    print(json.dumps(out), flush=True)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--rank"]:
        _rank()
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_gloo_exchange.py times transfers from an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from repro_torch.launch.multiprocess import spawn_local_cluster
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for out in spawn_local_cluster([sys.executable, __file__, "--rank"],
                                   RANKS, timeout=600):
        print(out.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
