"""Multi-process bring-up for the ring of ranks (``torch.distributed``).

Three small layers, in the order a run uses them:

1. **Spawn**: ``spawn_local_cluster`` runs N copies of an argv as a local
   cluster, each with the coordinator, the world size and its rank in its
   environment (``local_cluster_env``). A rank that exits non-zero ends the
   others and makes the caller raise.
2. **Init**: inside each process, ``initialize_from_env`` (or the explicit
   ``initialize_process``) joins the default process group over ``gloo``.
3. **Place**: ``put_global`` / ``put_global_tree`` take this rank's block
   of rows of a global array (the rank's mules), ``gather_global`` puts
   the blocks of every rank back together in rank order, and
   ``host_replicated`` reads a value every rank holds the same.

The coordinator is ``host:port`` (``pick_free_port`` finds a port) or a
``file://`` path, a ``FileStore`` that needs no port at all. Gloo carries
the ring's CPU and CUDA tensors alike; the ranks use it on the card too,
since NCCL refuses two ranks on one device. A 1-process "cluster" needs no
process group: a one-rank ring makes no collective.
"""
from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

ENV_COORDINATOR = "REPRO_MP_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_MP_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_MP_PROCESS_ID"


def pick_free_port(host: str = "127.0.0.1") -> int:
    """Bind-then-release a port for the coordinator of a local cluster."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def local_cluster_env(process_id: int, num_processes: int, coordinator: str,
                      base_env: Optional[Dict[str, str]] = None
                      ) -> Dict[str, str]:
    """Environment for one process of a local cluster: the coordinator,
    world size and rank ride on ``REPRO_MP_*`` variables that
    ``initialize_from_env`` reads inside the child."""
    env = dict(os.environ if base_env is None else base_env)
    env[ENV_COORDINATOR] = coordinator
    env[ENV_NUM_PROCESSES] = str(num_processes)
    env[ENV_PROCESS_ID] = str(process_id)
    return env


def _init_method(coordinator: str) -> str:
    if coordinator.startswith(("tcp://", "file://")):
        return coordinator
    return f"tcp://{coordinator}"


def initialize_process(coordinator_address: str, num_processes: int,
                       process_id: int) -> None:
    """Join the default process group over gloo. Idempotent; a 1-process
    cluster skips it."""
    if num_processes <= 1 or dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method=_init_method(
        coordinator_address), world_size=num_processes, rank=process_id)


def initialize_from_env(env=None) -> bool:
    """Init from ``REPRO_MP_*`` variables; returns True when they were set.

    The hook every spawned entry point calls first: parents launch children
    through ``spawn_local_cluster`` and the child picks the triple up here.
    """
    env = os.environ if env is None else env
    coord = env.get(ENV_COORDINATOR)
    if not coord:
        return False
    initialize_process(coord, int(env[ENV_NUM_PROCESSES]),
                       int(env[ENV_PROCESS_ID]))
    return True


def spawn_local_cluster(argv: Sequence[str], num_processes: int, *,
                        coordinator: Optional[str] = None,
                        base_env: Optional[Dict[str, str]] = None,
                        timeout: Optional[float] = None,
                        ) -> List[subprocess.CompletedProcess]:
    """Run ``argv`` as an N-process local cluster; one result per rank,
    with its output (stdout and stderr) as text.

    All ranks start together (a process group waits for every rank). If a
    rank exits non-zero, or the timeout passes, every rank still running
    is killed and this raises ``RuntimeError`` with the output of the rank
    at fault.
    """
    coord = coordinator or f"127.0.0.1:{pick_free_port()}"
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(num_processes)]
    procs = [subprocess.Popen(
        list(argv), env=local_cluster_env(pid, num_processes, coord, base_env),
        stdout=logs[pid], stderr=subprocess.STDOUT, text=True)
        for pid in range(num_processes)]

    def output(pid: int) -> str:
        logs[pid].seek(0)
        return logs[pid].read()

    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [pid for pid, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                pid = bad[0]
                raise RuntimeError(f"rank {pid} of {num_processes} exited "
                                   f"with {codes[pid]}:\n{output(pid)}")
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"the {num_processes}-rank cluster did "
                                   f"not finish within {timeout} s; exit "
                                   f"codes {codes}")
            time.sleep(0.05)
        return [subprocess.CompletedProcess(list(argv), p.returncode,
                                            stdout=output(pid), stderr=None)
                for pid, p in enumerate(procs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


# ---------------------------------------------------------------------------
# per-rank data placement
# ---------------------------------------------------------------------------


def _blocks(mesh, axis_name: Optional[str]):
    name = axis_name or mesh.data_axis
    return mesh.shape[name], mesh.coords[name], mesh.group(name)


def put_global(x: torch.Tensor, mesh, axis: int = 0,
               axis_name: Optional[str] = None) -> torch.Tensor:
    """This rank's block of ``x`` along ``axis``: the mesh's data axis (or
    ``axis_name``) cuts ``x`` into equal blocks, and the rank at index
    ``j`` of that axis keeps block ``j``. ``x`` must divide evenly."""
    n, j, _ = _blocks(mesh, axis_name)
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"{size} rows along axis {axis} do not divide "
                         f"into {n} blocks")
    step = size // n
    return x.narrow(axis, j * step, step)


def put_global_tree(tree: Any, mesh, axes: Any,
                    axis_name: Optional[str] = None) -> Any:
    """``put_global`` over nested dicts / tuples of tensors. ``axes`` is an
    int (the axis of every tensor below), ``None`` (kept whole on every
    rank), or a dict of those for a dict's entries."""
    if isinstance(tree, dict):
        return {k: put_global_tree(v, mesh, axes[k] if isinstance(axes, dict)
                                   else axes, axis_name)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(put_global_tree(v, mesh, axes, axis_name)
                          for v in tree)
    if tree is None or axes is None:
        return tree
    return put_global(tree, mesh, axes, axis_name)


def gather_global(x: torch.Tensor, mesh, axis: int = 0,
                  axis_name: Optional[str] = None) -> torch.Tensor:
    """The blocks of every rank along the mesh's data axis (or
    ``axis_name``), joined along ``axis`` in rank order, on ``x``'s
    device. The transfer goes through host memory (gloo)."""
    n, _, group = _blocks(mesh, axis_name)
    if n == 1:
        return x
    host = x.detach().cpu().contiguous()
    wire = host.view(torch.uint8) if host.dtype == torch.bool else host
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    if host.dtype == torch.bool:
        parts = [p.view(torch.bool) for p in parts]
    return torch.cat(parts, dim=axis).to(x.device)


def host_replicated(x) -> np.ndarray:
    """A value every rank holds the same (replicated state, a drift
    reading), read on this rank's host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
