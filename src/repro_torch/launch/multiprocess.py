"""Multi-process bring-up for the ring of ranks (``torch.distributed``).

Two small layers, in the order a run uses them:

1. **Spawn**: ``spawn_local_cluster`` runs N copies of an argv as a local
   cluster, each with the coordinator, the world size and its rank in its
   environment (``local_cluster_env``). A rank that exits non-zero ends the
   others and makes the caller raise.
2. **Init**: inside each process, ``initialize_from_env`` (or the explicit
   ``initialize_process``) joins the default process group over ``gloo``.

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
from typing import Dict, List, Optional, Sequence

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
