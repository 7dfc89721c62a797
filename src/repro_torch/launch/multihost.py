"""Local multi-process launcher for the fleet executors (``shard_map`` and
``multiprocess``), counterpart of ``repro.launch.multihost``.

One rank per OS process: the launcher spawns ``num_procs`` processes wired
as the ranks of one ``torch.distributed`` job (a rendezvous on a freshly
picked localhost port; rank, world size, rendezvous address and device
carried in ``REPRO_TORCH_MH_*`` environment variables),
captures each rank's stdout/stderr in per-rank log files, and supervises
the fleet:

  * a rank exiting non-zero kills the remaining ranks at once and raises
    ``WorkerFailure`` with that rank's stderr tail (otherwise the others
    wait forever in the rendezvous or in a collective);
  * a wall-clock ``timeout`` bounds the whole run (hang detection).

Ranks call ``init_from_env()`` before any collective: it joins the
``gloo`` process group with the env-carried wiring and, when the fleet
runs on a GPU, makes the parent's card the rank's current device.  Every
rank runs on the device the parent names (``cuda`` unless the parent asks
for ``cpu``), so on a machine with one card all ranks share it; gloo moves
their messages through host memory (``repro_torch.core.dist``).

The module works for any rank entry point: ``train_gnn`` re-execs itself
through it (``--executor multiprocess --num-procs N``), and tests pass
inline ``python -c`` scripts.  Importing it imports no torch.
"""
from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time

# env vars carrying the rank wiring from launcher to ranks
ENV_ADDRESS = "REPRO_TORCH_MH_ADDRESS"       # "host:port" of the rendezvous
ENV_NUM_PROCS = "REPRO_TORCH_MH_NUM_PROCS"
ENV_RANK = "REPRO_TORCH_MH_RANK"
ENV_DEVICE = "REPRO_TORCH_MH_DEVICE"


class WorkerFailure(RuntimeError):
    """A rank exited non-zero (or died); carries its stderr tail."""

    def __init__(self, rank: int, returncode: int, stderr_tail: str):
        self.rank = rank
        self.returncode = returncode
        self.stderr_tail = stderr_tail
        super().__init__(
            f"multihost worker rank {rank} exited with code {returncode}"
            f"; stderr tail:\n{stderr_tail}")


def pick_port() -> int:
    """A free localhost TCP port for the process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(base_env: dict, *, rank: int, num_procs: int, port: int,
             device: str = "cuda") -> dict:
    """The environment of rank ``rank``: a copy of ``base_env`` with the
    ``REPRO_TORCH_MH_*`` wiring added (``base_env`` is not changed)."""
    env = dict(base_env)
    env[ENV_ADDRESS] = f"127.0.0.1:{port}"
    env[ENV_NUM_PROCS] = str(num_procs)
    env[ENV_RANK] = str(rank)
    env[ENV_DEVICE] = str(device)
    return env


def is_worker(env=None) -> bool:
    """True when this process was spawned by ``launch`` (rank env set)."""
    return ENV_RANK in (os.environ if env is None else env)


def init_from_env(env=None):
    """Join the fleet's ``gloo`` process group from the launcher's
    environment and pin the rank to the fleet's device (the parent's card
    unless the parent asked for ``cpu``).

    Returns ``(rank, num_procs, device)``.
    """
    import torch
    import torch.distributed as tdist

    env = os.environ if env is None else env
    rank = int(env[ENV_RANK])
    num_procs = int(env[ENV_NUM_PROCS])
    device = torch.device(env.get(ENV_DEVICE, "cuda"))
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
        device = torch.device("cuda", torch.cuda.current_device())
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{env[ENV_ADDRESS]}", rank=rank,
        world_size=num_procs)
    return rank, num_procs, device


def rank_trace_path(base: str, rank: int) -> str:
    """Per-rank trace file for a fleet whose merged trace is ``base``:
    ranks export to ``{base}.rank{r}``, the parent merges them into
    ``base`` with ``merge_rank_traces`` after the fleet exits."""
    return f"{base}.rank{int(rank)}"


def merge_rank_traces(base: str, num_procs: int,
                      out: str | None = None) -> dict:
    """Merge the fleet's per-rank trace files into one trace, rank as pid
    (``repro_torch.obs.trace.merge_traces``), written to ``out`` (default
    ``base``).  Returns the merged dict."""
    from repro_torch.obs.trace import merge_traces

    paths = [rank_trace_path(base, r) for r in range(num_procs)]
    return merge_traces(paths, out if out is not None else base)


def _stderr_tail(log_dir: str, rank: int, limit: int = 4000) -> str:
    path = os.path.join(log_dir, f"rank{rank}.err")
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - limit))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return f"<no stderr captured at {path}>"


def _kill_all(procs, grace: float = 5.0) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def launch(argv, *, num_procs: int, device: str = "cuda",
           timeout: float = 600.0,
           log_dir: str | None = None, env: dict | None = None,
           poll_interval: float = 0.1) -> str:
    """Run ``argv`` as ``num_procs`` ranks of one ``torch.distributed``
    job and return the directory of their logs.

    argv:          the rank command line, the same for every rank (ranks
                   read their rank from the environment).
    num_procs:     the world size, every rank on this machine (each
                   hosts num_parts / num_procs workers).
    device:        the device every rank runs on (``cuda`` or ``cpu``).
    timeout:       wall-clock bound on the whole run; past it the fleet is
                   killed and ``TimeoutError`` raised.
    log_dir:       where ``rank{r}.out`` / ``rank{r}.err`` go (a fresh
                   temporary directory when omitted).
    env:           the base environment (default ``os.environ``).

    Raises ``WorkerFailure`` when a rank exits non-zero (the other ranks
    are killed first) and ``TimeoutError`` when the fleet outlives
    ``timeout``.
    """
    if num_procs < 1:
        raise ValueError(f"num_procs must be >= 1, got {num_procs}")
    port = pick_port()
    log_dir = log_dir or tempfile.mkdtemp(prefix="repro-torch-multihost-")
    os.makedirs(log_dir, exist_ok=True)
    base = dict(os.environ if env is None else env)

    procs, files = [], []
    try:
        for r in range(num_procs):
            out = open(os.path.join(log_dir, f"rank{r}.out"), "wb")
            err = open(os.path.join(log_dir, f"rank{r}.err"), "wb")
            files += [out, err]
            procs.append(subprocess.Popen(
                argv, stdout=out, stderr=err,
                env=rank_env(base, rank=r, num_procs=num_procs, port=port,
                             device=device)))

        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = next((r for r, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if failed is not None:
                _kill_all(procs)
                raise WorkerFailure(failed, codes[failed],
                                    _stderr_tail(log_dir, failed))
            if all(c == 0 for c in codes):
                return log_dir
            if time.monotonic() > deadline:
                _kill_all(procs)
                status = ", ".join(
                    f"rank{r}={'running' if c is None else c}"
                    for r, c in enumerate(codes))
                alive = next((r for r, c in enumerate(codes)
                              if c is None), 0)
                raise TimeoutError(
                    f"multihost run exceeded {timeout:.0f}s ({status}); "
                    f"rank {alive} stderr tail:\n"
                    f"{_stderr_tail(log_dir, alive)}")
            time.sleep(poll_interval)
    finally:
        _kill_all(procs)
        for f in files:
            f.close()
