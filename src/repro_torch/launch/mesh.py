"""Production mesh builders (counterpart of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group.  A mesh is a ``torch.distributed``
``DeviceMesh`` over the ranks of the job that is running, one rank a card.

The production meshes span 256 H100s (a pod) or 512 (two pods): 32 or 64
hosts of 8 cards.  The constants below are one card's (NVIDIA's data
sheet for the H100 SXM at 700 W: dense bf16 tensor-core rate, HBM3 rate,
NVLink rate each way).  NVLink joins only the 8 cards of a host; a mesh
axis that leaves a host goes over the network, whose rate the repo does
not know, so the roofline's collective term is a lower bound there.
"""
from __future__ import annotations

# H100 SXM data-sheet constants for the roofline (per card)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                  # B/s, HBM3
LINK_BW = 450e9                   # B/s, NVLink, each way


def _device_type() -> str:
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, model_parallel: int = 16,
                         device_type: str | None = None):
    """(256 // mp, mp) over ("data", "model") for a pod of 256 ranks, or
    (2, 256 // mp, mp) over ("pod", "data", "model") for 512.

    model_parallel reshapes the pod's 256 ranks (e.g. 8 for archs whose
    head counts don't divide 16).  The job must already run with exactly
    that many ranks; any other world size is refused.
    """
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    dp = 256 // model_parallel
    shape = (2, dp, model_parallel) if multi_pod else (dp, model_parallel)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    need = 512 if multi_pod else 256
    if world != need or dp * model_parallel != 256:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'pod'} mesh {shape} needs a "
            f"{need}-rank job; this one has {world}")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, *, device_type: str | None = None):
    """(world // mp, mp) over ("data", "model") for the job's ranks; a
    one-rank mesh when no job runs (a one-rank ``gloo`` job on localhost is
    started for it)."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    if not tdist.is_initialized():
        from repro_torch.launch.multihost import pick_port
        tdist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{pick_port()}", rank=0,
            world_size=1)
    n = tdist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model parallelism "
                         f"{model_parallel}")
    return init_device_mesh(device_type or _device_type(),
                            (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))
