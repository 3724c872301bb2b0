"""Process-group bring-up for multi-card runs (the counterpart of the JAX
package's parallel/distributed.py; SURVEY.md section 5 "distributed
backend").

The reference is single-host (rayon threads only). Here a job runs one
process a card, joined into one torch.distributed process group:

  init_distributed()  -- one process group: NCCL between cards, gloo
                         between CPU processes (a no-op for a single
                         process with no arguments and no torchrun
                         environment, so one entry point serves one card
                         and many);
  global_mesh()       -- the 1-D mesh of every rank of the job, the mesh
                         every parallel/mesh.py function accepts;
  shutdown()          -- destroys the group.

Nothing on a machine announces a cluster: a job gives the group's address
(`tcp://host:port` or `file:///path`), world size and rank, or runs under
torchrun, which sets RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT.
"""

import datetime
import os

import torch
import torch.distributed as dist

from ..utils.devices import require_device
from .mesh import make_mesh

# a rendezvous or collective that never completes fails the run after this
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _rank_device(device, rank):
    """This rank's device: "cuda" without an index is the card LOCAL_RANK
    (torchrun) or rank modulo the cards of the host."""
    device = require_device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    return device


def init_distributed(init_method=None, world_size=None, rank=None,
                     device="cuda", timeout=DEFAULT_TIMEOUT):
    """Join this process to the job's process group (once per process).

    With no arguments it reads torchrun's environment when that is set;
    with no arguments and no such environment a single process has nothing
    to coordinate and the call does nothing. NCCL when `device` is CUDA
    (this rank's card becomes the current device), gloo on the CPU.
    Returns this rank's device."""
    if init_method is None and world_size is None and rank is None:
        if not all(k in os.environ for k in _TORCHRUN_ENV):
            return require_device(device)
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if init_method is None or world_size is None or rank is None:
        raise ValueError("init_distributed: give init_method, world_size and "
                         "rank together, or none of them")
    dev = _rank_device(device, rank)
    if dist.is_initialized():
        return dev
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev  # binds the rank to its card: NCCL starts here
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method, world_size=world_size, rank=rank,
        timeout=timeout, **kw,
    )
    return dev


def global_mesh(device=None):
    """The 1-D mesh over every rank of the job (a one-rank mesh when no
    group is initialized), computing on this rank's device: by default the
    current card under NCCL and the CPU under gloo."""
    if device is None:
        if dist.is_initialized():
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend() == "nccl" else "cpu")
        else:
            device = "cuda"
    return make_mesh(None, device)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Destroy the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
