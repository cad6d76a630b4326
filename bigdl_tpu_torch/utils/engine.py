"""Runtime bring-up of the data-parallel world (counterpart of
``bigdl_tpu/utils/engine.py`` ``Engine`` :21).

JAX's ``Engine.init`` joins the multi-host runtime and builds a device
mesh; here one process drives one device and a world of ``n`` processes
is a ``torch.distributed`` process group, the counterpart of a mesh of
``n`` devices on the ``"data"`` axis.  ``init()`` reads the variables
JAX's does (``BIGDL_COORDINATOR`` as ``host:port`` or a URL,
``BIGDL_NUM_PROCESSES``, ``BIGDL_PROCESS_ID``), else torchrun's
(``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``: ``env://``), and calls
``init_process_group`` with NCCL on the card and gloo on the CPU.  With
neither set it starts a world of one on an in-process store, as JAX's
mesh covers the local devices.  ``mesh()`` is the process group.
"""

import os
from typing import Optional

import torch
import torch.distributed as dist

from bigdl_tpu_torch.utils.device import resolve_device


def _rendezvous(coordinator_address, num_processes, process_id):
    """``(init_method, world, rank)`` from the arguments, JAX's
    variables, or torchrun's; ``(None, 1, 0)`` for a world of one."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("BIGDL_COORDINATOR")
        if coordinator_address is not None:
            if num_processes is None and "BIGDL_NUM_PROCESSES" in env:
                num_processes = int(env["BIGDL_NUM_PROCESSES"])
            if process_id is None and "BIGDL_PROCESS_ID" in env:
                process_id = int(env["BIGDL_PROCESS_ID"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        # torchrun's store: joined through its environment variables
        return ("env://", int(env.get("WORLD_SIZE", 1)),
                int(env.get("RANK", 0)))
    if coordinator_address is None:
        return None, 1, 0
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    return url, int(num_processes or 1), int(process_id or 0)


class Engine:
    """Singleton runtime configuration (reference: utils/Engine.scala)."""

    #: whether ``init`` started the group (``reset`` destroys it)
    _owns_group = False

    @classmethod
    def init(cls, coordinator_address: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None, device=None) -> "Engine":
        """Join (or start) the process group.  ``device``: the card when
        None (NCCL; the rank's card is ``LOCAL_RANK``, else the rank
        modulo the cards present), ``"cpu"`` for gloo.  A group that is
        already initialized is kept."""
        device = resolve_device(device)
        if not dist.is_initialized():
            url, world, rank = _rendezvous(coordinator_address,
                                           num_processes, process_id)
            backend = "nccl" if device.type == "cuda" else "gloo"
            if device.type == "cuda" and device.index is None:
                local = int(os.environ.get("LOCAL_RANK",
                                           rank % torch.cuda.device_count()))
                torch.cuda.set_device(local)
            if url is None:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
            else:
                dist.init_process_group(backend, init_method=url,
                                        world_size=world, rank=rank)
            cls._owns_group = True
        return cls

    @classmethod
    def mesh(cls, device=None):
        """The process group (initialized by ``init(device=...)`` when
        there is none)."""
        if not dist.is_initialized():
            cls.init(device=device)
        return dist.group.WORLD

    @classmethod
    def node_number(cls) -> int:
        """Processes in the world (JAX: ``jax.process_count()``)."""
        return dist.get_world_size() if dist.is_initialized() else 1

    @classmethod
    def core_number(cls) -> int:
        """Devices a process drives: one."""
        return 1

    @classmethod
    def device_count(cls) -> int:
        """Devices in the world: one a rank."""
        return cls.node_number()

    @classmethod
    def reset(cls):
        """Forget the configuration; a group ``init`` started is
        destroyed."""
        if cls._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        cls._owns_group = False
