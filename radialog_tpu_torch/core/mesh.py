"""Process groups, the (data, model) device mesh and batch slicing (port of
radialog_tpu/core/mesh.py on ``torch.distributed``).

The JAX package runs one controller over every chip and places work with
named shardings. Here every rank is a process of its own, one card each
(or, on the CPU, one gloo rank each), so a "device" of the mesh is a rank:

  * ``init_distributed`` joins the process group from the JAX module's
    environment (or explicit arguments), NCCL for a CUDA device and gloo for
    the CPU;
  * ``MeshSpec`` / ``make_mesh`` build a ``DeviceMesh`` with dims
    ("data", "model") over the ranks;
  * ``host_local_batch_slice`` / ``shard_batch`` give this rank its
    contiguous slice of the global batch on the data axis.

Collectives of the groups made here time out after ``timeout`` seconds
(``DEFAULT_TIMEOUT_S``): ranks that lose step raise instead of waiting.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
DEFAULT_TIMEOUT_S = 300.0


def _backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda",
                     backend: Optional[str] = None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group, from the environment the JAX package reads:

      RADIALOG_COORDINATOR   host:port of rank 0 (a ``tcp://`` init)
      RADIALOG_NUM_PROCESSES world size
      RADIALOG_PROCESS_ID    this process's rank
      RADIALOG_DISTRIBUTED=1 an ``env://`` init (MASTER_ADDR, MASTER_PORT,
                             RANK and WORLD_SIZE, as torchrun sets them)

    Explicit arguments override the environment. The backend is NCCL for a
    CUDA ``device`` and gloo for the CPU unless ``backend`` names one.
    Returns True when a process group is up (also when one already was:
    idempotent), False for the single-process no-op. A failed init raises."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get("RADIALOG_COORDINATOR")
    if num_processes is None and env.get("RADIALOG_NUM_PROCESSES"):
        num_processes = int(env["RADIALOG_NUM_PROCESSES"])
    if process_id is None and env.get("RADIALOG_PROCESS_ID"):
        process_id = int(env["RADIALOG_PROCESS_ID"])
    auto = env.get("RADIALOG_DISTRIBUTED") == "1"
    if coordinator_address is None and not auto:
        return False
    kwargs: dict = dict(backend=backend or _backend_for(device),
                        timeout=datetime.timedelta(seconds=timeout))
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("RADIALOG_COORDINATOR needs RADIALOG_NUM_PROCESSES and "
                             "RADIALOG_PROCESS_ID (or num_processes and process_id)")
        kwargs.update(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                      rank=process_id)
    else:
        kwargs.update(init_method="env://")
    dist.init_process_group(**kwargs)
    return True


def rank_device(device="cuda") -> torch.device:
    """The device this rank computes on. Inside a process group a CUDA
    device without an index is card ``rank % device_count`` (one card a
    rank where there are enough, every rank on one card otherwise), made
    the current one; any other device is as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def world_size() -> int:
    """Ranks in the process group; 1 without one (the JAX device count)."""
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. ``data * model`` must equal the rank count.

    data=-1 means "all remaining ranks on the data axis"."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: Optional[int] = None) -> tuple[int, int]:
        n = n_devices if n_devices is not None else world_size()
        model = max(1, self.model)
        if n % model != 0:
            raise ValueError(f"model axis {model} does not divide device count {n}")
        data = self.data if self.data > 0 else n // model
        if data * model != n:
            raise ValueError(f"mesh {data}x{model} != device count {n}")
        return data, model


def make_mesh(spec: MeshSpec = MeshSpec(), device="cuda",
              timeout: float = DEFAULT_TIMEOUT_S):
    """A ``DeviceMesh`` of dims ("data", "model") over the process group's
    ranks (rank r at data r // model, model r % model, the JAX mesh's
    row-major order). The process group must be up (``init_distributed``).
    Each dim's groups use the default group's backend and time out after
    ``timeout`` seconds."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    data, model = spec.resolve()
    backend = dist.get_backend()
    opts = _backend_options(backend, timeout)
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS),
                            backend_override={DATA_AXIS: (backend, opts),
                                              MODEL_AXIS: (backend, opts)})


def _backend_options(backend: str, timeout: float):
    """The backend's process-group options carrying ``timeout`` (a mesh's
    groups otherwise get the library's default of 30 minutes)."""
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
    else:
        opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout)
    return opts


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_group(mesh, axis: str):
    """The process group of ``axis`` through this rank (None without a
    mesh). An axis of one rank keeps its group: its sums are the identity,
    as a psum over a size-1 axis is, and still go through the backend."""
    return None if mesh is None else mesh.get_group(axis)


def host_local_batch_slice(global_batch: int, process_index: Optional[int] = None,
                           process_count: Optional[int] = None) -> slice:
    """Contiguous slice of the global batch this process should load
    (defaults: this rank of the whole process group)."""
    pi = (dist.get_rank() if dist.is_initialized() else 0) if process_index is None \
        else process_index
    pc = world_size() if process_count is None else process_count
    if global_batch % pc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by host count {pc}")
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def shard_batch(mesh, batch: Any, device="cuda") -> Any:
    """This rank's slice on the data axis of a tree of global host arrays
    (numpy or tensors, batch leading), as tensors on ``device``."""
    sl = host_local_batch_slice(_batch_of(batch), axis_rank(mesh, DATA_AXIS),
                                axis_size(mesh, DATA_AXIS))

    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        return x[sl].to(device)
    return _tree_map(put, batch)


def _batch_of(tree) -> int:
    if isinstance(tree, dict):
        return _batch_of(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _batch_of(tree[0])
    return len(tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
