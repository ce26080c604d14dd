"""The (data, model) mesh over ``torch.distributed`` ranks
(``mtn_tpu/parallel/mesh.py``).

JAX's mesh is one process driving a grid of devices, and GSPMD inserts
every collective from the sharding annotations. PyTorch runs one process
per device, so here the mesh is a layout of the world's ranks, and the
collectives are explicit: the tensor-parallel ones in the model's layers
(:mod:`mtn_tpu_torch.parallel.collectives`), the data-parallel ones in
the trainer and the decoder. ``model`` varies fastest, as JAX's
``reshape(data, model)``: rank ``d·model + m`` holds data row ``d`` and
model column ``m``, so a model group is a run of neighbouring ranks (on
one host, where ``torchrun`` numbers a host's ranks together).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def world_size() -> int:
    """Ranks in the default process group; 1 when none is initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(data: int = -1, model: int = 1,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` with ``mesh_dim_names=("data", "model")`` over the
    world's ranks; ``data=-1`` takes world // model. A world of one with
    no process group is the single-device case: ``None``.

    Raises as JAX's asserts do when the mesh exceeds the world, and also
    when it leaves ranks out: with one process per device a rank outside
    the mesh would have nothing to run."""
    n = world_size()
    if data == -1:
        if n % model:
            raise AssertionError(
                f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise AssertionError(f"mesh {data}x{model} > {n} devices")
    if data * model < n:
        raise AssertionError(
            f"mesh {data}x{model} leaves {n - data * model} of {n} ranks "
            "without a device (one process runs per device)")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import DeviceMesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(data, model),
                      mesh_dim_names=("data", "model"))
