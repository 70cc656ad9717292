"""Device mesh construction helpers.

Port of ``pyannote_video_tpu/parallel/mesh.py``: a 2-D ``(data, model)``
mesh where the frame/chip batch axis shards over ``data`` and wide channel
dimensions may shard over ``model``.  The JAX mesh spans the devices one
controller sees; a PyTorch mesh spans the processes of a
``torch.distributed`` group, one device each, and its placements are the
``DTensor`` ones that stand for the JAX ``NamedSharding``s.

One H100 is a world of one process: ``make_mesh()`` there is the 1×1 mesh,
on a one-process group it makes itself.  Groups of several ranks are made
by the caller (``parallel/dryrun.py:launch`` starts them); on the CPU
they are gloo processes.
"""

from __future__ import annotations

import atexit
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

from ..utils.device import DeviceLike, resolve_device


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, str] = ("data", "model"),
              model_parallelism: int = 1, device: DeviceLike = None):
    """A ``DeviceMesh`` of shape ``(n // model_parallelism,
    model_parallelism)`` over the ``n`` ranks of the process group.

    ``n_devices`` defaults to the group's size (1 without a group) and must
    equal it: a mesh spans the whole group.  The divisibility check comes
    first, before any group is touched.  Without a group, a world of one
    gets a one-process group made here (NCCL on ``cuda``, gloo on ``cpu``,
    through a file store in a temporary directory: no port, no environment
    variables), so that ``make_mesh()`` on one card is the 1×1 mesh.
    ``device``: ``cuda`` unless ``"cpu"`` is asked for.
    """
    device = resolve_device(device)
    import torch.distributed as dist

    started = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if started else 1
    n = world if n_devices is None else n_devices
    if n % model_parallelism != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallelism={model_parallelism}")
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a process group of {n} "
                         f"ranks; this one has {world}")
    if not started:
        store = tempfile.mkdtemp(prefix="pyv_mesh_")
        atexit.register(shutil.rmtree, store, True)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"file://{store}/store", rank=0, world_size=1)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, (n // model_parallelism, model_parallelism),
                            mesh_dim_names=tuple(axes))


def mesh_shape(mesh) -> Dict[str, int]:
    """``{"data": dp, "model": tp}``: JAX's ``dict(mesh.shape)``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_sharding(mesh) -> List:
    """Shard the leading (batch) axis over the data axis."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0), Replicate()]


def replicated(mesh) -> List:
    from torch.distributed.tensor import Replicate

    return [Replicate(), Replicate()]


def model_sharding(mesh, axis: int, ndim: int) -> List:
    """Shard dimension `axis` of an ndim-array over the model axis."""
    from torch.distributed.tensor import Replicate, Shard

    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for {ndim} dimensions")
    return [Replicate(), Shard(axis % ndim)]
