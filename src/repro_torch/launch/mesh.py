"""Production meshes, as ``torch.distributed`` ``DeviceMesh``es.

Single pod: (data=16, model=16) = 256 GPUs.
Multi pod:  (pod=2, data=16, model=16) = 512 GPUs; the ``pod`` axis is a
second data-parallel axis whose collectives cross between the two halves
of the machine -- the hop IDEALEM gradient compression targets.

On H100s an 8-GPU node is one NVLink domain, so a 16-wide ``model`` axis
(tensor parallelism, the innermost and fastest-varying mesh dim) spans two
nodes and its collectives leave NVLink for the network between them; each
``data`` (and ``pod``) step crosses nodes too.  The shapes are the
reference package's, so the dry run's cells compare with its cells.

A mesh needs a process group of as many ranks as the mesh has GPUs.
Building one is kept inside these functions, which the caller invokes
after setting up that group (the dry run owns a fake group of 256 or 512
ranks: ``launch/dryrun.py``), so importing this module touches no process
group or device.  The production meshes are of device type ``cuda`` also
in the dry run, whose shards live on the meta device: the device type
decides which collectives ``DTensor`` issues (a ``cpu`` mesh stands an
all-gather in for every all-to-all), and the fake group runs none.
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "batch_axes", "make_debug_mesh"]


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") mesh, over the default process
    group (which must hold 256 or 512 ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def batch_axes(multi_pod: bool = False):
    return ("pod", "data") if multi_pod else ("data",)


def make_debug_mesh(data: int = 2, model: int = 2):
    """A small ("data", "model") mesh for CPU multi-process tests over the
    default process group (``gloo``, ``data * model`` ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (data, model),
                            mesh_dim_names=("data", "model"))
