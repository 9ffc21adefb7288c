"""Multi-process support (counterpart of the JAX ``parallel/multihost.py``).

JAX runs one process per host, each driving its local devices.  The port
runs one process per rank (``torchrun``), so a JAX process maps to a torch
*node*, ``WORLD_SIZE // LOCAL_WORLD_SIZE`` of them:

- the ranks of one node read the same input stream and each keeps its rows
  of every batch (:func:`global_batch`), which is JAX's single-process mesh;
- nodes split the stream round robin (:func:`shard_data_iterator`), each
  contributing its batch as one node's share of the global batch, which is
  JAX's multi-process path.

Recovery is restart based, as in JAX: relaunch every process and
``--resume`` from the last full train state.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from cnns_slfp_quantization_tpu_torch.parallel import mesh as mesh_lib


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, *,
               device_type: str = "cuda") -> bool:
    """Join the process group from the arguments or the environment
    ``torchrun`` sets (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``); a no-op at one process, and where a group is up
    already (a caller that named its own backend keeps it).  The backend
    follows the device: ``cuda`` -> NCCL, ``cpu`` -> gloo.  Returns
    whether a process group is up."""
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    if world <= 1:
        return False
    rank = int(os.environ["RANK"]) if rank is None else rank
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=init_method or "env://", world_size=world, rank=rank)
    return True


def _node() -> tuple:
    """(this rank's node, the number of nodes); (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    return dist.get_rank() // local, dist.get_world_size() // local


def process_count() -> int:
    """Nodes in the run (JAX's ``process_count``)."""
    return _node()[1]


def process_index() -> int:
    """This rank's node (JAX's ``process_index``)."""
    return _node()[0]


def global_batch(mesh, local_images, local_labels):
    """This rank's rows of the global batch, given its node's batch: the
    global batch is the nodes' batches in node order, split over the data
    axis; the data ranks of one node share its batch."""
    nodes = _node()[1]
    d = mesh_lib.axis_size(mesh, "data")
    if d % nodes:
        raise ValueError(f"data axis {d} not divisible by the {nodes} "
                         f"node(s)")
    per_node = d // nodes
    n = local_images.shape[0]
    if n % per_node:
        raise ValueError(
            f"batch size {n} not divisible by the node's {per_node} "
            f"data-parallel rank(s); pick --train_batch_size/"
            f"--eval_batch_size divisible by --mesh_data")
    b = n // per_node
    i = mesh_lib.axis_rank(mesh, "data") % per_node
    return local_images[i * b:(i + 1) * b], local_labels[i * b:(i + 1) * b]


def shard_data_iterator(it, process_index: Optional[int] = None,
                        process_count: Optional[int] = None,
                        total: Optional[int] = None):
    """Round-robin split of a node's iterator across nodes (each node reads
    only its 1/process_count of the batches).

    The stream is truncated to ``(total // process_count) * process_count``
    batches so that every node yields the same number of batches: a ragged
    tail would make the nodes run the step a different number of times and
    hang the collectives.  ``total`` defaults to ``len(it)`` when the
    iterable is sized."""
    node, nodes = _node()
    pi = node if process_index is None else process_index
    pc = nodes if process_count is None else process_count
    if total is None and hasattr(it, "__len__"):
        total = len(it)
    stop = (total // pc) * pc if total is not None else None
    for i, batch in enumerate(it):
        if stop is not None and i >= stop:
            return
        if i % pc == pi:
            yield batch
