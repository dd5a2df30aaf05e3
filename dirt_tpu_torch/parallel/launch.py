"""Process groups for the sharded paths: one process a rank, over
torch.distributed.

dirt_tpu runs its sharded paths as one program over a `jax.sharding.Mesh`
(shard_map).  The port runs them SPMD: `run_ranks` spawns one process a
rank, joins them through a `FileStore` in a temporary directory (no TCP
port, so groups started side by side never collide), runs `target` in
each and returns every rank's result.

The transport is the caller's choice, never a silent one:
  * backend="gloo": CPU tensors, and with device="cuda" CUDA tensors too
    (the group is "cpu:gloo,cuda:gloo"); several ranks may share one card;
  * backend="nccl": CUDA tensors, one rank a card (NCCL refuses two ranks
    on one card).
Rank r works on card r mod torch.cuda.device_count().

A rank that raises (or exits) makes `run_ranks` raise: the spawner stops
the other ranks, and the exception of the rank that failed first is
raised again in the caller (chained to the spawner's report).
"""

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")
TIMEOUT_S = 300


def _process_group_backend(backend, device_type):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("backend='nccl' carries CUDA tensors only: "
                             "pass device='cuda'")
        return "nccl"
    return "cpu:gloo,cuda:gloo" if device_type == "cuda" else "gloo"


def _to_cpu(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*map(_to_cpu, value))
    if isinstance(value, (list, tuple)):
        return type(value)(map(_to_cpu, value))
    return value


def _claim_error(tmp, rank, exc):
    """Writes exc as the run's error unless a rank has claimed it: the
    first rank to fail is the cause, the others fail after it (a
    collective whose peer went away)."""
    try:
        blob = pickle.dumps(exc)
    except (pickle.PicklingError, TypeError, AttributeError):
        blob = pickle.dumps(RuntimeError(f"rank {rank}: {exc!r}"))
    try:
        fd = os.open(os.path.join(tmp, "error.pkl"),
                     os.O_WRONLY | os.O_CREAT | os.O_EXCL)
    except FileExistsError:
        return
    with os.fdopen(fd, "wb") as fh:
        fh.write(blob)


def _rank_main(rank, world_size, target, args, backend, device_type, tmp):
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(os.path.join(tmp, "store"), world_size)
        dist.init_process_group(
            _process_group_backend(backend, device_type), store=store,
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            value = target(*args)
            if device_type == "cuda":
                torch.cuda.synchronize()
        except BaseException as exc:
            # claimed before the group goes, which fails the other ranks
            _claim_error(tmp, rank, exc)
            raise
        finally:
            dist.destroy_process_group()
        torch.save(_to_cpu(value), os.path.join(tmp, f"result.{rank}.pt"))
    except BaseException as exc:
        _claim_error(tmp, rank, exc)
        raise


def run_ranks(world_size, target, args=(), backend="gloo", device="cuda"):
    """Runs target(*args) on `world_size` ranks, one spawned process each,
    in a process group over `backend` ("gloo" or "nccl") with tensors on
    `device` ("cuda", the default, or "cpu"); returns each rank's value
    (tensors moved to the CPU), in rank order.  Raises where device is
    "cuda" and there is no card.

    `target` and `args` must pickle (a function of a module, numpy arrays,
    plain values): each process imports `target`'s module afresh.  Inside
    `target`, torch.distributed's default group is the world, and
    `make_mesh` / `make_face_mesh` build meshes over it.  A
    collective that waits longer than TIMEOUT_S seconds raises."""
    device_type = torch.device(device).type
    _process_group_backend(backend, device_type)
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for the CPU")
    with tempfile.TemporaryDirectory(prefix="dirt_ranks_") as tmp:
        try:
            mp.spawn(_rank_main, nprocs=world_size, join=True, args=(
                world_size, target, args, backend, device_type, tmp))
        except (mp.ProcessRaisedException,
                mp.ProcessExitedException) as failure:
            path = os.path.join(tmp, "error.pkl")
            if os.path.exists(path):
                with open(path, "rb") as fh:
                    raise pickle.loads(fh.read()) from failure
            raise
        return [torch.load(os.path.join(tmp, f"result.{rank}.pt"),
                           weights_only=False)
                for rank in range(world_size)]
