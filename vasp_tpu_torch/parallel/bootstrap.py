"""Process-group bootstrap: ``torch.distributed`` initialization, the ranks a
run starts itself, and each rank's device.

Counterpart of vasp_tpu/parallel/bootstrap.py (jax.distributed; the
reference scales with MPI, ``mpirun -np N turtleFSI``). One process runs
each rank. :func:`distributed_init` joins the group of a launcher from
explicit arguments or the environment:

- ``VASP_COORDINATOR`` (``host:port`` of rank 0; else torchrun's
  ``MASTER_ADDR`` and ``MASTER_PORT``),
- ``VASP_NUM_PROCESSES`` / ``VASP_PROCESS_ID``, falling back to
  ``SLURM_NTASKS`` / ``SLURM_PROCID``, ``OMPI_COMM_WORLD_SIZE`` /
  ``OMPI_COMM_WORLD_RANK`` and torchrun's ``WORLD_SIZE`` / ``RANK``.

A single process is a no-op. Without a launcher, :func:`spawn_world`
starts the ranks itself (torch.multiprocessing spawn, a FileStore in a
temporary directory). :func:`use_rank_device` is the rank -> device map,
vasp_tpu's global_device_mesh: cuda:<local rank % cards>, made the
process's current card, which the hand-written kernels need (each
launches on its tensor's stream, and CUDA refuses a launch on a stream of
another card than the current one).
"""
import os
import tempfile

import torch
import torch.distributed as dist


def _env_int(*names):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return None


def local_rank():
    """The process's rank on its host (the launcher's, else its global
    rank; 0 outside a process group)."""
    r = _env_int("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")
    if r is not None:
        return r
    return dist.get_rank() if dist.is_initialized() else 0


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


BACKENDS = ("nccl", "gloo")


def backend_for(device, backend=None):
    """The process group's backend: `backend` ("nccl" or "gloo"), else
    "nccl" on CUDA and "gloo" on the CPU. Never switched by itself: nccl
    with fewer cards than ranks raises (check_backend)."""
    if backend in (None, "None", ""):
        return "gloo" if torch.device(device).type == "cpu" else "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"dist_backend={backend!r}: expected one of "
                         f"{BACKENDS}")
    return backend


def check_backend(backend, ranks_on_host):
    """NCCL takes one card a rank: raise, naming the gloo backend that shares
    cards, where the host has fewer cards than ranks."""
    if backend == "nccl" and torch.cuda.device_count() < ranks_on_host:
        raise RuntimeError(
            f"dist_backend=nccl needs one card per rank: {ranks_on_host} "
            f"ranks on this host, {torch.cuda.device_count()} cards; set "
            f"dist_backend=gloo to run several ranks on one card")


def distributed_init(coordinator=None, num_processes=None, process_id=None,
                     backend="gloo", verbose=True):
    """Join (or skip joining) a multi-process group. Explicit arguments win;
    otherwise the environment is read (module docstring). Returns True when
    a group of more than one process exists, False for the single-process
    no-op. Safe to call more than once."""
    if dist.is_initialized():
        return True
    if coordinator is None:
        coordinator = os.environ.get("VASP_COORDINATOR")
        if coordinator is None and "MASTER_ADDR" in os.environ:
            coordinator = (f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("VASP_NUM_PROCESSES", "SLURM_NTASKS",
                                 "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("VASP_PROCESS_ID", "SLURM_PROCID",
                              "OMPI_COMM_WORLD_RANK", "RANK")
    if num_processes in (None, 1):
        return False
    if coordinator is None or process_id is None:
        raise RuntimeError(
            f"multi-process run requested (num_processes={num_processes}) "
            "but no coordinator address or rank: set VASP_COORDINATOR="
            "host:port and VASP_PROCESS_ID (or run under torchrun)")
    local = _env_int("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE",
                     "OMPI_COMM_WORLD_LOCAL_SIZE") or num_processes
    check_backend(backend, local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    if verbose and process_id == 0:
        print(f"torch.distributed: {num_processes} processes, backend "
              f"{backend}", flush=True)
    return True


def use_rank_device(name="cuda"):
    """The device of this rank for the config's `name`, made the current
    card where it is one: a CUDA device without an index becomes
    cuda:<local rank % visible cards> inside a process group (so that rank
    r of a group with a card a rank launches its kernels on cuda:r),
    anything else is returned as given."""
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None and world_size() > 1:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def _rank_entry(rank, n, backend, store, threads, fn, args):
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(threads)
    dist.init_process_group(backend, store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_world(n, fn, args=(), backend="gloo", store_dir=None,
                threads=None):
    """Run fn(*args) in n new processes joined into one process group (the
    ranks 0..n-1 of this host), and wait for them; an exception in a rank
    is raised here, what fn returns is dropped. fn must be importable by
    name (it is pickled). The group meets in a FileStore under a temporary
    directory in store_dir (the system's temporary directory when None).
    threads: torch threads per rank (default: this process's count shared
    out)."""
    check_backend(backend, n)
    if threads is None:
        threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        torch.multiprocessing.start_processes(
            _rank_entry, args=(n, backend, os.path.join(tmp, "store"),
                               threads, fn, args),
            nprocs=n, join=True, start_method="spawn")
