"""The timestep-sharded postprocessing passes: each chunk of a series cut
into the ranks' contiguous shares of its steps.

Counterpart of vasp_tpu's n_devices > 1 passes
(vasp_tpu/postprocessing/fields/hemodynamics.py:124-170 and :225-240,
stress_strain.py:180-220: a ("t",) device mesh over each chunk's steps, the
chunk padded to a multiple of the device count by repeating its last step,
the padding dropped after). Here the devices are the ranks of a process
group, one process each (parallel/bootstrap.py, as run/driver.py starts a
sharded run): rank r takes the steps [r T_p / n, (r + 1) T_p / n) of the
padded chunk of T_p steps, runs the chunk's kernel (K20a or K20b) on them
on its own card, and ``gather_steps`` hands every rank the whole chunk in
step order through parallel/comm.py's Collectives (a sum all-reduce of
buffers in which only the owner wrote its rows: exact). Rank 0 alone then
runs the host work that follows and writes.
"""
from vasp_tpu_torch.parallel import bootstrap
from vasp_tpu_torch.parallel.comm import Collectives


def rank_group(n_devices, fn, args, backend):
    """(comm, spawned) for a pass on n_devices ranks: inside a process group
    of n_devices processes (a launcher's, joined here as
    bootstrap.distributed_init joins it, or one spawn_world started) this
    rank's Collectives; outside one, fn(*args) run on n_devices spawned
    ranks (a FileStore in a temporary directory) and (None, True). A single
    rank gives (None, False)."""
    n = int(n_devices or 1)
    if n <= 1:
        return None, False
    bootstrap.distributed_init(backend=backend)
    world = bootstrap.world_size()
    if world == 1:
        bootstrap.spawn_world(n, fn, args, backend)
        return None, True
    if world != n:
        raise RuntimeError(f"n_devices={n} in a process group of {world} "
                           f"ranks")
    return Collectives(), False


def padded_steps(T, n):
    """T rounded up to a multiple of the rank count n."""
    return -(-T // n) * n


def share(T, comm):
    """The rank's step indices into a chunk of T steps, padded to a multiple
    of the rank count by repeating the last step (vasp_tpu's padding)."""
    per = padded_steps(T, comm.n) // comm.n
    lo = comm.rank * per
    return [min(k, T - 1) for k in range(lo, lo + per)]


def gather_steps(comm, part, T):
    """The ranks' shares part (per, ...) of a chunk -> the chunk's first T
    steps (T, ...) in step order on every rank (the padding dropped)."""
    whole = comm.gather_spans(part.reshape(-1))
    return whole.reshape((-1,) + tuple(part.shape[1:]))[:T]
