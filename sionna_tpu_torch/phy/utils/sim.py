"""Monte-Carlo BER/BLER simulation loop.

PyTorch counterpart of ``sionna_tpu/phy/utils/sim.py``. A Python loop
runs the MC iterations; error counters stay on the device of the model's
output and are read by the host once per chunk of ``device_iters``
iterations, where the stopping conditions are checked and the checkpoint
(if any) is written, as the JAX version polls its fused chunks.

``mc_fun(batch_size, ebno_db)`` takes a Python float ``ebno_db`` and
returns ``(b, b_hat)``; it draws its own random numbers (from its
blocks' generators or ``config.generator``).

Data parallelism (JAX: ``shard_map`` over a device mesh, counters
``psum``-reduced) is one process per GPU here: launch the script with
``torchrun --nproc_per_node=N``, call :func:`init_multihost` in each
process and pass ``distribute="multihost"`` (or ``"all"``). Each rank
then runs ``batch_size / world_size`` examples per iteration from its
own random streams, and the four counters are summed over the ranks by
one ``all_reduce`` per chunk, so every rank takes the same stopping
decisions.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import config
from .misc import hard_decisions

__all__ = ["sim_ber", "init_multihost"]

_TORCHRUN = ("launch one process per GPU with torchrun --nproc_per_node=N, "
             "call sionna_tpu_torch.phy.utils.init_multihost() in each and "
             "pass distribute='multihost' (or 'all')")


def _group_initialized():
    return dist.is_available() and dist.is_initialized()


def _resolve_world(distribute):
    """The number of ranks that share a sweep: None for one process (no
    collective), else the initialized group's world size."""
    if distribute is None:
        return None
    if distribute == "all":
        if _group_initialized():
            return dist.get_world_size()
        visible = torch.cuda.device_count() \
            if config.device.type == "cuda" else 1
        if visible <= 1:
            return None
        raise ValueError(
            f"distribute='all' over {visible} visible GPUs needs one process "
            f"per GPU: {_TORCHRUN}")
    if distribute == "multihost":
        if not _group_initialized() or dist.get_world_size() < 2:
            raise RuntimeError(
                "distribute='multihost' requires an initialized "
                "torch.distributed group of two or more ranks: "
                + _TORCHRUN)
        return dist.get_world_size()
    raise ValueError(
        f"Unsupported distribute argument: {distribute!r}. A device mesh or "
        f"a device list has no one-process counterpart in PyTorch: "
        f"{_TORCHRUN}")


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, **kwargs):
    """Joins this process to the ``torch.distributed`` group that
    ``sim_ber(distribute="multihost")`` sums its counters over.

    ``coordinator_address`` ("host:port" of rank 0) gives a ``tcp://``
    rendezvous; without it the ``env://`` one of ``torchrun`` (its
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``).
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``. The backend is NCCL when ``config.device`` is a GPU and
    gloo on the CPU; ``backend=`` overrides it, and the other keywords
    go to ``torch.distributed.init_process_group``. On a GPU the
    process's card is pinned to ``LOCAL_RANK`` (default 0) first. Every
    process must then run the same sweep (the same ``config.seed``)."""
    cuda = config.device.type == "cuda"
    backend = kwargs.pop("backend", "nccl" if cuda else "gloo")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", -1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", -1))
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)


def sim_ber(mc_fun, ebno_dbs, batch_size, max_mc_iter,
            soft_estimates=False,
            num_target_bit_errors=None,
            num_target_block_errors=None,
            target_ber=None,
            target_bler=None,
            early_stop=True,
            graph_mode=None,
            distribute=None,
            device_iters=None,
            verbose=True,
            forward_keyboard_interrupt=True,
            callback=None,
            checkpoint_path=None,
            precision=None,
            profiler=None):
    """Simulates until target errors or ``max_mc_iter`` per SNR point.

    Returns ``(ber, bler)`` float64 CPU tensors of the same length as
    ``ebno_dbs``. Points skipped due to early stopping are ``nan``;
    after a keyboard interrupt, points never simulated are ``-1``.

    ``graph_mode`` (None, "graph" or "xla") and ``precision`` (None,
    "single" or "double") are validated as in the JAX package and
    otherwise ignored: ``mc_fun`` runs eager, in its blocks' precision.

    ``checkpoint_path``: optional ``.npz`` path; the error counters are
    written after every chunk (atomically, through ``os.replace``), so
    an interrupted sweep resumes where it stopped: completed points are
    skipped, partial points continue from their recorded iteration
    count. An unreadable or mismatching file means a fresh start.

    ``profiler``: optional
    :class:`~sionna_tpu_torch.phy.utils.Profiler`; each chunk runs in
    its phase "compile" (the first chunk of each length) or "mc_chunk",
    and reading the counters syncs the device inside the phase.

    ``distribute``: None (this process alone), ``"multihost"`` (the
    initialized ``torch.distributed`` group, two or more ranks; see
    :func:`init_multihost`) or ``"all"`` (the group if one is
    initialized, else this process when it sees one device). With a
    group, ``batch_size`` must divide by its world size; each rank runs
    its share from its own streams (``config.fork(rank)``), the counters
    are summed over the ranks, only rank 0 prints the table and writes
    the checkpoint, and a failed collective raises.
    """
    if graph_mode not in (None, "graph", "xla"):
        raise ValueError("graph_mode must be None, 'graph' or 'xla'")
    if precision not in (None, "single", "double"):
        raise ValueError("precision must be 'single' or 'double'")
    world = _resolve_world(distribute)
    rank = 0
    if world is not None:
        if batch_size % world != 0:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by the number "
                f"of ranks ({world})")
        batch_size //= world
        rank = dist.get_rank()
        config.fork(rank)
        verbose = verbose and rank == 0
    ebno_dbs = np.atleast_1d(np.asarray(ebno_dbs, np.float64))
    num_points = len(ebno_dbs)

    if device_iters is None:
        # poll the stopping conditions every ~10% of max_mc_iter
        device_iters = int(min(max(1, max_mc_iter // 10), 32))
    device_iters = int(min(device_iters, max_mc_iter))

    bit_errors = np.zeros(num_points, np.int64)
    block_errors = np.zeros(num_points, np.int64)
    nb_bits = np.zeros(num_points, np.int64)
    nb_blocks = np.zeros(num_points, np.int64)
    runtimes = np.zeros(num_points, np.float64)
    status = [""] * num_points
    iters_state = np.zeros(num_points, np.int64)

    if checkpoint_path is not None and os.path.isfile(checkpoint_path):
        try:
            ckpt = dict(np.load(checkpoint_path, allow_pickle=True))
            ckpt["ebno_dbs"]
        except Exception:  # pylint: disable=broad-except
            ckpt = None
            if verbose:
                print(f"Checkpoint {checkpoint_path} is unreadable; "
                      "starting fresh")
        if ckpt is not None and (len(ckpt["ebno_dbs"]) == num_points
                                 and np.allclose(ckpt["ebno_dbs"], ebno_dbs)):
            bit_errors = ckpt["bit_errors"].astype(np.int64)
            block_errors = ckpt["block_errors"].astype(np.int64)
            nb_bits = ckpt["nb_bits"].astype(np.int64)
            nb_blocks = ckpt["nb_blocks"].astype(np.int64)
            iters_state = ckpt["iters"].astype(np.int64)
            status = list(ckpt["status"])
            if verbose:
                print(f"Resuming sweep from {checkpoint_path}")
        elif ckpt is not None and verbose:
            print(f"Checkpoint {checkpoint_path} does not match this "
                  "sweep; starting fresh")

    def save_checkpoint():
        if checkpoint_path is None or rank != 0:
            return
        tmp = checkpoint_path + ".tmp.npz"
        np.savez(tmp, ebno_dbs=ebno_dbs, bit_errors=bit_errors,
                 block_errors=block_errors, nb_bits=nb_bits,
                 nb_blocks=nb_blocks, iters=iters_state,
                 status=np.asarray(status, object))
        os.replace(tmp, checkpoint_path)

    if verbose:
        print("EbNo [dB] |       BER |      BLER |  bit errors |"
              "    num bits | block errors |  num blocks | runtime [s] |"
              "    status")
        print("-" * 126)

    def run_chunk(ebno_db, n):
        """n MC iterations; returns the four counters (summed over the
        ranks), read once."""
        errs = None
        nb = nblk = 0
        for _ in range(n):
            b, b_hat = mc_fun(batch_size, ebno_db)
            if soft_estimates:
                b_hat = hard_decisions(b_hat)
            ne = b != b_hat
            e = torch.stack([ne.sum(), ne.any(dim=-1).sum()])
            errs = e if errs is None else errs + e
            nb += b.numel()
            nblk += b.numel() // b.shape[-1]
        if world is None:
            return errs.tolist() + [nb, nblk]
        counts = torch.cat([errs, torch.tensor([nb, nblk],
                                               device=errs.device)])
        if dist.get_backend() != "nccl":
            counts = counts.cpu()
        dist.all_reduce(counts)
        return counts.tolist()

    stop_sweep = False
    interrupted = False
    compiled = set()  # chunk lengths run once (the "compile" phase)
    try:
        for i in range(num_points):
            if status[i] not in ("", "interrupted"):
                continue  # already completed (resumed sweep)
            if stop_sweep:
                status[i] = "not simulated"
                continue
            t0 = time.perf_counter()
            iters_done = int(iters_state[i])
            status[i] = ""
            point_done = False
            while iters_done < max_mc_iter and not point_done:
                n = min(device_iters, max_mc_iter - iters_done)
                if profiler is not None:
                    name = "mc_chunk" if n in compiled else "compile"
                    compiled.add(n)
                    with profiler.phase(name):
                        be, ble, nb, nblk = run_chunk(float(ebno_dbs[i]), n)
                else:
                    be, ble, nb, nblk = run_chunk(float(ebno_dbs[i]), n)
                bit_errors[i] += be
                block_errors[i] += ble
                nb_bits[i] += nb
                nb_blocks[i] += nblk
                iters_done += n
                iters_state[i] = iters_done
                save_checkpoint()

                if (num_target_bit_errors is not None
                        and bit_errors[i] >= num_target_bit_errors):
                    status[i] = "reached target bit errors"
                    point_done = True
                if (num_target_block_errors is not None
                        and block_errors[i] >= num_target_block_errors):
                    status[i] = "reached target block errors"
                    point_done = True
                if callback is not None:
                    cb_ret = callback(iters_done, i, ebno_dbs, bit_errors,
                                      block_errors, nb_bits, nb_blocks)
                    if cb_ret is True:
                        status[i] = "callback stop"
                        point_done = True
            if not status[i]:
                status[i] = "reached max iter"
            runtimes[i] = time.perf_counter() - t0
            save_checkpoint()

            ber_i = bit_errors[i] / max(nb_bits[i], 1)
            bler_i = block_errors[i] / max(nb_blocks[i], 1)
            if verbose:
                print(f"{ebno_dbs[i]:9.3f} | {ber_i:9.3e} | {bler_i:9.3e} |"
                      f" {bit_errors[i]:11d} | {nb_bits[i]:11d} |"
                      f" {block_errors[i]:12d} | {nb_blocks[i]:11d} |"
                      f" {runtimes[i]:11.2f} | {status[i]}")

            # Sweep-level early stopping (monotonic SNR assumption)
            if early_stop and block_errors[i] == 0:
                stop_sweep = True
                if verbose:
                    print(f"\nSimulation stopped as no error occurred "
                          f"@ EbNo = {ebno_dbs[i]:.1f} dB.\n")
            if target_ber is not None and ber_i < target_ber:
                stop_sweep = True
            if target_bler is not None and bler_i < target_bler:
                stop_sweep = True
    except KeyboardInterrupt:
        interrupted = True
        for j in range(num_points):
            if status[j] == "":
                status[j] = "interrupted"
        save_checkpoint()
        if forward_keyboard_interrupt:
            raise

    ber = np.where(nb_bits > 0, bit_errors / np.maximum(nb_bits, 1),
                   np.nan)
    bler = np.where(nb_blocks > 0,
                    block_errors / np.maximum(nb_blocks, 1), np.nan)
    if interrupted:
        ber = np.where(nb_bits > 0, ber, -1.0)
        bler = np.where(nb_blocks > 0, bler, -1.0)
    return torch.as_tensor(ber, dtype=torch.float64), \
        torch.as_tensor(bler, dtype=torch.float64)
