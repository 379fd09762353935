"""Monte-Carlo BER/BLER simulation loop.

PyTorch counterpart of ``sionna_tpu/phy/utils/sim.py`` on one device. A
Python loop runs the MC iterations; error counters stay on the device of
the model's output and are read by the host once per chunk of
``device_iters`` iterations, where the stopping conditions are checked,
as the JAX version polls its fused chunks.

``mc_fun(batch_size, ebno_db)`` takes a Python float ``ebno_db`` and
returns ``(b, b_hat)``; it draws its own random numbers (from its
blocks' generators or ``config.generator``).
"""

import time

import numpy as np
import torch

from .misc import hard_decisions

__all__ = ["sim_ber"]


def sim_ber(mc_fun, ebno_dbs, batch_size, max_mc_iter,
            soft_estimates=False,
            num_target_bit_errors=None,
            num_target_block_errors=None,
            target_ber=None,
            target_bler=None,
            early_stop=True,
            distribute=None,
            device_iters=None,
            verbose=True,
            forward_keyboard_interrupt=True,
            callback=None,
            checkpoint_path=None):
    """Simulates until target errors or ``max_mc_iter`` per SNR point.

    Returns ``(ber, bler)`` float64 CPU tensors of the same length as
    ``ebno_dbs``. Points skipped due to early stopping are ``nan``;
    after a keyboard interrupt, points never simulated are ``-1``.
    """
    if distribute is not None:
        raise NotImplementedError(
            "sim_ber(distribute=...) is not ported yet (multi-GPU "
            "through torch.distributed): see ROADMAP.md, queue 1 item 22")
    if checkpoint_path is not None:
        raise NotImplementedError(
            "sim_ber(checkpoint_path=...) is not ported yet: see "
            "ROADMAP.md, queue 1 item 13")
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

    if verbose:
        print("EbNo [dB] |       BER |      BLER |  bit errors |"
              "    num bits | block errors |  num blocks | runtime [s] |"
              "    status")
        print("-" * 126)

    def run_chunk(ebno_db, n):
        """n MC iterations; returns the four counters, read once."""
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
        bit_e, blk_e = errs.tolist()
        return bit_e, blk_e, nb, nblk

    stop_sweep = False
    interrupted = False
    try:
        for i in range(num_points):
            if stop_sweep:
                status[i] = "not simulated"
                continue
            t0 = time.perf_counter()
            iters_done = 0
            point_done = False
            while iters_done < max_mc_iter and not point_done:
                n = min(device_iters, max_mc_iter - iters_done)
                be, ble, nb, nblk = run_chunk(float(ebno_dbs[i]), n)
                bit_errors[i] += be
                block_errors[i] += ble
                nb_bits[i] += nb
                nb_blocks[i] += nblk
                iters_done += n

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
