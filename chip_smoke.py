"""Smoke test of the PyTorch port on one CUDA card (an H100).

Drives the port's main paths on the card and checks that they went
through the hand-written CUDA kernels of the lifted LDPC decoder, K1
(flooding, ``csrc/ldpc_lifted_bp.cu``) and K3 (layered,
``csrc/ldpc_layered_bp.cu``), each with the variants of the Pallas
kernel's knobs (f32 or bf16 message storage; K1 also the ratio form of
the boxplus magnitude):

1. prints the card (``nvidia-smi``) and the torch/CUDA versions, and
   checks that blocks built without a ``device`` land on ``cuda:0``;
2. builds both kernels from ``sionna_tpu_torch/csrc`` (one nvcc each,
   started together) and prints ptxas's report of every variant
   (registers, stack, spills; a K3 variant with a stack frame or spills
   fails), and counts the FP32 instructions and operations of
   tanhf/log1pf/logf/division on the path a call executes, in their SASS
   (``sionna_tpu_torch.tools.sass_ops``), for the kernels' bounds;
3. holds K1 f32, K1 bf16 and K1 ratio against their plain torch
   versions, for four codes (the last, BG1 at Z=384, in K1's cluster
   layout, the others in its one-block layout), three check-node rules,
   0/1/20 iterations, two SNRs; prints each code's K1 layout;
4. holds K3 f32 and K3 bf16 against their plain torch versions, for the
   same four codes and the largest 5G code (BG1, Z=384, rate 1/3: five
   blocks in f32, three in bf16), the same rules, 0/1/10 iterations, two
   SNRs, and fails unless both K3 layouts ran (one block: bf16 at
   n=12288; a cluster: f32 at n=12288, BG1 at Z=384); prints each code's
   K3 layouts;
5. runs the README quick-start link (5G LDPC k=1024, n=2048, 16-QAM,
   AWGN, APP demapper, BP-20 boxplus, batch 2000) through ``sim_ber`` at
   Eb/N0 3 and 4 dB: BLER bands, every tensor on the card, one K1
   launch per decoder call;
6. runs the flagship link (bench.py:110-131: TDL-A OFDM, 256-FFT grid
   with Kronecker pilots, 16-QAM, LDPC k=6144 n=12288, LS-NN estimation,
   LMMSE, APP demapper, boxplus BP-20, batch 2048) through ``sim_ber``
   at Eb/N0 8 and 5 dB: BLER bands from a JAX run of the same link, every
   tensor on the card, one K1 launch per decoder call;
7. the same link with ``cn_schedule="layered"`` on the lifted engine
   (``engine="pallas"``), 10 iterations, at 8 dB: its band, one K3
   launch per decoder call;
8. times (CUDA events, warm-up excluded) every kernel variant against
   its plain version at the flagship's n=12288 x 2048 (BP-20 flooding,
   layered-10), K1 (BP-20) and K3 f32 (layered-10) at the link's
   n=2048 x 2000, and K1 f32 and both K3 variants at BG1's n=16896 x
   2048 (the cluster layouts), each output first held identical to the
   plain one at that shape, with its bound and share of it and the
   kernel's launch configuration; the flagship's Mbit/s and per-stage
   split, the device busy share, the coded-AWGN link's Mbit/s;
9. runs the decoder-kernel tuning sweep
   (``python -m sionna_tpu_torch.tools.ldpc_tune --quick``), the entry
   point of the bf16 and ratio variants: each launched, hard-decision
   checksums printed, and the bf16 flip rate against f32;
10. runs the generic-code link (the 802.11n LDPC code n=648 of
    ``load_parity_check_examples(4)``, ``pcm2gm`` -> ``LinearEncoder``,
    BPSK, AWGN, ``LDPCBPDecoder`` boxplus-phi BP-20 on the segment
    engine, batch 10000) through ``sim_ber`` at Eb/N0 1.5 and 2 dB:
    BLER bands from a JAX run of the same link, no lifted kernel
    launched;
11. runs the quick-start link of phase 5 with ``engine="segment"``: the
    phase-5 bands, and its ms per decoder call beside K1's;
12. takes three SGD steps of weighted BP (``WeightedBPCallback`` weights
    on the v2c messages of the link's decoder, segment engine, BCE loss)
    with every tensor on the card: finite loss and gradients;
13. holds the demapper's separable-PAM path (the default for Gray QAM)
    against its table path (a ``points`` override) at the flagship's
    shape (batch 2048 x 3072 16-QAM symbols, app and maxlog): the LLRs
    within the bound of ``tests/test_torch_mapping.py``, and each path's
    ms per call in turns;
14. runs the flagship's receiver variants through ``sim_ber`` at 8 dB,
    BP-20 through K1: LS with linear interpolation and the LMMSE
    equalizer, time-averaged linear and ZF, ``LMMSEInterpolator("t-f")``
    from the TDL-A covariances and LMMSE (batch 256, its memory; peak
    printed), nearest-neighbour and MF: BLER bands from a JAX run of the
    same links (``tools/flagship_rx_bler.py``), one K1 launch per decoder
    call, every tensor on the card, each estimator against itself on the
    CPU, the estimation and equalization stages timed; the first again
    from a checkpoint (no decoder call, the same BLER) and the last with
    a ``Profiler``;
15. runs the polar link of bench.py:272-325 (``Polar5GEncoder(512,
    1024)``, QPSK, AWGN, APP demapper, ``Polar5GDecoder``) through
    ``sim_ber``: SC at batch 8192 (1.5 dB) and SCL-8 (``use_spc=True``)
    at batch 4096 (1.0 dB);
16. runs a terminated rate-1/2 K=7 convolutional code (Viterbi and BCJR
    decoders, 2.5 dB) and the rate-1/3 LTE turbo code (6 iterations, 0.3
    dB), k=1024, QPSK over AWGN, through ``sim_ber``.

17. runs BASELINE config 3, ``examples/03_mimo_ofdm_cdl.py`` at its
    widths (128-FFT grid at 30 kHz, 4 streams, 4 x 4 cross-polarized
    38.901 arrays, CDL-B uplink, 16-QAM, LDPC n=6144, LS "lin",
    ``LinearDetector("lmmse", "bit", "app")``, min-sum BP-12 through
    K1's min-sum variant), through ``sim_ber`` at batch 512 and 8 dB;
18. runs the same widths downlink in the time domain: RZF precoding,
    ``OFDMModulator``, ``cir_to_time_channel`` and ``ApplyTimeChannel``
    over ~1,900 CDL time steps, ``OFDMDemodulator``, LS "nn", LMMSE and
    boxplus-phi BP-20 through K1, batch 64, 10 dB; its modulator and
    demodulator on one batch against themselves on the CPU;
19. runs the detector links of ``tests/test_integration_detectors.py``
    at a 128-FFT grid (CDL-A, 4 streams, 8 BS antennas, QPSK, perfect
    CSI, batch 64): LMMSE, K-best (k=16), EP (l=10), MMSE-PIC (3
    iterations) and ML (max-log), bit output, decoded by K1; each
    detector's hard decisions on one batch against the same detector on
    the CPU, its ms and launches per call.

Phases 17-19 run in a process of their own: each link through
``sim_ber`` against its band from a JAX run of the same link
(``tools/mimo_ofdm_cdl_bler.py``), every tensor on ``cuda:0``, one K1
launch per decoder call; they print ms per stage (CUDA events), per MC
iteration, the info-bit Mbit/s and the peak memory. No kernel is
written for them: the JAX package's CDL, precoders and detectors are
XLA code. Phase 17 is the main path of K1's min-sum variant, whose
launches the kernels line reports.

20. runs BASELINE config 5 as ``bench.bench_sys`` does
    (``sionna_tpu_torch.tools.sys_slots.MulticellSlots``: a hexagonal
    grid of 21 UMi sectors with 4 UTs each, the distance-proxy SINR,
    ``PHYAbstraction``, OLLA's ``step`` at a BLER target of 0.1, 1000
    REs per UT): 50 slots per call, one warm-up call, 3 timed calls with
    one host read each, every slot under ``torch.cuda``'s sync debug
    mode "error" (a slot that reads the card back fails); prints
    ``sys_multicell_slots_per_s``; the NACK share inside its band from
    ``tools/sys_ref.py --part slots``, the drop equal to the JAX
    package's (its SHA-256);
21. runs the same grid at 10 UTs per sector (210 UTs) with the TR 38.901
    UMi channel (omni arrays, downlink) over 14 symbols x 612
    subcarriers at 30 kHz for 20 slots
    (``sionna_tpu_torch.tools.sys_slots.DownlinkSlots``: CIR -> OFDM,
    pathloss, PF scheduling per sector, fair downlink power control,
    spreading, CBF effective channel and LMMSE post-equalization SINR,
    OLLA, EESM, PHY abstraction): ms per stage (CUDA events), slots/s,
    peak memory; the mean and standard deviation of the 4,410 links'
    gain [dB], of the drop's draw and of each of 16 repetitions of new
    LSPs and one channel, inside the band of one JAX repetition, and
    their means over the repetitions inside the band of the difference
    of means (``tools/sys_ref.py --part gain``);
22. makes BLER table points on the card with
    ``PHYAbstraction.new_bler_table`` (PUSCH, MCS table 1, MCS 5, 14 and
    20, code blocks of 1000 bits, three SNRs each) through
    ``CodedAWGNChannelNR``, whose decoder is K1: one K1 launch per
    decoder call, each BLER inside its band from ``tools/sys_ref.py
    --part bler`` and printed beside the shipped table's value; then K1
    at each MCS's code (x 2000, BP-20) held identical to its plain
    decode, both timed in turns, and its bound.

Phases 20-22 run in a process of their own, every tensor on ``cuda:0``.
No kernel is written for them: the JAX package's SYS blocks and
system-level channel are XLA code; phase 22's decoder runs K1.

23. holds the port's ``PUSCHTransmitter`` on the card to 12 of the
    reference's stored waveforms (``tests/nr/pusch_test_configs``, the
    ones ``tests/test_nr.py`` runs; within 1e-5) and ``TBEncoder`` to
    every ``tests/nr/tb_refs`` case, bit-exact with and without the
    scrambler, every output on ``cuda:0``;
24. runs the PUSCH tutorial's link (``docs/tutorials/04_5g_nr_pusch.md``:
    16 PRBs at 30 kHz, 2 ports, 2 layers, codebook TPMI 1, DMRS type 1
    with one additional position, MCS 14) over config 3's CDL-B uplink
    through ``OFDMChannel`` with AWGN, ``PUSCHReceiver``'s default chain
    (LS "lin", LMMSE max-log, ``TBDecoder`` boxplus-phi BP-20 on K1),
    through ``sim_ber`` at 3.5 dB and batch 256: the TB BLER inside the
    band of ``tools/pusch_bler.py`` (the JAX link on the CPU), one K1
    launch per ``TBDecoder`` call; then perfect CSI, the time domain
    (``TimeChannel``, ``OFDMDemodulator``) and the min-sum ``TBDecoder``
    (BP-12, K2) on one batch at 15 dB: BER 0, one launch of the right
    variant;
25. runs the same settings at 273 PRBs (100 MHz at 30 kHz: a 167,976-bit
    TB in 20 code blocks of BG1 at Z=384, n=15728), batch 64: ms per
    stage (CUDA events), per MC iteration, the info-bit Mbit/s, one K1
    launch per iteration, the peak memory; K1 alone on the iteration's
    own decoder input (1,280 codewords, BP-20) identical to its plain
    decode, timed in turns with it, beside its bound; and the launches
    and device busy share of one iteration (``torch.profiler``).

Phases 23-25 run in a process of their own. No kernel is written for
them: the JAX package's NR blocks are NumPy and XLA code; their
``TBDecoder`` runs K1 (K2 for min-sum).

26. runs coded MIMO over spatially correlated flat fading (the
    reference's ``Simple_MIMO_Simulation``, ``tools/flat_fading_bler.py``:
    4 x 16 antennas, ``KroneckerModel(exp_corr_mat(0.4, 4),
    exp_corr_mat(0.9, 16))``, 16-QAM, ``LDPC5GEncoder(512, 1024)`` (BG2,
    Z=64), ``FlatFadingChannel``, ``lmmse_equalizer``, APP demapper,
    ``LDPC5GDecoder`` BP-20 on K1) through ``sim_ber`` at batch 4096 and
    3.5 dB, and ``BinarySymmetricChannel(return_llrs=True)`` into the
    same decoder at pb 0.085: BLER bands from the JAX links on the CPU,
    one K1 launch per decoder call, every tensor on ``cuda:0``; the MIMO
    link's ms per stage (CUDA events), per MC iteration, Mbit/s and peak
    memory; ``PerColumnModel``, Rayleigh block fading and a
    ``CIRDataset`` of its draws into ``OFDMChannel`` against themselves on
    the CPU; K1 alone at the links' n=1024 x 16,384 held identical to its
    plain decode, timed in turns with it, beside its bound;
27. runs the pulse-shaping tutorial (``docs/tutorials/10_pulse_shaping.md``:
    RRC span 32, 4 samples per symbol, beta 0.22, 16-QAM [64, 1024],
    upsampling, shaping, matched filter, downsampling): the symbols back
    within the truncated RRC's ISI floor, the empirical ACLR near the
    filter's, each filter class with and without each window against
    itself on the CPU, ms per call;
28. runs the optical tutorial's link (``docs/tutorials/09_optical_channel.md``:
    10 spans of ``SSFM(n_ssfm=200, length=80)`` and a transparent
    ``EDFA(f=5)`` on a [2, 1024] waveform), as written and with
    ``with_manakov=True``: noise-free (g = 1, no amplification) the card
    against the CPU after one span and after ten, in single and double
    precision; the ASE power at the output against its analytic value;
    the adaptive schedule's step count on the card and on the CPU; ms and
    launches per span.

Phases 26-28 run in a process of their own. No kernel is written for
them: the JAX package's signal and channel blocks are NumPy and XLA
code; phase 26's decoder runs K1.

29. runs BASELINE config 4's canyon path solve as bench.py:334-360 does
    (``simple_street_canyon`` at 3.5 GHz, iso V arrays, tx at [-20, 0,
    10], rx at [20, 5, 1.5], ``PathSolver()`` with no device, depth 3,
    200,000 rays): ``rt_path_solver_ray_segments_per_s`` (one warm-up,
    the median of 3 host-synced solves), the peak memory and the host
    syncs per solve; the valid paths per interaction depth and the total
    gain against the JAX package's on the CPU (``tools/rt_ref.py``); the
    same solve by the port on the CPU in float64: the same valid
    interaction sequences, tau and |a| within bounds; ``Paths.cir``
    through ``cir_to_ofdm_channel`` on the card; ``trace_functional``'s
    gradients on the card against the CPU's;
30. runs bench.py's city (``make_city(10, 10, subdiv=10)``: 100,200
    triangles, so the clustered acceleration structure; tx at [0, 0, 30],
    rx at [0, 32, 1.5], depth 2, 100,000 rays):
    ``rt_city100k_ray_segments_per_s``, the peak memory, the accel's ray
    chunks, skips and dense repair sweeps and the host syncs per solve;
    the native cluster builder's compile and build times (it fails if the
    NumPy builder ran); ``nearest_hit_accel`` and
    ``any_blocking_hit_accel`` on 8,192 of the solve's rays against the
    dense sweep on the card (t identical, ids equal where t is unique);
    a cut city (``make_city(3, 3, subdiv=4)``, accelerated) against the
    JAX package's paths on the CPU;
31. runs bench.py's radio map (200 x 200 cells of 1 m at height 1.5 on
    the canyon, depth 2, 100,000 rays, ``RadioMapSolver()``):
    ``rt_radio_map_cells_per_s``, the peak memory and host syncs; the
    map's statistics against the JAX package's on the CPU; a coarse map
    on the card against the port on the CPU; ``output="gain"`` against
    the paths' reduction for four receivers.

Phases 29-31 run in a process of their own, every tensor of a solve on
``cuda:0``. No kernel is written for them: the JAX package's ray tracer
is XLA code with no Pallas kernel (``sionna_tpu/rt/``), so the port's is
plain torch.

Phases 15 and 16 run in a process of their own; each link is held to
its BLER band from a JAX run of the same link
(``tools/fec_links_bler.py``), with every tensor on the card and no
lifted kernel launched, and its decoder on one batch against the same
decoder on the CPU; they print ms per decoder call, launches per call,
the stages of an MC iteration and the info-bit Mbit/s (the polar ones
under bench.py's names). No kernel serves them: the JAX package's
polar, convolutional and turbo decoders are XLA code.

Prints the kernels' JSON line (one entry per kernel variant, ``ms`` /
``plain_ms`` / ``bound_ms`` at the entry's ``shape``), the card again,
and last ``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
Run from the repository root: ``python3 chip_smoke.py``.
"""

import functools
import glob
import hashlib
import json
import multiprocessing
import os
import pickle
import queue
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sionna_tpu_torch.phy import (AWGN, BinarySource, Demapper, Mapper,
                                  QAMSource, config)
from sionna_tpu_torch.phy.channel import (ApplyTimeChannel,
                                          BinarySymmetricChannel, CIRDataset,
                                          FlatFadingChannel,
                                          GenerateFlatFadingChannel,
                                          KroneckerModel, OFDMChannel,
                                          PerColumnModel, RayleighBlockFading,
                                          TimeChannel, cir_to_ofdm_channel,
                                          cir_to_time_channel, exp_corr_mat,
                                          subcarrier_frequencies,
                                          time_lag_discrete_time_channel)
from sionna_tpu_torch.phy.channel.optical import EDFA, SSFM
from sionna_tpu_torch.phy.channel.tr38901 import CDL, TDL, AntennaArray
from sionna_tpu_torch.phy.fec.interleaving import (Deinterleaver,
                                                   RowColumnInterleaver)
from sionna_tpu_torch.phy.fec.ldpc import (LDPC5GDecoder, LDPC5GEncoder,
                                           LDPCBPDecoder, WeightedBPCallback)
from sionna_tpu_torch.phy.fec.ldpc.decoding import (LAYERED_BP_KERNEL,
                                                    LIFTED_BP_KERNEL,
                                                    layered_bp_cuda,
                                                    lifted_bp_cuda)
from sionna_tpu_torch.phy.fec.conv import (BCJRDecoder, ConvEncoder,
                                           ViterbiDecoder)
from sionna_tpu_torch.phy.fec.linear import LinearEncoder
from sionna_tpu_torch.phy.fec.polar import Polar5GDecoder, Polar5GEncoder
from sionna_tpu_torch.phy.fec.turbo import TurboDecoder, TurboEncoder
from sionna_tpu_torch.phy.fec.utils import load_parity_check_examples, pcm2gm
from sionna_tpu_torch.phy.mimo import StreamManagement, lmmse_equalizer
from sionna_tpu_torch.phy.ofdm import (EPDetector, KBestDetector,
                                       LinearDetector, LMMSEEqualizer,
                                       LMMSEInterpolator, LSChannelEstimator,
                                       MaximumLikelihoodDetector,
                                       MFEqualizer, MMSEPICDetector,
                                       OFDMDemodulator, OFDMModulator,
                                       ResourceGrid, ResourceGridMapper,
                                       RZFPrecoder, ZFEqualizer,
                                       tdl_freq_cov_mat, tdl_time_cov_mat)
from sionna_tpu_torch.phy.nr import (PUSCHConfig, PUSCHReceiver,
                                    PUSCHTransmitter, TBDecoder, TBEncoder)
from sionna_tpu_torch.phy.nr.utils import CodedAWGNChannelNR
from sionna_tpu_torch.phy.signal import (CustomFilter, Downsampling,
                                         RaisedCosineFilter,
                                         RootRaisedCosineFilter, SincFilter,
                                         Upsampling, empirical_aclr)
from sionna_tpu_torch.phy.utils import Profiler, ebnodb2no, sim_ber
from sionna_tpu_torch.sys import PHYAbstraction
from sionna_tpu_torch.tools import ldpc_tune, sass_ops
from sionna_tpu_torch.tools.sys_slots import DownlinkSlots, MulticellSlots

LINK = dict(k=1024, n=2048, nbps=4, batch=2000, num_iter=20)
FLAGSHIP = dict(batch=2048, nbps=4, rate=0.5, mc_iter=8)
GENERIC = dict(pcm_id=4, batch=10000, mc_iter=10, num_iter=20)
# An H100 SXM's published peaks at its 700 W limit (HBM3, FP32 outside
# the tensor cores): the bounds' two rates. FP32 instructions issue at
# half the operation rate (one per lane and clock, an FFMA being two
# operations): the tighter bound printed beside it.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_F32_ISSUE_S = PEAK_F32_OPS_S / 2
KERNELS = (LIFTED_BP_KERNEL, LAYERED_BP_KERNEL)
_DEC = "sionna_tpu/phy/fec/ldpc/decoding.py"
# Every kernel variant: (name in the kernels line, the tuning sweep's
# label, kernel, variant as the wrapper counts it, TPU code it
# replaces); its knobs are those of its label in ldpc_tune.KERNEL_VARIANTS.
# K1's min-sum check node (K2) is a property of the decoder's code, not a
# knob: no sweep label, f32 knobs on a min-sum decoder (phase 17's)
VARIANTS = [
    ("ldpc_lifted_bp", "K1 f32", LIFTED_BP_KERNEL, "f32",
     LIFTED_BP_KERNEL.replaces),
    ("ldpc_lifted_bp_bf16", "K1 bf16", LIFTED_BP_KERNEL, "bf16",
     f"{_DEC}:1141"),
    ("ldpc_lifted_bp_ratio", "K1 f32 ratio", LIFTED_BP_KERNEL, "f32+ratio",
     f"{_DEC}:880"),
    ("ldpc_lifted_bp_minsum", None, LIFTED_BP_KERNEL, "f32+minsum",
     f"{_DEC}:886"),
    ("ldpc_layered_bp", "K3 layered f32", LAYERED_BP_KERNEL, "f32",
     LAYERED_BP_KERNEL.replaces),
    ("ldpc_layered_bp_bf16", "K3 layered bf16", LAYERED_BP_KERNEL, "bf16",
     f"{_DEC}:1195"),
]

# Flagship BLER bands from the JAX package's run of the same link on the
# CPU (bench._flagship_step with ldpc_engine="lifted", one block per key,
# seeds 0 and 1 pooled): (block errors, blocks) per point. The band is
# the JAX estimate +- 5 standard errors of the difference between it and
# this script's estimate (FLAGSHIP["mc_iter"] x 2048 blocks), the
# variance taken at a rate at least one block away from 0 and 1.
FLAGSHIP_JAX = {("flooding", 8.0): (12171, 24576),
                ("flooding", 5.0): (8192, 8192),
                ("layered", 8.0): (13291, 24576)}
# Generic-code link BLER (codeword errors) from the JAX package's run of
# the same link on the CPU (BinarySource, LinearEncoder(pcm2gm(pcm)),
# Mapper/Demapper("app", "pam", 1), AWGN, LDPCBPDecoder(pcm, num_iter=20),
# batch 10000, keys PRNGKey(1000 + i) for i < 20): (block errors, blocks)
GENERIC_JAX = {("generic", 1.5): (27875, 200000),
               ("generic", 2.0): (3657, 200000)}
# The flagship's receiver variants (phase 14): (interpolation,
# equalizer, batch, MC iterations); "lmmse" is LMMSEInterpolator("t-f")
# from the TDL-A covariances, whose frequency pass solves a 256 x 256
# f64 system per OFDM symbol and batch element (batch 256: its memory)
RECEIVERS = {"lin_lmmse": ("lin", "lmmse", 2048, 8),
             "lintavg_zf": ("lin_time_avg", "zf", 2048, 8),
             "lmmse_lmmse": ("lmmse", "lmmse", 256, 64),
             "nn_mf": ("nn", "mf", 2048, 8)}
# Their BLER at 8 dB (flooding BP-20) from the JAX package's run of the
# same links on the CPU (tools/flagship_rx_bler.py: seeds 0 and 1 at
# --blocks 8192 --batch 64; the LMMSE interpolation seeds 0-7 at --blocks
# 4096 --batch 16): (block errors, blocks)
RECEIVERS_JAX = {("lin_lmmse", 8.0): (6093, 16384),
                 ("lintavg_zf", 8.0): (2118, 16384),
                 ("lmmse_lmmse", 8.0): (265, 32768),
                 ("nn_mf", 8.0): (8095, 16384)}
# The FEC links of phases 15 and 16 (tools/fec_links_bler.py: QPSK over
# AWGN, APP demapper): Eb/N0 in dB, batch, MC iterations through sim_ber.
# The polar batches are bench.py's (bench.py:272-325); the conv and turbo
# decoders' eager loops over time keep their block counts small
FEC_LINKS = {"polar_sc": dict(ebno_db=1.5, batch=8192, mc_iter=20),
             "polar_scl8": dict(ebno_db=1.0, batch=4096, mc_iter=20),
             "conv_viterbi": dict(ebno_db=2.5, batch=2048, mc_iter=16),
             "conv_bcjr": dict(ebno_db=2.5, batch=2048, mc_iter=16),
             "turbo": dict(ebno_db=0.3, batch=4096, mc_iter=5)}
# Their BLER from the JAX package's run of the same links on the CPU
# (tools/fec_links_bler.py at --batch 2048 --blocks 32768: SC seeds 0-3,
# the others seed 0; SCL-8 at --batch 1024 --blocks 16384, seeds 0-5):
# (block errors, blocks)
FEC_JAX = {("polar_sc", 1.5): (55819, 131072),
           ("polar_scl8", 1.0): (25615, 98304),
           ("conv_viterbi", 2.5): (6658, 32768),
           ("conv_bcjr", 2.5): (7112, 32768),
           ("turbo", 0.3): (11717, 32768)}
# Blocks whose decisions may differ between a decoder on the card and on
# the CPU on the same LLRs (exp/log round differently there), per 1000
FEC_CPU_DIFF_PER_MILLE = 10
# The separable demap against the table demap: a few ULP of the largest
# exponent of the symbol, max_p |y - p|^2 / no (SEP_TABLE_ULPS of
# tests/test_torch_mapping.py)
SEP_TABLE_ULPS = 8
# The MIMO-OFDM links over CDL of phases 17-19 (tools/mimo_ofdm_cdl_bler.py):
# Eb/N0 in dB, batch (of 4-stream grids: 4 blocks each), MC iterations
# through sim_ber. ul_freq is BASELINE config 3 at batch 512
# (2048 codewords per iteration); dl_time and the detectors at the
# example's batch 64
MIMO_LINKS = {"ul_freq": dict(ebno_db=8.0, batch=512, mc_iter=16),
              "dl_time": dict(ebno_db=10.0, batch=64, mc_iter=64),
              "det_lmmse": dict(ebno_db=-2.0, batch=64, mc_iter=32),
              "det_kbest": dict(ebno_db=-6.0, batch=64, mc_iter=32),
              "det_ep": dict(ebno_db=-4.0, batch=64, mc_iter=32),
              "det_mmsepic": dict(ebno_db=-2.0, batch=64, mc_iter=32),
              "det_ml": dict(ebno_db=-6.0, batch=64, mc_iter=32)}
MIMO_STREAMS = 4
# Their BLER from the JAX package's run of the same links on the CPU
# (tools/mimo_ofdm_cdl_bler.py, seeds 0 and 1 pooled: ul_freq at --blocks
# 32768 --batch 32, dl_time at --blocks 8192 --batch 8, the detectors at
# --blocks 8192 --batch 16): (block errors, blocks)
MIMO_JAX = {("ul_freq", 8.0): (16565, 65536),
            ("dl_time", 10.0): (4627, 16384),
            ("det_lmmse", -2.0): (5368, 16384),
            ("det_kbest", -6.0): (1414, 16384),
            ("det_ep", -4.0): (2171, 16384),
            ("det_mmsepic", -2.0): (4935, 16384),
            ("det_ml", -6.0): (1259, 16384)}
# Bits whose detector decisions may differ between the card and the CPU
# on the same inputs (Cholesky, QR and exp/log round differently there:
# only LLRs within rounding of 0 flip), per 1000
DET_CPU_DIFF_PER_MILLE = 1
# BASELINE config 5 (phases 20-22), with the seeds and widths of
# tools/sys_ref.py, whose JAX runs on the CPU give the references below
SYS_SLOTS = dict(seed=0, slots_per_call=50, calls=3)
SYS_DOWNLINK = dict(seed=1, slots=20)
SYS_BLER = dict(seed=2, cbs=1000, batch=2000, mc_iter=10)
SYS_BLER_POINTS = {5: (-1.0, -0.75, -0.5), 14: (6.5, 6.75, 7.0),
                   20: (12.0, 12.5, 13.0)}
# tools/sys_ref.py --part slots --reps 20: NACKs and HARQ outcomes over
# bench_sys's three timed calls, 20 repetitions pooled; the drop's SHA-256
SYS_SLOTS_JAX = (22023, 252000)
SYS_SLOTS_TOPOLOGY = ("c649dbbcb6a348c17050c505348df3034ceb46e87"
                      "32b10b85361def4eefea11f")
# tools/sys_ref.py --part gain --reps 16: the links' gain [dB], mean and
# standard deviation over the 4,410 links, each as (mean over the
# repetitions, their sample standard deviation); the drop's SHA-256
SYS_GAIN_JAX = {"mean": (-129.2312421798706, 0.15979618041462054),
                "std": (15.425802409648895, 0.11441043637133586)}
SYS_GAIN_REPS = 16
# phase 21 draws the same statistic on the port this many times, each
# repetition with its own LSPs and channel from its own generator seed
SYS_GAIN_PORT_REPS = 16
SYS_GAIN_TOPOLOGY = ("73e2c6affbd0eb3c7720987955d6cdb0418543c764f31"
                     "efee780fff3c125dd94")
# tools/sys_ref.py --part bler --batch 2000 --iters 10 --reps 2: (block
# errors, blocks) per (MCS, SNR dB)
SYS_BLER_JAX = {(5, -1.0): (32263, 40000), (5, -0.75): (17923, 40000),
                (5, -0.5): (5318, 40000), (14, 6.5): (31782, 40000),
                (14, 6.75): (19616, 40000), (14, 7.0): (8056, 40000),
                (20, 12.0): (32196, 40000), (20, 12.5): (10890, 40000),
                (20, 13.0): (999, 40000)}
# The 5G NR PUSCH (phases 23-25): the stored references of tests/nr and
# their bound (tests/test_nr.py); the tutorial's link over CDL-B at 16
# PRBs through sim_ber (tools/pusch_bler.py: Eb/N0, batch of TBs, MC
# iterations), its checks at a high SNR, and the same settings at 273
# PRBs (100 MHz at 30 kHz), batch 64, at an SNR where every TB should
# decode
NR_DIR = "tests/nr"
# the 12 waveforms tests/test_nr.py holds the JAX package to (all 83
# take about 20 s of host work, the DMRS and CRC tables of each
# configuration; tests/test_torch_pusch.py runs them all on the CPU)
GOLDEN_IDS = (0, 5, 11, 19, 27, 35, 43, 51, 59, 67, 75, 82)
WAVEFORM_ATOL = 1e-5
PUSCH_FC = 3.5e9
PUSCH = dict(n_size_grid=16, ebno_db=3.5, batch=256, mc_iter=40)
PUSCH_CHECK = dict(ebno_db=15.0, batch=16)
PUSCH_FULL = dict(n_size_grid=273, ebno_db=10.0, batch=64)
PUSCH_FULL_MAX_BLER = 0.05
# the seed of the phases' random streams (bits, channels, noise)
PUSCH_SEED = 23
# Its TB BLER from the JAX package's run of the same link on the CPU
# (tools/pusch_bler.py --blocks 10240 --batch 256, seeds 0 and 1 pooled):
# (block errors, blocks)
PUSCH_JAX = (2292, 20480)

# Phases 26-28. The flat-fading MIMO link and the BSC link of
# tools/flat_fading_bler.py (4 x 16 antennas, Kronecker correlation 0.4
# at the transmitter and 0.9 at the receiver, 16-QAM, k=512, n=1024: BG2
# Z=64, BP-20 on K1): batch 4096 (16,384 codewords) and 16,384
# codewords per MC iteration, at the points of the bands
FLAT = dict(num_tx=4, num_rx=16, k=512, n=1024, nbps=4, ebno_db=3.5,
            batch=4096, mc_iter=8)
FLAT_BSC = dict(pb=0.085, batch=16384, mc_iter=8)
FLAT_SEED = 26
# Their BLER from the JAX package's run of the same links on the CPU
# (tools/flat_fading_bler.py, seeds 0 and 1 pooled: mimo at --blocks 65536
# --batch 1024, bsc at --blocks 65536 --batch 4096): (block errors, blocks)
FLAT_JAX = {"mimo": (47721, 131072), "bsc": (36161, 131072)}
# The blocks on the card against the same blocks on the CPU, of the
# largest magnitude: f32 products summed in other orders
FLAT_CPU_RTOL = 1e-5
# Pulse shaping (docs/tutorials/10_pulse_shaping.md): the noiseless
# cascade's error floor, the ISI of an RRC truncated to 32 symbols (6.2e-3
# on the port on the CPU), and the empirical ACLR of the shaped
# waveform against the filter's (0.0416 against 0.0395 there)
PULSE = dict(sps=4, span=32, beta=0.22, batch=64, num_symbols=1024)
PULSE_ISI_MAX = 1e-2
PULSE_ACLR_RTOL = 0.1
PULSE_CPU_RTOL = 1e-5
# The optical link (docs/tutorials/09_optical_channel.md): 10 spans of
# 80 km (200 SSFM steps each) and a transparent EDFA of noise figure 5 on
# a [2, 1024] waveform; noise-free, the card against the CPU per
# precision after one span and after the link; the adaptive schedule over
# 10 km of a pulse. Over the link, cuFFT's and pocketfft's f32 roundings
# add up (about 3e-5 per span): the link's single-precision bound is held
# an order below single precision's own error, the f32 link against the
# f64 one, which the phase prints (about 4e-4 after one span)
OPTICAL = dict(spans=10, n_ssfm=200, length=80.0, alpha=0.046, samples=1024,
               f=5.0)
OPTICAL_RTOL = {"single": 1e-4, "double": 1e-9}
OPTICAL_LINK_RTOL = {"single": 1e-3, "double": 1e-9}
OPTICAL_ADAPTIVE = dict(length=10.0, phase_inc=1e-3)

# Phases 29-31 (BASELINE config 4, the ray tracer, bench.py:332-410): the
# canyon path solve, the 100k-triangle city and the radio map at bench's
# widths. RT_JAX: the JAX package's numbers on the CPU
# (tools/rt_ref.py --part canyon|map|city): valid paths per number of
# interactions, total gain sum |a|^2; the map's cells above 1e-15, the
# mean and spread of their gain in dB, the largest gain, and every 97th
# cell's gain, with the positions in that sample of the cells that a
# corner path reaches (a reflection where two planes meet: its
# zero-length segment has no direction, ROADMAP.md "Not faults"); the
# city cut (make_city(3, 3, subdiv=4), the accelerated path forced)
RT_CANYON = dict(tx=[-20., 0., 10.], rx=[20., 5., 1.5], max_depth=3,
                 samples=200_000)
RT_MAP = dict(cell_size=(1., 1.), size=(200, 200), center=(0., 0., 1.5),
              max_depth=2, samples=100_000)
RT_CITY = dict(nx=10, ny=10, subdiv=10, tx=[0., 0., 30.], rx=[0., 32., 1.5],
               max_depth=2, samples=100_000, check_rays=8192)
RT_CITY_CUT = dict(nx=3, ny=3, subdiv=4, tx=[-16., -16., 30.],
                   rx=[-16., 16., 1.5], max_depth=2, samples=20_000)
RT_JAX_MAP_SAMPLE = [
    1.82235772e-11, 4.1987195e-11, 1.06643548e-11, 4.40945232e-11,
    1.18485725e-11, 4.57983373e-11, 1.31851934e-11, 4.69865154e-11,
    1.46940446e-11, 4.75703157e-11, 1.63968457e-11, 4.74980957e-11,
    1.83169729e-11, 4.67644985e-11, 2.04791722e-11, 4.54111228e-11,
    2.29086194e-11, 4.35188136e-11, 2.56296408e-11, 4.1194638e-11,
    2.86635871e-11, 3.85561305e-11, 3.20253719e-11, 3.57181264e-11,
    3.57181264e-11, 3.27831581e-11, 4.02976992e-11, 2.95281542e-11,
    4.40052508e-11, 2.52424869e-11, 4.84705436e-11, 2.28162749e-11,
    5.29853314e-11, 1.10772891e-10, 5.73537502e-11, 1.00177479e-11,
    1.13293784e-11, 1.12965618e-11, 6.46038362e-11, 1.27765082e-11,
    6.69053007e-11, 1.44927742e-11, 6.79895862e-11, 1.6486713e-11,
    6.77216547e-11, 1.88061771e-11, 6.61022903e-11, 2.15065361e-11,
    6.32671832e-11, 2.46503651e-11, 5.94535532e-11, 2.83072506e-11,
    5.49480531e-11, 3.25523011e-11, 5.00364541e-11, 3.74621341e-11,
    4.49695385e-11, 4.31080692e-11, 3.95523163e-11, 4.95432306e-11,
    3.3036917e-11, 5.67812151e-11, 2.90390524e-11, 6.47614462e-11,
    1.44226728e-10, 7.33023156e-11, 1.48172419e-10, 8.20454191e-11,
    8.58448122e-12, 9.04147104e-11, 9.78251161e-12, 9.76261849e-11,
    1.12110564e-11, 1.02792316e-10, 1.29449429e-11, 1.05127712e-10,
    1.50253161e-11, 1.04192224e-10, 1.75341668e-11, 1.00050232e-10,
    6.04149456e-12, 9.32439681e-11, 2.42751895e-11, 8.46006598e-11,
    2.87962362e-11, 7.49905832e-11, 3.43348648e-11, 6.51568799e-11,
    4.11287775e-11, 5.21752502e-11, 4.94574486e-11, 4.42904567e-11,
    5.96335689e-11, 1.91640009e-10, 7.19767648e-11, 1.96782368e-10,
    8.67508981e-11, 2.02093495e-10, 1.04031173e-10, 1.35508105e-09,
    1.23462116e-10, 7.90717491e-12, 1.4389534e-10, 8.86305959e-12,
    1.63046451e-10, 9.99948041e-12, 1.7822277e-10, 1.13643244e-11,
    1.84565196e-10, 1.16643873e-11, 1.80758741e-10, 1.45658329e-11,
    1.68163747e-10, 1.87688181e-11, 1.48471346e-10, 2.23957762e-11,
    1.25905189e-10, 2.78439494e-11, 1.03390449e-10, 3.29480956e-11,
    7.78287088e-11, 4.07108722e-11, 6.77766662e-11, 5.09953781e-11,
    2.74596956e-10, 6.47982848e-11, 2.8101213e-10, 8.35208847e-11,
    2.03281592e-09, 1.16060085e-10, 2.01888772e-09, 1.43887846e-10,
    1.99863059e-09, 1.90514826e-10, 3.12101456e-10, 2.56780902e-10,
    3.21112414e-10, 3.16482063e-10, 3.30148353e-10, 3.79891313e-10,
    1.52376133e-11, 4.07927053e-10, 1.7344683e-11, 3.84732468e-10,
    2.25473529e-11, 3.7411434e-09, 2.56885208e-11, 3.063513e-09,
    2.95422263e-11, 2.38748554e-09, 3.43469801e-11, 1.28918334e-10,
    4.88914575e-10, 1.02903755e-10, 5.90182403e-10, 4.15036089e-10,
    7.27471416e-10, 3.38182615e-09, 9.20197918e-10, 3.33919892e-09,
    1.20200061e-09, 2.8599918e-09, 1.63358016e-09, 1.17050076e-08,
    2.32812525e-09, 1.03811475e-08, 3.49897888e-09, 2.07397988e-09,
    5.52958968e-09, 2.23326424e-09, 8.95937102e-09, 2.41171616e-09,
    1.37300029e-08, 2.61254263e-09, 1.66841385e-08, 2.83964185e-09,
    1.38307197e-08, 3.45712925e-09, 8.43640535e-09, 3.73557985e-09,
    4.54114479e-09, 4.05182332e-09, 4.03165012e-09, 7.20600107e-11,
    6.78405776e-09, 2.79170381e-10, 3.63502579e-08, 2.92263849e-08,
    2.94130071e-08, 3.34073604e-08, 2.36132607e-08, 3.92968076e-08,
    1.98256167e-08, 4.71767336e-08, 1.69115655e-08, 5.85923488e-08,
    1.46144288e-08, 7.62951302e-08, 8.46779624e-09, 1.0639728e-07,
    7.26089633e-09, 1.64237761e-07, 8.44203907e-09, 2.9088514e-07,
    9.28032406e-09, 5.64453501e-07, 1.02504707e-08, 7.81638505e-07,
    1.13819993e-08, 5.00291151e-07, 1.5295802e-08, 2.59246832e-07,
    1.79218578e-08, 1.50637632e-07, 1.97672012e-08, 1.00032885e-07,
    2.19875034e-08, 7.29132168e-08, 2.47111931e-08, 5.51770185e-08,
    2.81303016e-08, 3.0992549e-08, 3.2541621e-08, 2.47245016e-08,
    3.83401684e-08, 1.96077732e-08, 4.65607108e-08, 1.63012466e-08,
    1.00374586e-09, 1.3773449e-08, 2.12440399e-09, 1.17957724e-08,
    2.80036705e-09, 1.0218292e-08, 5.08766673e-09, 5.86221471e-09,
    9.00109676e-09, 6.31817709e-09, 1.35843408e-08, 2.62450661e-09,
    1.51153881e-08, 2.71549627e-09, 1.19712844e-08, 3.15501336e-09,
    7.87176901e-09, 5.17497323e-10, 4.97291008e-09, 2.21066568e-11,
    3.22201044e-09, 2.70007766e-11, 2.18626406e-09, 3.9417461e-10,
    1.17969814e-10, 4.96738373e-10, 4.29735525e-10, 6.34547304e-10,
    3.33738637e-09, 8.21894608e-10, 3.09325698e-09, 1.07773934e-09,
    2.86898083e-09, 1.42416523e-09, 2.66388156e-09, 1.87989113e-09,
    2.13449369e-09, 2.44591036e-09, 1.96768002e-09, 3.08325099e-09,
    1.72599912e-09, 3.20426768e-10, 3.57191193e-10, 3.73820752e-10,
    3.48461177e-10, 3.86350063e-10, 1.59787444e-11, 3.53842539e-10,
    1.87573151e-11, 3.09099246e-10, 2.50364902e-11, 2.32111219e-10,
    2.95725493e-11, 1.77955622e-10, 1.91267644e-11, 1.41693393e-10,
    3.65317464e-11, 1.02717036e-10, 3.18371718e-11, 7.66573818e-11,
    4.11819884e-11, 6.39403253e-11, 5.30946988e-11, 2.53770172e-10,
    6.78869946e-11, 2.54272908e-10, 8.55950796e-11, 1.72777881e-09,
    1.05799154e-10, 1.63890179e-09, 1.27423669e-10, 1.55486579e-09,
    1.48519211e-10, 1.23314241e-11, 1.65389508e-10, 1.39805268e-11,
    1.76399256e-10, 9.76389108e-12, 1.7822277e-10, 1.13643244e-11,
    1.70028172e-10, 1.21194036e-11, 1.55345167e-10, 1.48323524e-11,
    1.36803208e-10, 1.82173478e-11, 1.17391041e-10, 2.2346942e-11,
    9.90789603e-11, 2.73290956e-11, 8.28326296e-11, 3.3249653e-11,
    6.89343443e-11, 4.0150213e-11, 5.67599683e-11, 4.80029558e-11,
    4.49212056e-11, 5.66862252e-11, 3.77515103e-11, 6.59582874e-11,
    1.72301839e-10, 7.54288923e-11, 1.69623079e-10, 8.45345183e-11,
    1.67068484e-10, 9.25412594e-11, 8.55540725e-12, 9.86241575e-11,
    8.87187025e-12, 1.02042451e-10, 1.04289372e-11, 1.02362716e-10,
    1.22902391e-11, 9.96141641e-11, 1.44908261e-11, 9.42786405e-11,
    1.70454345e-11, 8.71241274e-11, 1.99830118e-11, 7.89799337e-11,
    2.33219867e-11, 7.05598011e-11, 2.70653951e-11, 6.23797888e-11,
    3.11953657e-11, 5.47563037e-11, 3.56682461e-11, 4.78470943e-11,
    4.04092176e-11, 4.12873347e-11, 4.530646e-11, 3.59406602e-11,
    5.02047154e-11, 2.97038262e-11, 5.55981927e-11, 2.60452666e-11,
    5.9147541e-11, 1.22457752e-10, 5.71683811e-11, 8.84562822e-12,
    6.5198888e-11, 1.01455632e-11, 1.21801258e-11, 1.16275834e-11,
    6.6547122e-11, 1.3293971e-11, 6.52824322e-11, 1.51532675e-11,
    6.23113575e-11, 1.72093208e-11, 5.95805835e-11, 1.94598539e-11,
    5.56597754e-11, 2.18951419e-11, 5.13911518e-11, 2.44965003e-11,
    4.70083625e-11, 2.72349296e-11, 4.26908404e-11, 3.00695094e-11,
    3.85626427e-11, 3.29453062e-11, 3.46999998e-11, 3.57922546e-11,
    3.11422381e-11, 3.85235802e-11, 2.76088215e-11, 4.10377843e-11,
    2.13701348e-11, 4.32232097e-11, 2.09639112e-11, 4.49683311e-11,
    1.8871708e-11, 4.61743491e-11, 1.06042865e-11, 4.6770296e-11,
    1.18495266e-11, 4.67243917e-11, 1.32014503e-11, 4.60501151e-11,
    1.46577212e-11, 4.48035428e-11, 1.62128835e-11, 4.30745647e-11,
    1.78579356e-11]
RT_JAX = {
    "canyon": {"valid_per_depth": [1, 3, 4, 4],
               "gain": 4.9536726720589286e-08},
    "map": {"cells": 40000, "live": 40000, "mean_db": -96.77068328857422,
            "std_db": 11.209969520568848, "max": 7.816385050318786e-07,
            "sample_stride": 97, "sample_corner": [189, 224],
            "sample": RT_JAX_MAP_SAMPLE},
    "city": {"valid_per_depth": [1, 3, 2], "gain": 4.450344093243075e-08},
}
# The card (float32 geometry) against the JAX package and the port on the
# CPU (float64): total gains and the map's largest gain relative, tau
# relative, |a| of the largest |a| (phases are not compared: a float32
# path length of 50 m is off by ~3e-6 m, 2e-4 rad at 3.5 GHz), the map's
# dB statistics absolute, gradients of the largest
RT_GAIN_RTOL = 1e-4
RT_TAU_RTOL = 1e-6
RT_A_RTOL = 1e-4
RT_MAP_DB_ATOL = 0.01
RT_GRAD_RTOL = 1e-3


def rate_band(errors, blocks, n_port):
    """The JAX estimate ``errors / blocks`` +- 5 standard errors of the
    difference between it and an estimate over ``n_port`` trials, at a
    rate at least one trial away from 0 and 1."""
    p = errors / blocks
    q = min(max(p, 1 / blocks), 1 - 1 / blocks)
    half = 5 * (q * (1 - q) * (1 / blocks + 1 / n_port)) ** 0.5
    return max(p - half, 0.0), min(p + half, 1.0)


def bler_band(schedule, ebno_db):
    """The JAX estimate +- 5 standard errors of the difference between
    it and this script's estimate, at a rate at least one block away
    from 0 and 1."""
    if schedule == "generic":
        errors, blocks = GENERIC_JAX[(schedule, ebno_db)]
        n_port = GENERIC["mc_iter"] * GENERIC["batch"]
    elif schedule in RECEIVERS:
        errors, blocks = RECEIVERS_JAX[(schedule, ebno_db)]
        n_port = RECEIVERS[schedule][2] * RECEIVERS[schedule][3]
    elif schedule in FEC_LINKS:
        errors, blocks = FEC_JAX[(schedule, ebno_db)]
        n_port = FEC_LINKS[schedule]["batch"] * FEC_LINKS[schedule]["mc_iter"]
    elif schedule == "pusch":
        errors, blocks = PUSCH_JAX
        n_port = PUSCH["batch"] * PUSCH["mc_iter"]
    elif schedule in MIMO_LINKS:
        errors, blocks = MIMO_JAX[(schedule, ebno_db)]
        cfg = MIMO_LINKS[schedule]
        n_port = cfg["batch"] * MIMO_STREAMS * cfg["mc_iter"]
    else:
        errors, blocks = FLAGSHIP_JAX[(schedule, ebno_db)]
        n_port = FLAGSHIP["mc_iter"] * FLAGSHIP["batch"]
    return rate_band(errors, blocks, n_port)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def reset_launches():
    for kern in KERNELS:
        kern.reset()


def variant_calls(name, lift):
    """(kernel call, plain call) of variant ``name`` on ``lift``; each
    takes (LLRs, iterations)."""
    _, label, kern, _, _ = next(v for v in VARIANTS if v[0] == name)
    knobs = ldpc_tune.KERNEL_VARIANTS[label][1] if label else {}
    if kern is LAYERED_BP_KERNEL:
        return (lambda x, it: layered_bp_cuda(lift, x, it, **knobs),
                lambda x, it: lift.decode_layered(x, it, **knobs))
    return (lambda x, it: lifted_bp_cuda(lift, x, it, **knobs),
            lambda x, it: lift.decode(x, it, **knobs))


def template_label(args):
    """A kernel's template arguments, from its mangled name: K1
    <bf16 rounding, form, cluster layout>, K3 <storage type, blocks: 1,
    or a cluster of up to 4 or 8>."""
    flags = [int(x) for x in re.findall(r"L[bi](\d+)E", args + "E")]
    if len(flags) == 3:
        return (f"{'bf16' if flags[0] else 'f32'},"
                f"{'ratio' if flags[1] else 'log1p'},"
                f"{'cluster' if flags[2] else '1 block'}")
    blocks = flags[-1]
    return (f"{'bf16' if 'bfloat16' in args else 'f32'},"
            + (f"cluster <= {blocks}" if blocks > 1 else "1 block"))


def local_memory_bytes(line):
    """The stack frame and spill bytes of a ptxas report line (0 for a
    line without them)."""
    return sum(int(x) for x in re.findall(
        r"(\d+) bytes (?:stack frame|spill stores|spill loads)", line))


def ptxas_report(kern):
    """One line per compiled kernel variant: its template arguments and
    ptxas's registers, stack, spill and static shared-memory figures (the
    message state is dynamic shared memory, printed with the layouts)."""
    lines, entry = [], None
    for line in kern.build_log.splitlines():
        m = re.search(r"Compiling entry function '.*?_kernelI(.*?)EEv", line)
        if m:
            entry = template_label(m.group(1))
        elif entry and ("registers" in line or "spill" in line
                        or "smem" in line):
            lines.append(f"{kern.name}<{entry}>: {line.split(':', 1)[-1]}"
                         .strip())
    return lines


def lifted_bound(lift, batch, num_iter, per_update):
    """(bound ms, "bytes" or "operations", FP32 issue ms) of one lifted
    BP call (K1, or K3 with its layered updates counted like K1's): the
    LLRs read and the marginals written once at HBM3's 3.35 TB/s, against
    the edge-lane updates this call makes times the FP32 operations of one
    (``per_update``: instructions, operations) at 67 TFLOP/s (an H100 SXM
    at 700 W); and the time its FP32 instructions take to issue."""
    n_bytes = 2 * batch * lift._n_col_blocks * lift._z * 4
    updates = batch * num_iter * len(lift._edges) * lift._z
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = updates * per_update[1] / PEAK_F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            updates * per_update[0] / PEAK_F32_ISSUE_S * 1e3)


def layout_line(lift):
    layout = lift.k1_layout()
    return (f"threads {layout.threads}, cluster {layout.cluster} "
            f"block(s) per codeword, dynamic shared memory "
            f"{layout.smem_bytes} B ({layout.state_floats * 4} B of slots), "
            f"{len(layout.reg_edges)} register edges "
            f"({layout.reg_units_per_thread} units per thread)")


def k3_layout_line(lift, storage_dtype):
    layout = lift.k3_layout(storage_dtype)
    return (f"threads {layout.threads}, cluster {layout.cluster} "
            f"block(s) per codeword of {layout.lanes} lanes each, dynamic "
            f"shared memory {layout.smem_bytes} B")


def launch_line(name, lift, batch):
    """The launch configuration of variant ``name`` on ``lift``."""
    if name.startswith("ldpc_lifted_bp"):
        return (f"K1 launch: {batch} codewords x {layout_line(lift)}; "
                f"{batch * lift.k1_layout().cluster} blocks")
    storage = ldpc_tune.KERNEL_VARIANTS[
        next(v[1] for v in VARIANTS if v[0] == name)][1].get("storage_dtype")
    return (f"K3 launch: {batch} codewords x "
            f"{k3_layout_line(lift, storage)}; "
            f"{batch * lift.k3_layout(storage).cluster} blocks")


def noisy_llrs(enc, batch, ebno_db, gen):
    """Random info bits and the logit-convention BPSK LLRs of their
    codewords at ``ebno_db``."""
    dev = enc.device
    b = torch.randint(0, 2, (batch, enc.k), generator=gen, device=dev,
                      dtype=torch.float32)
    c = enc(b)
    no = float(ebnodb2no(ebno_db, 1, enc.coderate))
    y = (1 - 2 * c) + (no / 2) ** 0.5 * torch.randn(
        c.shape, generator=gen, device=dev)
    return b, -4 * y / no


def assert_identical(got, want, what):
    """Raises unless kernel output ``got`` and plain output ``want`` have
    one shape, are finite and are equal (tolerance 0). Returns
    max |got - want| (0)."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: kernel output {tuple(got.shape)}, "
                             f"plain {tuple(want.shape)}")
    for name, t in (("kernel", got), ("plain", want)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what}: {name} output not finite")
    err = float((got - want).abs().max())
    if err != 0.0:
        raise AssertionError(f"{what}: kernel disagrees with plain: {err}")
    return err


def check_kernel_against_plain(dev, layered):
    """Phases 3 and 4: each variant of a kernel against its plain
    version on the card, for every check-node rule; the marginals must
    be identical (tolerance 0). Both do the same f32 operations in the
    same order and round to bf16 at the same points (nearest even), and
    the kernels' tanhf/log1pf/logf and IEEE division (no fast math) are
    what torch's CUDA tanh/log1p/log/div compute. Returns {variant name:
    max |kernel - plain|} (0)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    kern = LAYERED_BP_KERNEL if layered else LIFTED_BP_KERNEL
    # the min-sum variant is K1 f32 on a min-sum decoder: run under its
    # f32 name, its errors kept under its own
    names = [v[0] for v in VARIANTS if v[2] is kern and v[1]]
    max_err = {v[0]: 0.0 for v in VARIANTS if v[2] is kern}
    iters = (0, 1, 10) if layered else (0, 1, 20)
    # (k, n, nbps, batch, converging / non-converging Eb/N0 in dB); the
    # plain layered decode launches ~50 small ops per base edge and row,
    # so its n=12288 cases run at a reduced batch. The rate-1/2 BG1 code
    # at Z=384 needs the kernels' cluster layouts (K3 f32 also takes one
    # at n=12288); K3 also runs the largest 5G code, rate 1/3 at Z=384,
    # in five blocks (f32) and three (bf16)
    codes = [(100, 200, None, 256, (5.0, 0.0)),
             (LINK["k"], LINK["n"], LINK["nbps"], LINK["batch"], (3.0, 0.0)),
             (6144, 12288, None, 256 if layered else 2048, (2.5, 0.0)),
             (8448, 16896, None, 64, (2.5, 0.0))]
    if layered:
        codes.append((8448, 25344, None, 32, (1.5, 0.0)))
    clusters = set()
    for k, n, nbps, batch, snrs in codes:
        enc = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps, device=dev)
        for cn in ("boxplus", "minsum", "offset-minsum"):
            dec = LDPC5GDecoder(enc, cn_update=cn, engine="lifted",
                                device=dev)
            if cn == "boxplus" and layered:
                for storage in (None, torch.bfloat16):
                    clusters.add(dec.lifted.k3_layout(storage).cluster)
                    print(f"  K3 layout of ({k},{n}), "
                          f"{'bf16' if storage else 'f32'}: "
                          f"{k3_layout_line(dec.lifted, storage)}")
            elif cn == "boxplus":
                clusters.add(dec.lifted.k1_layout().cluster)
                print(f"  K1 layout of ({k},{n}): "
                      f"{layout_line(dec.lifted)}")
            for ebno_db in snrs:
                b, llr = noisy_llrs(enc, batch, ebno_db, gen)
                llr_int = dec.recover_llrs(llr)
                for name in names:
                    kernel, plain = variant_calls(name, dec.lifted)
                    errs = []
                    for it in iters:
                        got = kernel(llr_int, it)
                        errs.append(assert_identical(
                            got, plain(llr_int, it),
                            f"{name} ({k},{n}) {cn} {ebno_db} dB {it} "
                            "iters"))
                    entry = ("ldpc_lifted_bp_minsum"
                             if name == "ldpc_lifted_bp" and cn != "boxplus"
                             else name)
                    max_err[entry] = max(max_err[entry], *errs)
                    # classic convention: a negative marginal decides 1
                    ber = float(((got[:, :k] < 0).float() != b).float()
                                .mean())
                    print(f"  {name:21s} ({k},{n}) {cn:13s} Eb/N0 "
                          f"{ebno_db:4.1f} dB iters {iters}: "
                          f"max|kernel-plain| {max(errs):.3e} (info BER "
                          f"{ber:.2e} after {iters[-1]})")
    if 1 not in clusters or max(clusters) < 2:
        raise AssertionError(f"{kern.name} ran in clusters {clusters}, "
                             "not both layouts (one block and a cluster)")
    return max_err


def make_link(dev, engine="auto"):
    k, n, nbps = LINK["k"], LINK["n"], LINK["nbps"]
    src = BinarySource(device=dev)
    enc = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps, device=dev)
    mapper = Mapper("qam", nbps, device=dev)
    demapper = Demapper("app", "qam", nbps, device=dev)
    dec = LDPC5GDecoder(enc, num_iter=LINK["num_iter"], engine=engine,
                        device=dev)
    awgn = AWGN(device=dev)
    seen = {"calls": 0, "devices": set()}

    def run(batch_size, ebno_db):
        b = src([batch_size, k])
        x = mapper(enc(b))
        no = ebnodb2no(ebno_db, nbps, k / n).to(dev)
        y = awgn(x, no)
        llr = demapper(y, no)
        b_hat = dec(llr)
        seen["calls"] += 1
        for t in (b, x, no, y, llr, b_hat):
            seen["devices"].add(t.device.type)
        return b, b_hat

    return run, dec, seen


def make_generic_link(dev):
    """Phase 10's link: the n=648 802.11n LDPC code (example code 4),
    its generator matrix by pcm2gm, BPSK over AWGN, APP demapping and
    the generic BP decoder (boxplus-phi, segment engine). Returns (run,
    seen); run gives (codeword, estimated codeword)."""
    pcm, k, n, _ = load_parity_check_examples(GENERIC["pcm_id"])
    src = BinarySource(device=dev)
    enc = LinearEncoder(pcm2gm(pcm), device=dev)
    mapper = Mapper("pam", 1, device=dev)
    demapper = Demapper("app", "pam", 1, device=dev)
    awgn = AWGN(device=dev)
    dec = LDPCBPDecoder(pcm, num_iter=GENERIC["num_iter"], device=dev)
    seen = {"calls": 0, "devices": set()}

    def run(batch_size, ebno_db):
        c = enc(src([batch_size, k]))
        no = ebnodb2no(ebno_db, 1, k / n).to(dev)
        llr = demapper(awgn(mapper(c), no), no)
        c_hat = dec(llr)
        seen["calls"] += 1
        for t in (c, no, llr, c_hat):
            seen["devices"].add(t.device.type)
        return c, c_hat

    return run, seen


def weighted_bp_steps(dev, steps, gen):
    """Phase 12: ``steps`` SGD steps on per-edge v2c weights of the
    link's 5G decoder (callbacks take it to the segment engine), BP-10
    soft output, binary cross-entropy against the sent info bits at
    Eb/N0 2 dB. Returns the losses; raises unless every loss and
    gradient is finite and every tensor is on the card."""
    k, n, nbps = LINK["k"], LINK["n"], LINK["nbps"]
    enc = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps, device=dev)
    probe = LDPC5GDecoder(enc, device=dev)
    cb = WeightedBPCallback(probe.num_edges, device=dev)
    dec = LDPC5GDecoder(enc, hard_out=False, num_iter=10,
                        v2c_callbacks=[cb], device=dev)
    if dec.lifted is not None:
        raise AssertionError("weighted BP did not take the segment engine")
    opt = torch.optim.SGD(dec.parameters(), lr=1.0)
    losses, devices = [], set()
    for _ in range(steps):
        b, llr = noisy_llrs(enc, 256, 2.0, gen)
        opt.zero_grad()
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            dec(llr), b)
        loss.backward()
        for t in (b, llr, loss, cb.weights, cb.weights.grad):
            devices.add(t.device.type)
        if not (bool(torch.isfinite(loss))
                and bool(torch.isfinite(cb.weights.grad).all())):
            raise AssertionError(f"weighted BP: loss {float(loss)}, "
                                 "gradient not finite")
        opt.step()
        losses.append(loss.item())
    if devices != {"cuda"}:
        raise AssertionError(f"weighted BP tensors on {devices}")
    return losses


class Flagship:
    """bench.py's flagship link (bench.py:110-131) on the port's public
    blocks: TDL-A (100 ns, 3.5 GHz, 3 km/h) SISO OFDM, 14 symbols of a
    256-FFT grid at 30 kHz with CP 16 and Kronecker pilots on symbols
    [2, 11], 16-QAM, rate-1/2 5G LDPC (n=12288) with a row-column
    interleaver, LS estimation with nearest-neighbour interpolation,
    LMMSE equalization, APP demapping and a boxplus decoder.
    ``receiver`` = (interpolation, equalizer) swaps the receiver:
    interpolation "nn", "lin", "lin_time_avg" or "lmmse"
    (LMMSEInterpolator("t-f") from the TDL-A covariances), equalizer
    "lmmse", "zf" or "mf"."""

    def __init__(self, dev, receiver=("nn", "lmmse"), **decoder_kw):
        nbps = FLAGSHIP["nbps"]
        self.dev = dev
        self.rg = rg = ResourceGrid(
            num_ofdm_symbols=14, fft_size=256, subcarrier_spacing=30e3,
            num_tx=1, num_streams_per_tx=1, cyclic_prefix_length=16,
            pilot_pattern="kronecker", pilot_ofdm_symbol_indices=[2, 11])
        n = int(rg.num_data_symbols) * nbps
        self.k = k = int(n * FLAGSHIP["rate"])
        self.src = BinarySource(device=dev)
        self.enc = LDPC5GEncoder(k, n, device=dev)
        self.il = RowColumnInterleaver(row_depth=nbps, device=dev)
        self.dil = Deinterleaver(self.il, device=dev)
        self.mapper = Mapper("qam", nbps, device=dev)
        self.rg_mapper = ResourceGridMapper(rg, device=dev)
        self.channel = OFDMChannel(
            TDL("A", 100e-9, 3.5e9, min_speed=3, max_speed=3), rg,
            normalize_channel=True, device=dev)
        interp, eq = self.receiver = receiver
        self.interpolator = None
        if interp == "lmmse":
            self.interpolator = LMMSEInterpolator(
                rg.pilot_pattern,
                tdl_time_cov_mat("A", 3 / 3.6, 3.5e9,
                                 rg.ofdm_symbol_duration, 14),
                tdl_freq_cov_mat("A", 30e3, 256, 100e-9), order="t-f")
        self.est = self.estimator(dev)
        self.equ = {"lmmse": LMMSEEqualizer, "zf": ZFEqualizer,
                    "mf": MFEqualizer}[eq](
                        rg, StreamManagement(np.array([[1]]), 1), device=dev)
        self.demapper = Demapper("app", "qam", nbps, device=dev)
        self.dec = LDPC5GDecoder(self.enc, hard_out=True,
                                 cn_update="boxplus", device=dev,
                                 **decoder_kw)
        self.calls = 0
        self.devices = set()

    def estimator(self, dev):
        """The link's channel estimator, built on ``dev``."""
        if self.interpolator is not None:
            return LSChannelEstimator(self.rg, interpolator=self.interpolator,
                                      device=dev)
        return LSChannelEstimator(self.rg,
                                  interpolation_type=self.receiver[0],
                                  device=dev)

    def no(self, ebno_db):
        return ebnodb2no(ebno_db, FLAGSHIP["nbps"], FLAGSHIP["rate"],
                         self.rg).to(self.dev)

    def __call__(self, batch_size, ebno_db):
        """One MC iteration (the sim_ber model): returns (b, b_hat)."""
        no = self.no(ebno_db)
        b = self.src([batch_size, 1, 1, self.k])
        x_rg = self.rg_mapper(self.mapper(self.il(self.enc(b))))
        y = self.channel(x_rg, no)
        h_hat, err_var = self.est(y, no)
        x_hat, no_eff = self.equ(y, h_hat, err_var, no)
        llr = self.dil(self.demapper(x_hat, no_eff))
        b_hat = self.dec(llr)
        self.calls += 1
        for t in (no, b, x_rg, y, h_hat, err_var, x_hat, no_eff, llr,
                  b_hat):
            self.devices.add(t.device.type)
        return b, b_hat

    def stage_ms(self, batch_size, ebno_db, reps):
        """Mean milliseconds of each stage of one MC iteration, by CUDA
        events around the stages, over ``reps`` iterations after one
        warm-up."""
        names = ["source+encode+map+RG map", "channel generation",
                 "channel application and noise",
                 f"estimation ({self.receiver[0]})",
                 f"equalization ({self.receiver[1]})", "demap", "decode"]
        total = np.zeros(len(names))
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(names) + 1)]
            no = self.no(ebno_db)
            ev[0].record()
            b = self.src([batch_size, 1, 1, self.k])
            x_rg = self.rg_mapper(self.mapper(self.il(self.enc(b))))
            ev[1].record()
            h = self.channel.gen(batch_size)
            ev[2].record()
            y = self.channel.app(x_rg, h, no)
            ev[3].record()
            h_hat, err_var = self.est(y, no)
            ev[4].record()
            x_hat, no_eff = self.equ(y, h_hat, err_var, no)
            ev[5].record()
            llr = self.dil(self.demapper(x_hat, no_eff))
            ev[6].record()
            self.dec(llr)
            ev[7].record()
            torch.cuda.synchronize()
            if rep:
                total += [ev[i].elapsed_time(ev[i + 1])
                          for i in range(len(names))]
        return dict(zip(names, total / reps))


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_busy(link, batch, iters):
    """(CUDA time, wall time) in ms of ``iters`` MC iterations of
    ``link`` under ``torch.profiler``, after 3 warm-up iterations; the
    CUDA time is the sum of the device-side events' self times (the
    kernels and copies, each counted once)."""
    for _ in range(3):
        link(batch, 5.0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            link(batch, 5.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3, wall * 1e3


def in_turns(ker, plain, ker_reps, plain_reps):
    """kernel, plain, plain, kernel: ((k1, k2), (p1, p2)) ms per call."""
    k1 = cuda_ms(ker, ker_reps)
    p1 = cuda_ms(plain, plain_reps)
    p2 = cuda_ms(plain, plain_reps)
    k2 = cuda_ms(ker, ker_reps)
    return (k1, k2), (p1, p2)


def check_link_bands(bler, what):
    """The coded-AWGN link's BLER bands: [0.4, 0.8] at 3 dB, <= 0.02 at
    4 dB."""
    if not 0.4 <= bler[0] <= 0.8:
        raise AssertionError(f"{what}: BLER at 3 dB {bler[0]} outside "
                             "[0.4, 0.8]")
    if not bler[1] <= 0.02:
        raise AssertionError(f"{what}: BLER at 4 dB {bler[1]} above 0.02")


def check_no_kernel(phase, devices):
    """A segment-engine phase: every tensor on the card, and no lifted
    kernel launched since the counts were set to 0."""
    if devices != {"cuda"}:
        raise AssertionError(f"{phase} tensors on {devices}")
    if any(kern.launches for kern in KERNELS):
        raise AssertionError(f"{phase} launched a lifted kernel: "
                             f"{[k.variant_launches for k in KERNELS]}")


def run_flagship(link, schedule, snrs):
    """Phases 6 and 7: the flagship through sim_ber with every launch
    count at 0 just before and read just after. Returns the launches."""
    reset_launches()
    t0 = time.perf_counter()
    _, bler = sim_ber(link, snrs, batch_size=FLAGSHIP["batch"],
                      max_mc_iter=FLAGSHIP["mc_iter"], early_stop=False,
                      verbose=True)
    torch.cuda.synchronize()
    launches = {kern.name: dict(kern.variant_launches) for kern in KERNELS}
    bler = bler.tolist()
    print(f"    {schedule}: BLER {bler}, {link.calls} decoder calls, "
          f"launches {launches}, devices {sorted(link.devices)}, "
          f"{time.perf_counter() - t0:.2f} s")
    for snr, p in zip(snrs, bler):
        lo, hi = bler_band(schedule, snr)
        if not lo <= p <= hi:
            raise AssertionError(f"flagship {schedule} BLER at {snr} dB "
                                 f"{p} outside [{lo}, {hi}]")
    if link.devices != {"cuda"}:
        raise AssertionError(f"flagship tensors on {link.devices}")
    return launches


def demap_paths(dev, gen):
    """Phase 13: the Demapper's separable path (its default for Gray
    QAM) against its table path (a ``points`` override) on the same
    inputs at the flagship's shape: 2048 x 3072 noisy 16-QAM symbols,
    one noise variance per symbol (as the equalizer gives them). Raises
    unless the LLRs are finite and within SEP_TABLE_ULPS of the largest
    exponent of each symbol. Returns {method: (separable ms, table ms)}
    per call, in turns."""
    batch, n_sym = FLAGSHIP["batch"], 3072
    mapper = Mapper("qam", 4, device=dev)
    bits = torch.randint(0, 2, (batch, 1, 1, n_sym * 4), generator=gen,
                         device=dev, dtype=torch.float32)
    x = mapper(bits)
    no = 0.05 * (0.5 + torch.rand(x.shape, generator=gen, device=dev))
    y = x + torch.sqrt(no / 2) * torch.complex(
        torch.randn(x.shape, generator=gen, device=dev),
        torch.randn(x.shape, generator=gen, device=dev))
    pts = mapper.constellation.points
    largest = torch.amax(torch.abs(y[..., None] - pts) ** 2 / no[..., None],
                         dim=-1).repeat_interleave(4, dim=-1)
    ulp = largest * np.finfo(np.float32).eps
    times = {}
    for method in ("app", "maxlog"):
        dem = Demapper(method, "qam", 4, device=dev)
        raw = dem.constellation.raw_points
        sep, table = dem(y, no), dem(y, no, points=raw)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(sep).all())
                and bool(torch.isfinite(table).all())):
            raise AssertionError(f"[13] {method}: LLRs not finite")
        err = torch.abs(sep - table)
        worst = float(torch.amax(err / ulp))
        print(f"    {method}: max |separable - table| {float(err.max()):.3e}, "
              f"{worst:.2f} ULP of the largest exponent (bound "
              f"{SEP_TABLE_ULPS})")
        if worst > SEP_TABLE_ULPS:
            raise AssertionError(f"[13] {method}: separable and table LLRs "
                                 f"differ by {worst} ULP")
        (s1, s2), (t1, t2) = in_turns(lambda: dem(y, no),
                                      lambda: dem(y, no, points=raw), 10, 10)
        print(f"    {method}: separable {s1:.3f} / {s2:.3f} ms, table "
              f"{t1:.3f} / {t2:.3f} ms per call (2048 x 3072 symbols)")
        times[method] = ((s1 + s2) / 2, (t1 + t2) / 2)
    return times


def estimation_against_cpu(link, batch=8):
    """Phase 14: the link's estimator on the card against the same
    estimator on the CPU, on one received grid at 8 dB. Returns max
    |h_hat card - h_hat CPU| and max |err_var card - err_var CPU|, each
    over the largest magnitude; raises above 1e-5 (the LS division and
    the linear interpolator's product run in f32 on both, a few ULP
    apart; the LMMSE passes are f64)."""
    no = link.no(8.0)
    b = link.src([batch, 1, 1, link.k])
    y = link.channel(link.rg_mapper(link.mapper(link.il(link.enc(b)))), no)
    h_card, e_card = link.est(y, no)
    h_cpu, e_cpu = link.estimator("cpu")(y.cpu(), no.cpu())
    torch.cuda.synchronize()
    errs = []
    for card, cpu in ((h_card, h_cpu), (e_card, e_cpu)):
        card = card.cpu().expand(cpu.shape)
        errs.append(float((card - cpu).abs().max() / cpu.abs().max()))
    if not max(errs) <= 1e-5:
        raise AssertionError(f"[14] {link.receiver[0]} estimation on the "
                             f"card against the CPU: {errs}")
    return errs


def run_receivers(dev):
    """Phase 14: the flagship's receiver variants through sim_ber at 8
    dB, flooding BP-20 (K1), each with the launch counts at 0 just
    before and read just after; the first again from its checkpoint, the
    last with a Profiler. Returns {variant: (BLER, stage ms)}."""
    out = {}
    for name, (interp, eq, batch, mc_iter) in RECEIVERS.items():
        link = Flagship(dev, receiver=(interp, eq), num_iter=20)
        ckpt = prof = None
        if name == "lin_lmmse":
            os.makedirs("build", exist_ok=True)
            ckpt = os.path.join("build", "chip_smoke_lin_lmmse.npz")
            if os.path.exists(ckpt):
                os.remove(ckpt)
        if name == "nn_mf":
            prof = Profiler()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        _, bler = sim_ber(link, [8.0], batch_size=batch,
                          max_mc_iter=mc_iter, early_stop=False,
                          verbose=True, checkpoint_path=ckpt,
                          profiler=prof)
        torch.cuda.synchronize()
        launches = {kern.name: dict(kern.variant_launches)
                    for kern in KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        bler = float(bler[0])
        lo, hi = bler_band(name, 8.0)
        print(f"    {name} (LS {interp}, {eq.upper()}), batch {batch}: BLER "
              f"{bler} (band [{lo:.4f}, {hi:.4f}]), {link.calls} decoder "
              f"calls, launches {launches}, devices {sorted(link.devices)}, "
              f"peak memory {peak:.2f} GiB, "
              f"{time.perf_counter() - t0:.2f} s")
        if not lo <= bler <= hi:
            raise AssertionError(f"[14] {name} BLER {bler} outside "
                                 f"[{lo}, {hi}]")
        if launches != {LIFTED_BP_KERNEL.name: {"f32": link.calls},
                        LAYERED_BP_KERNEL.name: {}}:
            raise AssertionError(f"[14] {name}: {launches} for {link.calls} "
                                 "decoder calls")
        if link.devices != {"cuda"}:
            raise AssertionError(f"[14] {name} tensors on {link.devices}")
        dh, de = estimation_against_cpu(link)
        print(f"    {name}: estimation on the card against the CPU, batch "
              f"8: max |h_hat diff| {dh:.3e}, max |err_var diff| {de:.3e} of "
              f"the largest (bound 1e-5)")
        if ckpt is not None:
            calls = link.calls
            reset_launches()
            _, bler2 = sim_ber(link, [8.0], batch_size=batch,
                               max_mc_iter=mc_iter, early_stop=False,
                               verbose=True, checkpoint_path=ckpt)
            print(f"    {name} resumed from {ckpt}: BLER {float(bler2[0])}, "
                  f"{link.calls - calls} new decoder calls, "
                  f"{LIFTED_BP_KERNEL.launches} launches")
            if (link.calls != calls or LIFTED_BP_KERNEL.launches
                    or float(bler2[0]) != bler):
                raise AssertionError(f"[14] {name}: the resumed sweep ran "
                                     "again or changed its BLER")
        if prof is not None:
            print("    " + prof.summary().replace("\n", "\n    "))
        stages = link.stage_ms(batch, 8.0, 3)
        for stage in stages:
            if stage.startswith(("estimation", "equalization", "demap",
                                 "decode")):
                print(f"      {stage:30s} {stages[stage]:9.3f} ms")
        out[name] = (bler, stages)
    return out


def fec_codec(name, dev):
    """(encoder, decoder, k, coderate) of FEC link ``name`` on ``dev``:
    tools/fec_links_bler.py's codecs."""
    if name.startswith("polar"):
        enc = Polar5GEncoder(512, 1024, device=dev)
        dec = Polar5GDecoder(enc, dec_type="SC", device=dev) \
            if name == "polar_sc" else \
            Polar5GDecoder(enc, dec_type="SCL", list_size=8, device=dev)
        return enc, dec, 512, 512 / 1024
    if name.startswith("conv"):
        enc = ConvEncoder(rate=1 / 2, constraint_length=7, terminate=True,
                          device=dev)
        dec = ViterbiDecoder(encoder=enc, device=dev) \
            if name == "conv_viterbi" else BCJRDecoder(encoder=enc, device=dev)
        return enc, dec, 1024, 1 / 2
    enc = TurboEncoder(rate=1 / 3, constraint_length=4, terminate=True,
                       device=dev)
    return enc, TurboDecoder(enc, num_iter=6, device=dev), 1024, 1 / 3


def marked_stage_ms(run, reps):
    """Median ms of each stage of ``run(mark)``, one MC iteration that
    calls ``mark(name)`` at the end of each stage, over ``reps``
    iterations after one warm-up (CUDA events)."""
    times, names = [], []
    for rep in range(reps + 1):
        names.clear()
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            names.append(name)

        run(mark)
        torch.cuda.synchronize()
        if rep:
            times.append([events[i].elapsed_time(events[i + 1])
                          for i in range(len(names))])
    return dict(zip(names, np.median(times, axis=0)))


class FecLink:
    """Phases 15-16: QPSK over AWGN with the APP demapper around the
    codec of FEC link ``name``; a call is one MC iteration (the sim_ber
    model)."""

    def __init__(self, dev, name):
        self.dev, self.name = dev, name
        self.enc, self.dec, self.k, self.rate = fec_codec(name, dev)
        self.src = BinarySource(device=dev)
        self.mapper = Mapper("qam", 2, device=dev)
        self.demapper = Demapper("app", "qam", 2, device=dev)
        self.awgn = AWGN(device=dev)
        self.calls = 0
        self.devices = set()

    def no(self, ebno_db):
        return ebnodb2no(ebno_db, 2, self.rate).to(self.dev)

    def llrs(self, batch_size, ebno_db):
        """Info bits and their channel LLRs."""
        no = self.no(ebno_db)
        b = self.src([batch_size, self.k])
        return b, self.demapper(self.awgn(self.mapper(self.enc(b)), no), no)

    def __call__(self, batch_size, ebno_db):
        no = self.no(ebno_db)
        b = self.src([batch_size, self.k])
        x = self.mapper(self.enc(b))
        y = self.awgn(x, no)
        llr = self.demapper(y, no)
        b_hat = self.dec(llr)
        self.calls += 1
        for t in (no, b, x, y, llr, b_hat):
            self.devices.add(t.device.type)
        return b, b_hat

    def stage_ms(self, batch_size, ebno_db, reps):
        """Median milliseconds of each stage of one MC iteration over
        ``reps`` iterations after one warm-up (CUDA events)."""
        no = self.no(ebno_db)

        def run(mark):
            x = self.mapper(self.enc(self.src([batch_size, self.k])))
            mark("source+encode+map")
            y = self.awgn(x, no)
            mark("channel (AWGN)")
            llr = self.demapper(y, no)
            mark("demap")
            self.dec(llr)
            mark("decode")

        return marked_stage_ms(run, reps)


def median_ms(fn, reps):
    """Median milliseconds of ``reps`` calls of ``fn`` after one warm-up
    call, each timed by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def launches_per_call(fn):
    """(CUDA kernels and copies on the device, cudaLaunchKernel calls on
    the host, ms of device time) of one call of ``fn``, by
    ``torch.profiler``; the device time sums the device-side events' self
    times (each kernel and copy once)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    host = sum(e.count for e in prof.key_averages()
               if e.key == "cudaLaunchKernel")
    return (sum(e.count for e in events), host,
            sum(e.self_device_time_total for e in events) / 1e3)


FEC_METRICS = {"polar_sc": "polar5g_sc_coded_info_bit_throughput",
               "polar_scl8": "polar5g_scl8_coded_info_bit_throughput"}


def run_fec_link(dev, name, reps):
    """Phases 15-16: FEC link ``name`` through sim_ber at its Eb/N0 with
    every lifted-kernel count at 0 just before; its band, every tensor on
    the card, no lifted kernel; its decoder on one batch on the card
    against the same decoder on the CPU; ms per decoder call (median of
    ``reps``), launches per call, the stages of one MC iteration and the
    info-bit Mbit/s (bench.py's names for the polar links). Returns
    the decoder call (on a batch of LLRs) whose launches ``fec_phases``
    counts once every link is timed."""
    cfg = FEC_LINKS[name]
    ebno_db, batch = cfg["ebno_db"], cfg["batch"]
    link = FecLink(dev, name)
    reset_launches()
    t0 = time.perf_counter()
    _, bler = sim_ber(link, [ebno_db], batch_size=batch,
                      max_mc_iter=cfg["mc_iter"], early_stop=False,
                      verbose=True)
    torch.cuda.synchronize()
    bler = float(bler[0])
    lo, hi = bler_band(name, ebno_db)
    print(f"    {name} at {ebno_db} dB, batch {batch} x {cfg['mc_iter']}: "
          f"BLER {bler} (band [{lo:.4f}, {hi:.4f}]), {link.calls} decoder "
          f"calls, devices {sorted(link.devices)}, "
          f"{time.perf_counter() - t0:.2f} s")
    if not lo <= bler <= hi:
        raise AssertionError(f"{name} BLER {bler} outside [{lo}, {hi}]")
    check_no_kernel(name, link.devices)
    # the decoder on the card against the same decoder on the CPU
    n_cpu = 1024 if name in ("polar_sc", "conv_viterbi") else 256
    _, llr = link.llrs(n_cpu, ebno_db)
    cpu_dec = fec_codec(name, "cpu")[1]
    diff = int((link.dec(llr).cpu() != cpu_dec(llr.cpu())).any(-1).sum())
    print(f"    {name}: {diff} of {n_cpu} blocks decode differently on the "
          f"card and on the CPU (bound {FEC_CPU_DIFF_PER_MILLE} per 1000)")
    if diff * 1000 > FEC_CPU_DIFF_PER_MILLE * n_cpu:
        raise AssertionError(f"{name}: {diff} of {n_cpu} blocks differ "
                             "between the card and the CPU")
    _, llr = link.llrs(batch, ebno_db)
    with torch.no_grad():
        dec_ms = median_ms(lambda: link.dec(llr), reps)
        stages = link.stage_ms(batch, ebno_db, reps)
        it_ms = median_ms(lambda: link(batch, ebno_db), reps)
    print(f"    {name}: decoder {dec_ms:.3f} ms per call (batch {batch}, "
          f"median of {reps})")
    total = sum(stages.values())
    for stage, t in stages.items():
        print(f"      {stage:20s} {t:9.3f} ms  {100 * t / total:5.1f} %")
    print(f"      {'sum of stages':20s} {total:9.3f} ms")
    print(f"    {FEC_METRICS.get(name, name + ' info-bit throughput')}: "
          f"{batch * link.k / it_ms / 1e3:.3f} Mbit/s ({it_ms:.3f} ms per MC "
          f"iteration, median of {reps})")
    return lambda: link.dec(llr)


def fec_phases(card, results):
    """Phases 15 and 16, run in a fresh process by ``main``; puts an
    empty dict on ``results`` when they pass."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[15] polar link (5G k=512 n=1024, QPSK, AWGN, APP demapper; SC "
          f"at batch 8192, SCL-8 at 4096) through sim_ber on {card}")
    calls = {name: run_fec_link(dev, name, reps=5)
             for name in ("polar_sc", "polar_scl8")}
    print(f"[16] convolutional (rate 1/2, K=7) and turbo (rate 1/3, K=4, 6 "
          f"iterations) codes, k=1024, through sim_ber on {card}; cut to "
          + ", ".join(f"{n} {FEC_LINKS[n]['mc_iter']} x "
                      f"{FEC_LINKS[n]['batch']}" for n in
                      ("conv_viterbi", "conv_bcjr", "turbo"))
          + " blocks (their decoders loop over time eagerly)")
    for name in ("conv_viterbi", "conv_bcjr", "turbo"):
        calls[name] = run_fec_link(dev, name, reps=3)
    # the profiler last: every launch after its window costs more
    print("[15-16] launches per decoder call (torch.profiler, one call at "
          "the timed batch)")
    for name, call in calls.items():
        with torch.no_grad():
            device, host, busy = launches_per_call(call)
        print(f"    {name}: {device} kernels and copies on the device, "
              f"{host} cudaLaunchKernel, {busy:.3f} ms of device time")
    sys.stdout.flush()
    results.put({})


def cross_array(num_cols, fc):
    """One row of ``num_cols`` cross-polarized 38.901 elements."""
    return AntennaArray(num_rows=1, num_cols=num_cols, polarization="dual",
                        polarization_type="cross", antenna_pattern="38.901",
                        carrier_frequency=fc)


class MimoLink:
    """Phases 17-19: one of ``tools/mimo_ofdm_cdl_bler.py``'s links on
    the port's public blocks; a call is one MC iteration (the sim_ber
    model) through ``stages(batch, ebno_db, mark)``, which ``mark``s the
    end of each stage for the stage table: one pipeline for both."""

    def __init__(self, dev, name):
        self.dev, self.name = dev, name
        self.calls, self.devices = 0, set()
        self.src = BinarySource(device=dev)
        sm = StreamManagement(np.array([[1]]), MIMO_STREAMS)
        if name.startswith("det_"):
            self.nbps, fc, scs, model, ut, bs = 2, 2.6e9, 15e3, "A", 2, 4
            grid = {}
        else:
            self.nbps, fc, scs, model, ut, bs = 4, 3.5e9, 30e3, "B", 2, 2
            grid = dict(pilot_pattern="kronecker",
                        pilot_ofdm_symbol_indices=[2, 11])
            if name == "dl_time":
                grid.update(cyclic_prefix_length=6,
                            num_guard_carriers=[2, 1], dc_null=True)
        self.rg = rg = ResourceGrid(num_ofdm_symbols=14, fft_size=128,
                                    subcarrier_spacing=scs, num_tx=1,
                                    num_streams_per_tx=MIMO_STREAMS, **grid)
        n = int(rg.num_data_symbols) * self.nbps
        self.k = n // 2
        self.enc = LDPC5GEncoder(self.k, n, device=dev)
        self.mapper = Mapper("qam", self.nbps, device=dev)
        self.rg_mapper = ResourceGridMapper(rg, device=dev)
        direction = "downlink" if name == "dl_time" else "uplink"
        self.cdl = CDL(model, 100e-9, fc, cross_array(ut, fc),
                       cross_array(bs, fc), direction, min_speed=3.,
                       device=dev)
        self.freqs = subcarrier_frequencies(128, scs, device=dev)
        if name == "ul_freq":
            self.channel = OFDMChannel(self.cdl, rg, normalize_channel=True,
                                       device=dev)
            self.est = LSChannelEstimator(rg, interpolation_type="lin",
                                          device=dev)
            self.det = LinearDetector("lmmse", "bit", "app", rg, sm, "qam",
                                      self.nbps, device=dev)
            self.dec = LDPC5GDecoder(self.enc, num_iter=12,
                                     cn_update="minsum", device=dev)
        elif name == "dl_time":
            self.l_min, self.l_max = time_lag_discrete_time_channel(
                rg.bandwidth)
            self.l_tot = self.l_max - self.l_min + 1
            self.precoder = RZFPrecoder(rg, sm, return_effective_channel=True,
                                        device=dev)
            self.mod = OFDMModulator(6, device=dev)
            self.demod = OFDMDemodulator(128, self.l_min, 6, device=dev)
            self.channel = ApplyTimeChannel(rg.num_time_samples, self.l_tot,
                                            device=dev)
            self.est = LSChannelEstimator(rg, interpolation_type="nn",
                                          device=dev)
            self.equ = LMMSEEqualizer(rg, sm, device=dev)
            self.demapper = Demapper("app", "qam", self.nbps, device=dev)
            self.dec = LDPC5GDecoder(self.enc, hard_out=True, device=dev)
        else:
            self.channel = OFDMChannel(self.cdl, rg, normalize_channel=True,
                                       return_channel=True, device=dev)
            self.det = self.detector(dev)
            self.dec = LDPC5GDecoder(self.enc, hard_out=True, device=dev)

    def detector(self, dev):
        """Phase 19's detector of this link, built on ``dev``."""
        rg, nbps = self.rg, self.nbps
        sm = StreamManagement(np.array([[1]]), MIMO_STREAMS)
        kind = self.name[4:]
        if kind == "lmmse":
            return LinearDetector("lmmse", "bit", "maxlog", rg, sm, "qam",
                                  nbps, device=dev)
        if kind == "kbest":
            return KBestDetector("bit", MIMO_STREAMS, 16, rg, sm, "qam",
                                 nbps, device=dev)
        if kind == "ep":
            return EPDetector("bit", rg, sm, nbps, device=dev)
        if kind == "mmsepic":
            return MMSEPICDetector("bit", rg, sm, num_iter=3,
                                   constellation_type="qam",
                                   num_bits_per_symbol=nbps, device=dev)
        return MaximumLikelihoodDetector("bit", "maxlog", rg, sm, "qam",
                                         nbps, device=dev)

    def detect(self, det, y, h, no):
        """Phase 19: the detector's LLRs with perfect CSI."""
        err_var = torch.zeros((), device=y.device)
        if self.name == "det_mmsepic":
            return det(y, h, None, err_var, no)
        return det(y, h, err_var, no)

    def no(self, ebno_db):
        return ebnodb2no(ebno_db, self.nbps, 0.5, self.rg).to(self.dev)

    def received(self, batch_size, ebno_db):
        """Phase 19: (info bits, y, h, no) of one batch."""
        no = self.no(ebno_db)
        b = self.src([batch_size, 1, MIMO_STREAMS, self.k])
        y, h = self.channel(self.rg_mapper(self.mapper(self.enc(b))), no)
        return b, y, h, no

    def stages(self, batch_size, ebno_db, mark):
        """One MC iteration, ``mark``ing the end of each stage; returns
        (b, b_hat) and the tensors it made."""
        rg, no = self.rg, self.no(ebno_db)
        b = self.src([batch_size, 1, MIMO_STREAMS, self.k])
        x_rg = self.rg_mapper(self.mapper(self.enc(b)))
        mark("source+encode+map+RG map")
        made = [no, b, x_rg]
        if self.name == "dl_time":
            cp = 6
            a, tau = self.cdl(batch_size, rg.num_time_samples + self.l_tot - 1,
                              rg.bandwidth)
            mark(f"CDL generation ({a.shape[-1]} steps)")
            h_time = cir_to_time_channel(rg.bandwidth, a, tau, self.l_min,
                                         self.l_max, normalize=True)
            a_freq = a[..., cp:-1:128 + cp][..., :rg.num_ofdm_symbols]
            h_freq = cir_to_ofdm_channel(self.freqs, a_freq, tau,
                                         normalize=True)
            mark("CIR -> time and OFDM channels")
            x_pre, _ = self.precoder(x_rg, h_freq)
            mark("RZF precoding")
            x_time = self.mod(x_pre)
            mark("OFDM modulator")
            y_time = self.channel(x_time, h_time, no)
            mark("time channel and noise")
            y = self.demod(y_time)
            mark("OFDM demodulator")
            h_hat, err_var = self.est(y, no)
            mark("LS estimation (nn)")
            x_hat, no_eff = self.equ(y, h_hat, err_var, no)
            llr = self.demapper(x_hat, no_eff)
            mark("LMMSE equalizer + demap")
            made += [a, tau, h_time, h_freq, x_pre, x_time, y_time, y, h_hat,
                     err_var, x_hat, no_eff, llr]
        else:
            # OFDMChannel's two halves, its CIR sampler split off
            a, tau = self.cdl(batch_size, rg.num_ofdm_symbols,
                              1 / rg.ofdm_symbol_duration)
            mark("CDL generation (14 steps)")
            h = cir_to_ofdm_channel(self.freqs, a, tau, normalize=True)
            mark("CIR -> OFDM channel")
            y = self.channel.app(x_rg, h, no)
            mark("channel application and noise")
            made += [a, tau, h, y]
            if self.name == "ul_freq":
                h_hat, err_var = self.est(y, no)
                mark("LS estimation (lin)")
                llr = self.det(y, h_hat, err_var, no)
                mark("LMMSE detection (app)")
                made += [h_hat, err_var]
            else:
                llr = self.detect(self.det, y, h, no)
                mark(f"{self.name[4:]} detection (perfect CSI)")
            made.append(llr)
        b_hat = self.dec(llr)
        mark("decode")
        return b, b_hat, made + [b_hat]

    def __call__(self, batch_size, ebno_db):
        b, b_hat, made = self.stages(batch_size, ebno_db, lambda name: None)
        self.calls += 1
        self.devices.update(str(t.device) for t in made)
        return b, b_hat


def run_mimo_link(dev, name, decoder_variant):
    """Phases 17-19: link ``name`` through sim_ber at its Eb/N0 with every
    count at 0 just before and read just after: its band, every tensor on
    cuda:0, one K1 launch of ``decoder_variant`` per decoder call, the
    stages of one MC iteration, ms per iteration, Mbit/s and the peak
    memory. Returns (link, launches of the variant)."""
    cfg = MIMO_LINKS[name]
    ebno_db, batch = cfg["ebno_db"], cfg["batch"]
    link = MimoLink(dev, name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    _, bler = sim_ber(link, [ebno_db], batch_size=batch,
                      max_mc_iter=cfg["mc_iter"], early_stop=False,
                      verbose=False)
    torch.cuda.synchronize()
    launches = {kern.name: dict(kern.variant_launches) for kern in KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    bler = float(bler[0])
    lo, hi = bler_band(name, ebno_db)
    print(f"    {name} at {ebno_db} dB, batch {batch} x {cfg['mc_iter']} "
          f"({batch * MIMO_STREAMS * cfg['mc_iter']} blocks): BLER {bler} "
          f"(band [{lo:.4f}, {hi:.4f}]), {link.calls} decoder calls, "
          f"launches {launches}, devices {sorted(link.devices)}, peak "
          f"memory {peak:.2f} GiB, {time.perf_counter() - t0:.2f} s")
    if not lo <= bler <= hi:
        raise AssertionError(f"{name} BLER {bler} outside [{lo}, {hi}]")
    if link.devices != {"cuda:0"}:
        raise AssertionError(f"{name} tensors on {link.devices}")
    if launches != {LIFTED_BP_KERNEL.name: {decoder_variant: link.calls},
                    LAYERED_BP_KERNEL.name: {}}:
        raise AssertionError(f"{name}: {launches} for {link.calls} decoder "
                             "calls")
    with torch.no_grad():
        stages = marked_stage_ms(
            lambda mark: link.stages(batch, ebno_db, mark), 5)
        it_ms = median_ms(lambda: link(batch, ebno_db), 5)
    total = sum(stages.values())
    for stage, t in stages.items():
        print(f"      {stage:32s} {t:9.3f} ms  {100 * t / total:5.1f} %")
    print(f"      {'sum of stages':32s} {total:9.3f} ms")
    bits = batch * MIMO_STREAMS * link.k
    print(f"    {name}: {it_ms:.3f} ms per MC iteration (median of 5), "
          f"{bits / it_ms / 1e3:.3f} Mbit/s of info bits")
    return link, launches[LIFTED_BP_KERNEL.name][decoder_variant]


def against_cpu(card, cpu, what, bound=1e-5):
    """max |card - CPU| over the largest |CPU| value; raises above
    ``bound`` (cuFFT and pocketfft round f32 differently)."""
    torch.cuda.synchronize()
    err = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
    print(f"    {what} on the card against the CPU, batch 8: max |diff| "
          f"{err:.3e} of the largest (bound {bound:g})")
    if not err <= bound:
        raise AssertionError(f"{what}: card and CPU differ by {err}")


def mimo_phases(card, results):
    """Phases 17-19, run in a fresh process by ``main``; puts phase 17's
    min-sum launches on ``results``."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[17] BASELINE config 3 (examples/03_mimo_ofdm_cdl.py: CDL-B "
          f"uplink, 4 x 4, 4 streams, 128-FFT, 16-QAM, LS lin, LMMSE, "
          f"min-sum BP-12) through sim_ber on {card}")
    _, minsum = run_mimo_link(dev, "ul_freq", "f32+minsum")

    print(f"[18] the same widths downlink in the time domain (RZF, OFDM "
          f"modulator, CDL taps over the CP-6 grid, demodulator; LS nn, "
          f"LMMSE, boxplus-phi BP-20) through sim_ber on {card}")
    link, _ = run_mimo_link(dev, "dl_time", "f32")
    # its modulator and demodulator on one batch against the CPU
    rg = link.rg
    x_rg = link.rg_mapper(link.mapper(link.enc(
        link.src([8, 1, MIMO_STREAMS, link.k]))))
    x_time = link.mod(x_rg)
    against_cpu(x_time, OFDMModulator(6, device="cpu")(x_rg.cpu()),
                "OFDMModulator")
    a, tau = link.cdl(8, rg.num_time_samples + link.l_tot - 1, rg.bandwidth)
    y_time = link.channel(x_time, cir_to_time_channel(
        rg.bandwidth, a, tau, link.l_min, link.l_max, normalize=True),
        link.no(10.0))
    against_cpu(link.demod(y_time),
                OFDMDemodulator(128, link.l_min, 6, device="cpu")(
                    y_time.cpu()), "OFDMDemodulator")

    print(f"[19] detectors over CDL-A (4 streams, 8 BS antennas, QPSK, "
          f"128-FFT, perfect CSI, K1 BP-20) through sim_ber on {card}")
    calls = {}
    for name in ("det_lmmse", "det_kbest", "det_ep", "det_mmsepic",
                 "det_ml"):
        link, _ = run_mimo_link(dev, name, "f32")
        ebno_db, batch = MIMO_LINKS[name]["ebno_db"], MIMO_LINKS[name]["batch"]
        # its decisions on one batch on the card and on the CPU
        _, y, h, no = link.received(8, ebno_db)
        hard = link.detect(link.det, y, h, no).cpu() > 0
        hard_cpu = link.detect(link.detector("cpu"), y.cpu(), h.cpu(),
                               no.cpu()) > 0
        diff = int((hard != hard_cpu).sum())
        print(f"    {name}: {diff} of {hard.numel()} bit decisions differ "
              f"between the card and the CPU (bound "
              f"{DET_CPU_DIFF_PER_MILLE} per 1000)")
        if diff * 1000 > DET_CPU_DIFF_PER_MILLE * hard.numel():
            raise AssertionError(f"{name}: {diff} decisions differ between "
                                 "the card and the CPU")
        _, y, h, no = link.received(batch, ebno_db)
        with torch.no_grad():
            det_ms = median_ms(lambda: link.detect(link.det, y, h, no), 5)
        print(f"    {name}: detector {det_ms:.3f} ms per call (batch "
              f"{batch}, median of 5)")
        calls[name] = (lambda link=link, y=y, h=h, no=no:
                       link.detect(link.det, y, h, no), det_ms)
    # the profiler last: every launch after its window costs more
    print("[19] launches and device time per detector call "
          "(torch.profiler, batch 64)")
    for name, (call, det_ms) in calls.items():
        with torch.no_grad():
            device, host, busy = launches_per_call(call)
        print(f"    {name}: {device} kernels and copies on the device, "
              f"{host} cudaLaunchKernel, {busy:.3f} ms of device time in "
              f"a {det_ms:.3f} ms call ({100 * busy / det_ms:.1f} % busy)")
    sys.stdout.flush()
    results.put({"ldpc_lifted_bp_minsum": minsum})


def topology_sha256(topology):
    """SHA-256 over a drop's arrays (``los``, None, left out), as
    ``tools/sys_ref.py`` takes it."""
    h = hashlib.sha256()
    for x in topology:
        if x is not None:
            h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def on_card(what, tensors, dev):
    """Raises unless every tensor lies on ``dev``."""
    devices = {t.device for t in tensors}
    if devices != {dev}:
        raise AssertionError(f"{what}: tensors on {sorted(map(str, devices))}")


def check_drop(what, topology, want):
    got = topology_sha256(topology)
    print(f"    {what} drop SHA-256 {got[:16]}... (the JAX package's "
          f"{want[:16]}...)")
    if got != want:
        raise AssertionError(f"{what}: the drop differs from the JAX "
                             "package's of the same seed")


def run_multicell_slots(dev, card):
    """Phase 20: bench_sys's loop. Returns the loop and a slot's
    state for the profile at the end of the phases."""
    cfg = SYS_SLOTS
    config.seed = cfg["seed"]
    sim = MulticellSlots(device=dev)
    check_drop("config 5", sim.topology, SYS_SLOTS_TOPOLOGY)
    gen = torch.Generator(device=dev).manual_seed(20)
    n = cfg["slots_per_call"]
    state0 = sim.olla.init_state()
    _, bits, _ = sim.run(state0, n, gen)  # warm-up, its state dropped
    int(bits)
    state, nacks, total_bits = state0, 0, 0
    t0 = time.perf_counter()
    for _ in range(cfg["calls"]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, bits, n_nack = sim.run(state, n, gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        total_bits += int(bits)
        nacks += int(n_nack)
    dt = time.perf_counter() - t0
    on_card("[20]", [sim.n_re, sim.sinr_base, state[0], state[1], bits,
                     sim.phy_abs.bler_table_interp], dev)
    slots = n * cfg["calls"]
    outcomes = slots * sim.num_ut
    lo, hi = rate_band(*SYS_SLOTS_JAX, outcomes)
    share = nacks / outcomes
    print(f"    {slots} timed slots in {dt:.4f} s on {card}: "
          f"sys_multicell_slots_per_s {slots / dt:.3f}, "
          f"{1e3 * dt / slots:.4f} ms per slot, {total_bits} bits decoded, "
          f"no host sync inside a slot")
    print(f"    NACK share {share:.5f} ({nacks} of {outcomes}); band "
          f"[{lo:.5f}, {hi:.5f}] (JAX {SYS_SLOTS_JAX[0]} of "
          f"{SYS_SLOTS_JAX[1]})")
    if not lo <= share <= hi or total_bits <= 0:
        raise AssertionError(f"[20] NACK share {share} outside "
                             f"[{lo}, {hi}] or no bits")
    print(json.dumps({"metric": "sys_multicell_slots_per_s",
                      "value": slots / dt, "unit": "slots/s",
                      "card": card}))
    return sim, state, gen


def gain_band(stat, port_spread=None, port_reps=1):
    """The JAX repetitions' mean +- 5 standard deviations of the
    difference between it and one more repetition's value or, given the
    spread of ``port_reps`` repetitions on the port, the mean of those."""
    mean, spread = SYS_GAIN_JAX[stat]
    if port_spread is None:
        port_spread = spread
    half = 5 * (spread ** 2 / SYS_GAIN_REPS
                + port_spread ** 2 / port_reps) ** 0.5
    return mean - half, mean + half


def run_downlink_slots(dev, card):
    """Phase 21: the UMi downlink chain at 210 UTs."""
    cfg = SYS_DOWNLINK
    config.seed = cfg["seed"]
    gen = torch.Generator(device=dev).manual_seed(21)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = DownlinkSlots(generator=gen, device=dev)
    print(f"    built in {time.perf_counter() - t0:.2f} s "
          f"({sim.num_bs} sectors, {sim.num_ut} UTs, {sim.num_sym} x "
          f"{sim.num_sc} REs)")
    check_drop("UMi", sim.topology, SYS_GAIN_TOPOLOGY)

    # the links' gain over the drop's frozen LSPs and one channel draw
    check_link_gain(sim.link_gain_db(gen), "one draw", dev)

    state = sim.init_state()
    state, out = sim.slot(state, generator=gen)  # warm-up
    torch.cuda.synchronize()
    stage_ms = dict.fromkeys(DownlinkSlots.STAGES, 0.0)
    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    t0 = time.perf_counter()
    bits = harq = 0
    for _ in range(cfg["slots"]):
        events.clear()
        mark("start")
        state, out = sim.slot(state, generator=gen, mark=mark)
        torch.cuda.synchronize()
        for (_, e0), (name, e1) in zip(events, events[1:]):
            stage_ms[name] += e0.elapsed_time(e1)
        bits += int(out["bits"].sum())
        harq += int((out["harq"] >= 0).sum())
    dt = time.perf_counter() - t0
    on_card("[21]", list(out.values()) + list(state[0]) + list(state[1:]),
            dev)
    sinr = out["sinr"]
    if not (torch.isfinite(sinr).all() and (sinr >= 0).all()
            and sinr.shape == (1, sim.num_sym, sim.num_sc, sim.num_ut, 1)
            and bool(((out["harq"] >= -1) & (out["harq"] <= 1)).all())):
        raise AssertionError("[21] SINR or HARQ out of range")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    slots = cfg["slots"]
    print(f"    {slots} slots in {dt:.4f} s on {card}: "
          f"{slots / dt:.3f} slots/s, {1e3 * dt / slots:.3f} ms per slot "
          f"(host clock, a sync per slot), {bits} bits decoded, {harq} "
          f"HARQ outcomes, peak {peak:.2f} GiB")
    total = sum(stage_ms.values())
    for name, ms in stage_ms.items():
        print(f"    {name:14s} {ms / slots:9.3f} ms per slot "
              f"({100 * ms / total:5.1f} %)")

    # the same statistic over repetitions of the port's own draws, each
    # of new LSPs and one channel, as tools/sys_ref.py's repetitions
    reps = {"mean": [], "std": []}
    for r in range(SYS_GAIN_PORT_REPS):
        stats = check_link_gain(sim.link_gain_db(
            torch.Generator(device=dev).manual_seed(2100 + r),
            redraw_lsp=True), f"repetition {r}", dev)
        for stat, value in stats.items():
            reps[stat].append(value)
    for stat, values in reps.items():
        mean, spread = float(np.mean(values)), float(np.std(values, ddof=1))
        lo, hi = gain_band(stat, spread, len(values))
        jax_mean, jax_spread = SYS_GAIN_JAX[stat]
        print(f"    link gain {stat} over {len(values)} repetitions of the "
              f"port's draws: mean {mean:.4f} dB, spread {spread:.4f} "
              f"(JAX's {SYS_GAIN_REPS}: {jax_mean:.4f}, {jax_spread:.4f}); "
              f"band [{lo:.4f}, {hi:.4f}]")
        if not lo <= mean <= hi:
            raise AssertionError(f"[21] link gain {stat} over the port's "
                                 f"repetitions {mean} outside [{lo}, {hi}]")


def check_link_gain(gain_db, what, dev):
    """Phase 21: the mean and standard deviation [dB] over the links of
    one draw of ``DownlinkSlots.link_gain_db``, each in the band of one
    JAX repetition. Returns them."""
    on_card(f"[21] link gain, {what}", [gain_db], dev)
    stats = {"mean": float(gain_db.mean()),
             "std": float(gain_db.std(unbiased=False))}
    bands = {stat: gain_band(stat) for stat in stats}
    print(f"    link gain over {gain_db.numel()} links, {what}: " + "; ".join(
        f"{stat} {value:.4f} dB in [{bands[stat][0]:.4f}, "
        f"{bands[stat][1]:.4f}]" for stat, value in stats.items()))
    for stat, value in stats.items():
        if not bands[stat][0] <= value <= bands[stat][1]:
            raise AssertionError(f"[21] link gain {stat}, {what}, {value} "
                                 f"outside {bands[stat]}")
    return stats


def run_bler_points(dev, card, per_update):
    """Phase 22: BLER table points through CodedAWGNChannelNR (K1); then
    K1 at each MCS's code held against its plain version and timed with
    it, beside its bound (``per_update``: the FP32 instructions and
    operations of one boxplus edge-lane update)."""
    cfg = SYS_BLER
    config.seed = cfg["seed"]
    shipped = PHYAbstraction(device=dev)
    phy_abs = PHYAbstraction(device=dev)
    channel = CodedAWGNChannelNR(device=dev)
    seen = {"calls": 0, "devices": set()}

    def count(module, inputs, outputs):
        seen["calls"] += 1
        seen["devices"].update(t.device for t in outputs)

    channel.register_forward_hook(count)
    LIFTED_BP_KERNEL.library()  # built (or loaded) before the clock starts
    decoders = {}
    reset_launches()
    t0 = time.perf_counter()
    for mcs, snrs in SYS_BLER_POINTS.items():
        table = phy_abs.new_bler_table(
            list(snrs), [cfg["cbs"]],
            {"category": {0: {"index": {1: {"MCS": [mcs]}}}}},
            channel=channel, batch_size=cfg["batch"],
            max_mc_iter=cfg["mc_iter"], early_stop=False, verbose=False)
        decoders[mcs] = channel.decoder
        bler = table["category"][0]["index"][1]["MCS"][mcs]["CBS"][
            cfg["cbs"]]["BLER"]
        ref = shipped.get_bler(
            mcs, 1, 0, cfg["cbs"],
            torch.pow(10., torch.tensor(snrs, device=dev) / 10)).tolist()
        n_port = cfg["batch"] * cfg["mc_iter"]
        for snr, b, r in zip(snrs, bler, ref):
            lo, hi = rate_band(*SYS_BLER_JAX[(mcs, snr)], n_port)
            print(f"    MCS {mcs:2d} at {snr:6.2f} dB: BLER {b:.4f} "
                  f"({n_port} blocks), band [{lo:.4f}, {hi:.4f}], shipped "
                  f"table {r:.4f}")
            if not lo <= b <= hi:
                raise AssertionError(f"[22] MCS {mcs} at {snr} dB: BLER {b} "
                                     f"outside [{lo}, {hi}]")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1 = LIFTED_BP_KERNEL.variant_launches.get("f32", 0)
    print(f"    K1 (ldpc_lifted_bp, f32) launches {k1} in {seen['calls']} "
          f"decoder calls, {LIFTED_BP_KERNEL.launches} lifted launches in "
          f"all; table-making {1e3 * dt / seen['calls']:.3f} ms per decoder "
          f"call (host clock over the three new_bler_table calls, their "
          f"interpolation, the shipped table's reads and the prints "
          f"included) on {card}; devices "
          f"{sorted(map(str, seen['devices']))}")
    if k1 != seen["calls"] or LIFTED_BP_KERNEL.launches != k1:
        raise AssertionError("[22] K1 launches differ from decoder calls")
    on_card("[22]", [phy_abs.bler_table_interp,
                     *channel.decoder.buffers()], dev)
    if seen["devices"] != {dev}:
        raise AssertionError(f"[22] tensors on {seen['devices']}")

    # K1 alone at each MCS's code, after the counts were read: the
    # decoder's own input (rate recovery of BPSK LLRs), held identical to
    # the plain decode, then the two timed in turns
    gen = torch.Generator(device=dev).manual_seed(22)
    batch = cfg["batch"]
    for mcs, dec in decoders.items():
        it = dec.num_iter
        llr = dec.recover_llrs(noisy_llrs(dec.encoder, batch, 3.0, gen)[1])
        ker, plain = variant_calls("ldpc_lifted_bp", dec.lifted)
        shape = (f"MCS {mcs}'s code (k={dec.encoder.k}, n={dec.encoder.n}, "
                 f"Z={dec.lifted._z}) x {batch}, BP-{it} boxplus")
        err = assert_identical(ker(llr, it), plain(llr, it), f"[22] {shape}")
        (k_a, k_b), (p_a, p_b) = in_turns(lambda: ker(llr, it),
                                          lambda: plain(llr, it), 10, 2)
        bound = lifted_bound(dec.lifted, batch, it, per_update)
        print(f"    ldpc_lifted_bp, {shape}: max|kernel-plain| {err:.3e}; "
              f"kernel {k_a:.3f} / {k_b:.3f} ms, plain {p_a:.3f} / "
              f"{p_b:.3f} ms per call on {card}; bound {bound[0]:.3f} ms "
              f"({bound[1]}), {100 * bound[0] / min(k_a, k_b):.1f} % of it")


def sys_phases(card, results, per_update):
    """Phases 20-22, run in a fresh process by ``main``; ``per_update``
    as ``run_bler_points`` takes it."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[20] BASELINE config 5 as bench_sys runs it (21 UMi sectors x 4 "
          f"UTs, distance-proxy SINR, OLLA, PHY abstraction) on {card}")
    sim, state, gen = run_multicell_slots(dev, card)
    print(f"[21] config 5 with the TR 38.901 UMi channel (21 sectors x 10 "
          f"UTs, 14 x 612 REs at 30 kHz, downlink) on {card}")
    run_downlink_slots(dev, card)
    print(f"[22] BLER table points through CodedAWGNChannelNR (K1) on "
          f"{card}")
    run_bler_points(dev, card, per_update)
    # the profiler last: every launch after its window costs more
    harq = torch.full((sim.num_ut,), -1, dtype=torch.int32, device=dev)

    def one_slot():
        fading = torch.empty(sim.num_ut, device=dev).exponential_(
            generator=gen)
        sim.slot(state, harq, fading, generator=gen)

    slot_ms = median_ms(one_slot, 20)
    device, host, busy = launches_per_call(one_slot)
    print(f"[20] one slot of bench_sys's loop: {device} kernels and copies "
          f"on the device, {host} cudaLaunchKernel, {busy:.3f} ms of "
          f"device time in a {slot_ms:.3f} ms slot "
          f"({100 * busy / slot_ms:.1f} % busy; torch.profiler)")
    sys.stdout.flush()
    results.put({})


def load_golden(path):
    """(bits, grid) of a stored PUSCH waveform of ``tests/nr``: its bits
    are pickled as a TensorFlow tensor, which reads back here as a NumPy
    array (no TensorFlow needed); every other class as NumPy's."""
    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if (module, name) == ("tensorflow.python.framework.ops",
                                  "convert_to_tensor"):
                return lambda value, *args, **kwargs: np.asarray(value)
            return super().find_class(module, name)

    with open(path, "rb") as f:
        if np.lib.format.read_magic(f) == (1, 0):
            np.lib.format.read_array_header_1_0(f)
        else:
            np.lib.format.read_array_header_2_0(f)
        b, grid = Unpickler(f).load()
    return np.asarray(b), np.asarray(grid)


def golden_pusch_config(cfg):
    """The port's PUSCHConfig of a golden configuration (the settings of
    tests/test_nr.py:load_pusch_config)."""
    pc = PUSCHConfig()
    pc.carrier.n_cell_id = cfg["carrier"]["n_cell_id"]
    pc.carrier.slot_number = cfg["carrier"]["slot_number"]
    p = cfg["pusch"]
    pc.n_size_bwp = p["n_size_bwp"]
    pc.symbol_allocation = p["symbol_allocation"]
    pc.n_rnti = p["n_rnti"]
    pc.num_antenna_ports = p["num_antenna_ports"]
    pc.num_layers = p["num_layers"]
    pc.precoding = p["precoding"]
    if pc.precoding == "codebook":
        pc.tpmi = p["tpmi"]
    for name in ("length", "config_type", "additional_position",
                 "num_cdm_groups_without_data", "dmrs_port_set", "n_scid",
                 "n_id"):
        setattr(pc.dmrs, name, p["dmrs"][name])
    pc.tb.mcs_index = p["tb"]["mcs_index"]
    pc.tb.mcs_table = p["tb"]["mcs_table"]
    return pc


def run_nr_goldens(dev):
    """Phase 23: the port's PUSCHTransmitter on the stored waveforms
    GOLDEN_IDS of tests/nr/pusch_test_configs (within WAVEFORM_ATOL) and
    TBEncoder on every tests/nr/tb_refs case (bit-exact, with and without
    the scrambler), on the card."""
    cfg_dir = os.path.join(NR_DIR, "pusch_test_configs")
    t0 = time.perf_counter()
    worst, outputs = 0.0, []
    for i in GOLDEN_IDS:
        b, grid = load_golden(os.path.join(cfg_dir, f"test_{i}.npy"))
        with open(os.path.join(cfg_dir, f"test_{i}.json")) as f:
            pc = golden_pusch_config(json.load(f))
        tx = PUSCHTransmitter(pc, return_bits=False, device=dev)
        x = tx(torch.as_tensor(b.astype(np.float32), device=dev))
        outputs.append(x)
        xg = x[0, 0].permute(2, 1, 0).squeeze().cpu().numpy()
        err = float(np.abs(xg - grid).max())
        worst = max(worst, err)
        if xg.shape != grid.shape or not err <= WAVEFORM_ATOL:
            raise AssertionError(f"[23] waveform {i}: max |port - stored| "
                                 f"{err} (bound {WAVEFORM_ATOL})")
    wave_s = time.perf_counter() - t0
    cases = sorted(glob.glob(os.path.join(NR_DIR, "tb_refs", "*.npz")))
    t0 = time.perf_counter()
    for path in cases:
        data = np.load(path)
        u = torch.as_tensor(data["u_ref"].astype(np.float32), device=dev)
        for scrambler, want in ((True, data["c_ref"]),
                                (False, data["c_ref_no_scr"])):
            enc = TBEncoder(
                target_tb_size=data["u_ref"].shape[1],
                num_coded_bits=data["c_ref"].shape[1],
                target_coderate=float(data["coderate"]),
                num_bits_per_symbol=int(data["num_bits_per_symbol"]),
                num_layers=int(data["num_layers"]),
                n_rnti=int(data["n_rnti"]), n_id=int(data["n_id"]),
                use_scrambler=scrambler, device=dev)
            c = enc(u)
            outputs.append(c)
            if not np.array_equal(c.cpu().numpy().astype(np.int64),
                                  want.astype(np.int64)):
                raise AssertionError(f"[23] {os.path.basename(path)}: TB "
                                     f"encoder differs (scrambler "
                                     f"{scrambler})")
    on_card("[23]", outputs, dev)
    print(f"    {len(GOLDEN_IDS)} stored waveforms within {WAVEFORM_ATOL:g} (max "
          f"|port - stored| {worst:.3e}) in {wave_s:.2f} s; {len(cases)} TB "
          f"references bit-exact with and without the scrambler in "
          f"{time.perf_counter() - t0:.2f} s; every output on {dev}")


def pusch_config(n_size_grid):
    """The PUSCH tutorial's settings (docs/tutorials/04_5g_nr_pusch.md:
    30 kHz, 2 antenna ports, 2 layers, codebook TPMI 1, DMRS type 1 with
    one additional position, MCS 14 of table 1) at ``n_size_grid``
    PRBs."""
    pc = PUSCHConfig()
    pc.carrier.subcarrier_spacing = 30
    pc.carrier.n_size_grid = n_size_grid
    pc.num_antenna_ports = 2
    pc.num_layers = 2
    pc.precoding = "codebook"
    pc.tpmi = 1
    pc.dmrs.config_type = 1
    pc.dmrs.additional_position = 1
    pc.tb.mcs_index = 14
    return pc


class PuschLink:
    """Phases 24-25: ``tools/pusch_bler.py``'s link on the port's public
    blocks: PUSCHTransmitter, CDL-B uplink (UE: one dual-polarized
    element, the 2 ports; BS: config 3's 1 x 2 cross-polarized array)
    through OFDMChannel (or TimeChannel for ``domain="time"``) with AWGN,
    PUSCHReceiver (LS "lin", or ``csi="perfect"``; LMMSE max-log;
    TBDecoder boxplus-phi BP-20 on K1, or ``minsum``: min-sum BP-12 on
    K2). A call is one MC iteration (the sim_ber model) and one TBDecoder
    call. ``stages`` runs the frequency-domain LS link with OFDMChannel's
    two halves split and ``mark``s the end of each stage, the transmitter's
    and receiver's inner stages through forward hooks."""

    def __init__(self, dev, n_size_grid, domain="freq", csi=None,
                 minsum=False):
        self.dev, self.calls, self.devices = dev, 0, set()
        self.perfect = csi == "perfect"
        pc = pusch_config(n_size_grid)
        self.nbps, self.rate = pc.tb.num_bits_per_symbol, \
            pc.tb.target_coderate
        self.tx = PUSCHTransmitter(pc, output_domain=domain, device=dev)
        self.rg = rg = self.tx.resource_grid
        ue = AntennaArray(num_rows=1, num_cols=1, polarization="dual",
                          polarization_type="cross",
                          antenna_pattern="38.901", carrier_frequency=PUSCH_FC)
        self.cdl = CDL("B", 100e-9, PUSCH_FC, ue, cross_array(2, PUSCH_FC),
                       "uplink", min_speed=3., device=dev)
        rkw = dict(channel_estimator=csi, return_tb_crc_status=True,
                   input_domain=domain)
        if domain == "time":
            self.channel = TimeChannel(self.cdl, rg.bandwidth,
                                       rg.num_time_samples,
                                       normalize_channel=True,
                                       return_channel=self.perfect,
                                       device=dev)
            rkw["l_min"] = self.channel.l_min
        else:
            self.channel = OFDMChannel(self.cdl, rg, normalize_channel=True,
                                       return_channel=self.perfect,
                                       device=dev)
        if minsum:
            rkw["tb_decoder"] = TBDecoder(self.tx._tb_encoder, num_bp_iter=12,
                                          cn_update="minsum", device=dev)
        self.rx = PUSCHReceiver(self.tx, device=dev, **rkw)
        self.freqs = subcarrier_frequencies(rg.fft_size,
                                            rg.subcarrier_spacing, device=dev)
        self.k = self.tx._tb_size
        self._mark = None
        dec = self.rx._tb_decoder
        ldpc = dec._decoder
        for module, name, pre in (
                (self.tx._tb_encoder, "source and TB encode", False),
                (self.tx._precoder, "map, layer map, RG map, precode",
                 False),
                (self.rx._channel_estimator if csi is None else None,
                 "LS estimation and lin interpolation", False),
                (self.rx._mimo_detector, "LMMSE detection, max-log demap",
                 False),
                (ldpc, "layer demap, descramble, deinterleave", True),
                (ldpc, "K1: LDPC5GDecoder (rate recovery, BP-20)", False),
                (dec, "CB and TB CRCs", False)):
            if module is None:
                continue
            hook = functools.partial(self._hook, name)
            if pre:
                module.register_forward_pre_hook(hook)
            else:
                module.register_forward_hook(hook)

    def _hook(self, name, *args):
        if self._mark is not None:
            self._mark(name)

    def no(self, ebno_db):
        return ebnodb2no(ebno_db, self.nbps, self.rate, self.rg).to(self.dev)

    def __call__(self, batch_size, ebno_db):
        no = self.no(ebno_db)
        x, b = self.tx(int(batch_size))
        if self.perfect:
            y, h = self.channel(x, no)
            b_hat, crc = self.rx(y, no, h)
        else:
            y = self.channel(x, no)
            b_hat, crc = self.rx(y, no)
        self.calls += 1
        self.devices.update(str(t.device) for t in (no, x, b, y, b_hat, crc))
        return b, b_hat

    def stages(self, batch_size, ebno_db, mark):
        """One MC iteration of the frequency-domain LS link, ``mark``ing
        the end of each stage."""
        rg, no = self.rg, self.no(ebno_db)
        self._mark = mark
        try:
            x, _ = self.tx(batch_size)
            a, tau = self.cdl(batch_size, rg.num_ofdm_symbols,
                              1 / rg.ofdm_symbol_duration)
            mark("CDL-B (14 steps)")
            h = cir_to_ofdm_channel(self.freqs, a, tau, normalize=True)
            y = self.channel.app(x, h, no)
            mark("CIR -> OFDM, channel application, noise")
            self.rx(y, no)
        finally:
            self._mark = None


def run_pusch_link(dev, card):
    """Phase 24: the tutorial's PUSCH link over CDL-B through sim_ber at
    PUSCH["ebno_db"], every count at 0 just before and read just after:
    the TB BLER inside the JAX band, one K1 launch per TBDecoder call;
    then perfect CSI and the time domain at a high SNR (BER 0), and the
    min-sum TBDecoder on K2."""
    cfg = PUSCH
    link = PuschLink(dev, cfg["n_size_grid"])
    reset_launches()
    t0 = time.perf_counter()
    ber, bler = sim_ber(link, [cfg["ebno_db"]], batch_size=cfg["batch"],
                        max_mc_iter=cfg["mc_iter"], early_stop=False,
                        verbose=False)
    torch.cuda.synchronize()
    launches = {kern.name: dict(kern.variant_launches) for kern in KERNELS}
    bler = float(bler[0])
    lo, hi = bler_band("pusch", cfg["ebno_db"])
    print(f"    {cfg['n_size_grid']} PRBs (TB {link.k} bits, "
          f"{link.tx._tb_encoder.num_cbs} code blocks of n="
          f"{link.tx._tb_encoder.ldpc_encoder.n}) at {cfg['ebno_db']} dB, "
          f"batch {cfg['batch']} x {cfg['mc_iter']}: TB BLER {bler:.5f} "
          f"(band [{lo:.4f}, {hi:.4f}]), BER {float(ber[0]):.3e}, "
          f"{link.calls} TBDecoder calls, launches {launches}, devices "
          f"{sorted(link.devices)}, {time.perf_counter() - t0:.2f} s")
    if not lo <= bler <= hi:
        raise AssertionError(f"[24] TB BLER {bler} outside [{lo}, {hi}]")
    if link.devices != {"cuda:0"}:
        raise AssertionError(f"[24] tensors on {link.devices}")
    if launches != {LIFTED_BP_KERNEL.name: {"f32": link.calls},
                    LAYERED_BP_KERNEL.name: {}}:
        raise AssertionError(f"[24] {launches} for {link.calls} TBDecoder "
                             "calls")
    for what, kw, variant in (
            ("perfect CSI", dict(csi="perfect"), "f32"),
            ("time domain (TimeChannel, OFDMDemodulator)",
             dict(domain="time"), "f32"),
            ("min-sum TBDecoder, BP-12", dict(minsum=True), "f32+minsum")):
        link = PuschLink(dev, cfg["n_size_grid"], **kw)
        reset_launches()
        b, b_hat = link(PUSCH_CHECK["batch"], PUSCH_CHECK["ebno_db"])
        ber = float((b != b_hat).float().mean())
        launches = {kern.name: dict(kern.variant_launches)
                    for kern in KERNELS}
        print(f"    {what}: BER {ber} at {PUSCH_CHECK['ebno_db']} dB, batch "
              f"{PUSCH_CHECK['batch']}; launches {launches}; devices "
              f"{sorted(link.devices)}")
        if ber != 0.0:
            raise AssertionError(f"[24] {what}: BER {ber} at "
                                 f"{PUSCH_CHECK['ebno_db']} dB")
        if link.devices != {"cuda:0"}:
            raise AssertionError(f"[24] {what}: tensors on {link.devices}")
        if launches != {LIFTED_BP_KERNEL.name: {variant: 1},
                        LAYERED_BP_KERNEL.name: {}}:
            raise AssertionError(f"[24] {what}: {launches} for one TBDecoder "
                                 "call")


def run_pusch_full_width(dev, card, per_update):
    """Phase 25: the same settings at 273 PRBs (100 MHz at 30 kHz), batch
    64: every count at 0 before the timed iterations and read after (one
    K1 launch per iteration), the stages (CUDA events), ms per MC
    iteration, info-bit Mbit/s, peak memory; then K1 alone on the
    iteration's own decoder input, held identical to its plain decode and
    timed in turns with it, beside its bound (``per_update``: FP32
    instructions and operations of one boxplus edge-lane update); last,
    the launches and device busy share of one iteration
    (``torch.profiler``). Returns the iteration for the profiler."""
    cfg = PUSCH_FULL
    batch, ebno_db = cfg["batch"], cfg["ebno_db"]
    t0 = time.perf_counter()
    link = PuschLink(dev, cfg["n_size_grid"])
    enc = link.tx._tb_encoder
    print(f"    {cfg['n_size_grid']} PRBs: TB {enc.tb_size} bits, "
          f"{enc.num_cbs} code blocks of k={enc.cb_size}, n="
          f"{enc.ldpc_encoder.n} (BG{enc.ldpc_encoder._bg[-1]}, Z="
          f"{enc.ldpc_encoder.z}), rate-matched lengths "
          f"{sorted(set(enc.cw_lengths.tolist()))}; blocks built in "
          f"{time.perf_counter() - t0:.2f} s")
    seen = {}
    dec = link.rx._tb_decoder._decoder
    dec.register_forward_pre_hook(
        lambda module, args: seen.__setitem__("llr_cb", args[0]))
    with torch.no_grad():
        link(batch, ebno_db)  # warm-up: the scrambler's sequences, plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        errors, iters = 0, 0

        def iteration():
            nonlocal errors, iters
            b, b_hat = link(batch, ebno_db)
            errors += int((b != b_hat).any(dim=-1).sum())
            iters += 1

        it_ms = median_ms(iteration, 5)
        k1 = LIFTED_BP_KERNEL.variant_launches.get("f32", 0)
        launches = {kern.name: dict(kern.variant_launches)
                    for kern in KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        stages = marked_stage_ms(
            lambda mark: link.stages(batch, ebno_db, mark), 5)
    bler = errors / (iters * batch)
    print(f"    {iters} MC iterations at {ebno_db} dB: TB BLER {bler:.4f}, "
          f"launches {launches} (one K1 launch per iteration), peak memory "
          f"{peak:.2f} GiB, devices {sorted(link.devices)}")
    if k1 != iters or launches != {LIFTED_BP_KERNEL.name: {"f32": iters},
                                   LAYERED_BP_KERNEL.name: {}}:
        raise AssertionError(f"[25] {launches} in {iters} iterations")
    if link.devices != {"cuda:0"}:
        raise AssertionError(f"[25] tensors on {link.devices}")
    if not bler <= PUSCH_FULL_MAX_BLER:
        raise AssertionError(f"[25] TB BLER {bler} at {ebno_db} dB above "
                             f"{PUSCH_FULL_MAX_BLER}")
    total = sum(stages.values())
    for stage, t in stages.items():
        print(f"      {stage:42s} {t:9.3f} ms  {100 * t / total:5.1f} %")
    print(f"      {'sum of stages':42s} {total:9.3f} ms")
    bits = batch * link.k
    print(f"    pusch_273prb_info_bit_throughput: {bits / it_ms / 1e3:.3f} "
          f"Mbit/s ({it_ms:.3f} ms per MC iteration, median of 5, batch "
          f"{batch} x {link.k} info bits) on {card}")

    # K1 alone at the iteration's own code and input, after the counts
    # were read
    llr = dec.recover_llrs(seen["llr_cb"])
    it = dec.num_iter
    ker, plain = variant_calls("ldpc_lifted_bp", dec.lifted)
    shape = (f"BG1 Z={dec.lifted._z}, n={dec.encoder.n} x {llr.shape[0]}, "
             f"BP-{it} boxplus-phi")
    err = assert_identical(ker(llr, it), plain(llr, it), f"[25] {shape}")
    (k_a, k_b), (p_a, p_b) = in_turns(lambda: ker(llr, it),
                                      lambda: plain(llr, it), 10, 2)
    bound = lifted_bound(dec.lifted, llr.shape[0], it, per_update)
    print(f"    ldpc_lifted_bp, {shape}: max|kernel-plain| {err:.3e}; kernel "
          f"{k_a:.3f} / {k_b:.3f} ms, plain {p_a:.3f} / {p_b:.3f} ms per "
          f"call on {card}; bound {bound[0]:.3f} ms ({bound[1]}), "
          f"{100 * bound[0] / min(k_a, k_b):.1f} % of it; FP32 issue "
          f"{bound[2]:.3f} ms")
    print(f"      {launch_line('ldpc_lifted_bp', dec.lifted, llr.shape[0])}")
    return lambda: link(batch, ebno_db), it_ms


def nr_phases(card, results, per_update):
    """Phases 23-25, run in a fresh process by ``main``; ``per_update``
    as ``run_pusch_full_width`` takes it."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    config.seed = PUSCH_SEED
    t0 = time.perf_counter()
    print(f"[23] the PUSCH transmitter and TB encoder against the stored "
          f"references on {card}")
    run_nr_goldens(dev)
    print(f"[24] the PUSCH tutorial's link (16 PRBs, 2 layers, TPMI 1, "
          f"MCS 14) over CDL-B through sim_ber on {card}")
    run_pusch_link(dev, card)
    print(f"[25] the same settings at 273 PRBs, batch 64 on {card}")
    call, it_ms = run_pusch_full_width(dev, card, per_update)
    # the profiler last: every launch after its window costs more
    with torch.no_grad():
        device, host, busy = launches_per_call(call)
    print(f"[25] one MC iteration at 273 PRBs: {device} kernels and copies "
          f"on the device, {host} cudaLaunchKernel, {busy:.3f} ms of device "
          f"time in a {it_ms:.3f} ms iteration ({100 * busy / it_ms:.1f} % "
          f"busy; torch.profiler)")
    print(f"    phases 23-25: {time.perf_counter() - t0:.1f} s")
    sys.stdout.flush()
    results.put({})


class FlatLink:
    """Phase 26: ``tools/flat_fading_bler.py``'s two links on the port's
    public blocks, one ``LDPC5GDecoder`` (k=512, n=1024: BG2 Z=64;
    boxplus BP-20, hard decisions; the lifted engine, K1) for both. A call
    (the sim_ber model) is one MC iteration of the MIMO link: 4 x 16
    antennas over ``FlatFadingChannel`` with Kronecker correlation and
    AWGN, LMMSE, APP demapping; ``bsc`` one of the BSC link. ``calls``
    counts decoder calls; ``devices`` collects every tensor's device."""

    def __init__(self, dev):
        c = FLAT
        self.dev, self.calls, self.devices = dev, 0, set()
        self.src = BinarySource(device=dev)
        self.enc = LDPC5GEncoder(c["k"], c["n"], device=dev)
        self.dec = LDPC5GDecoder(self.enc, hard_out=True, device=dev)
        self.mapper = Mapper("qam", c["nbps"], device=dev)
        self.demapper = Demapper("app", "qam", c["nbps"], device=dev)
        corr = KroneckerModel(exp_corr_mat(0.4, c["num_tx"], device=dev),
                              exp_corr_mat(0.9, c["num_rx"], device=dev))
        self.channel = FlatFadingChannel(c["num_tx"], c["num_rx"],
                                         spatial_corr=corr,
                                         return_channel=True, device=dev)
        self.bsc_channel = BinarySymmetricChannel(return_llrs=True,
                                                  device=dev)
        self.eye = torch.eye(c["num_rx"], device=dev)
        self.dec.register_forward_hook(self._count)

    def _count(self, module, args, out):
        self.calls += 1
        self.devices.update(str(t.device) for t in (*args, out))

    def stages(self, batch_size, ebno_db, mark=lambda name: None):
        """One MC iteration of the MIMO link, ``mark``ing the end of each
        stage: (info bits, decisions) [batch, 4, 512]."""
        c = FLAT
        b = self.src([batch_size, c["num_tx"], c["k"]])
        x = self.mapper(self.enc(b))
        mark("source, encode, map")
        shape = x.shape
        no = ebnodb2no(ebno_db, c["nbps"], c["k"] / c["n"]).to(self.dev) \
            * c["num_rx"] ** 0.5
        y, h = self.channel(x.reshape(-1, c["num_tx"]), no)
        mark("flat fading (Kronecker), AWGN")
        x_hat, no_eff = lmmse_equalizer(y, h,
                                        (no * self.eye).to(torch.complex64))
        mark("LMMSE equalizer")
        llr = self.demapper(x_hat.reshape(shape), no_eff.reshape(shape))
        mark("APP demap")
        b_hat = self.dec(llr)
        mark("K1: LDPC5GDecoder (BP-20)")
        self.devices.update(str(t.device)
                            for t in (b, x, no, y, h, x_hat, llr, b_hat))
        return b, b_hat

    def __call__(self, batch_size, ebno_db):
        return self.stages(int(batch_size), ebno_db)

    def bsc(self, batch_size, pb):
        """One MC iteration of the BSC link at flip probability ``pb``."""
        b = self.src([int(batch_size), FLAT["k"]])
        llr = self.bsc_channel(self.enc(b), pb)
        b_hat = self.dec(llr)
        self.devices.update(str(t.device) for t in (b, llr, b_hat))
        return b, b_hat


def check_against_cpu(what, card, cpu, bound):
    """Raises unless ``card`` (on the card) and ``cpu`` agree within
    ``bound`` of the largest magnitude of ``cpu``; returns the error."""
    if card.device.type != "cuda":
        raise AssertionError(f"{what}: on {card.device}")
    err = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
    if not err <= bound:
        raise AssertionError(f"{what}: card against CPU {err:.3e} > "
                             f"{bound:.0e}")
    return err


def run_flat_links(dev, card, per_update):
    """Phase 26: both links through sim_ber, every count at 0 just before
    and read just after: BLER inside the JAX band, one K1 launch per
    decoder call, every tensor on the card; the MIMO link's stages,
    iteration time, Mbit/s and peak memory; PerColumnModel and Rayleigh
    block fading against themselves on the CPU, CIRDataset into
    OFDMChannel on the card; K1 alone at the links' code and batch,
    held identical to its plain decode and timed in turns with it,
    beside its bound (``per_update`` as ``lifted_bound`` takes it)."""
    c, cb = FLAT, FLAT_BSC
    link = FlatLink(dev)
    for name, model, point, batch, mc_iter, per_call in (
            ("mimo", link, c["ebno_db"], c["batch"], c["mc_iter"],
             c["num_tx"]),
            ("bsc", link.bsc, cb["pb"], cb["batch"], cb["mc_iter"], 1)):
        link.calls, link.devices = 0, set()
        reset_launches()
        t0 = time.perf_counter()
        ber, bler = sim_ber(model, [point], batch_size=batch,
                            max_mc_iter=mc_iter, early_stop=False,
                            verbose=False)
        torch.cuda.synchronize()
        launches = {kern.name: dict(kern.variant_launches)
                    for kern in KERNELS}
        bler = float(bler[0])
        lo, hi = rate_band(*FLAT_JAX[name], batch * per_call * mc_iter)
        print(f"    {name} at {point}: BLER {bler:.5f} over "
              f"{batch * per_call * mc_iter} codewords (band [{lo:.4f}, "
              f"{hi:.4f}]), BER {float(ber[0]):.3e}, {link.calls} decoder "
              f"calls, launches {launches}, devices {sorted(link.devices)}, "
              f"{time.perf_counter() - t0:.2f} s")
        if not lo <= bler <= hi:
            raise AssertionError(f"[26] {name}: BLER {bler} outside "
                                 f"[{lo}, {hi}]")
        if link.devices != {str(dev)}:
            raise AssertionError(f"[26] {name}: tensors on {link.devices}")
        if launches != {LIFTED_BP_KERNEL.name: {"f32": link.calls},
                        LAYERED_BP_KERNEL.name: {}} or link.calls != mc_iter:
            raise AssertionError(f"[26] {name}: {launches} for {link.calls} "
                                 "decoder calls")

    batch, ebno_db = c["batch"], c["ebno_db"]
    with torch.no_grad():
        link(batch, ebno_db)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        it_ms = median_ms(lambda: link(batch, ebno_db), 5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        stages = marked_stage_ms(
            lambda mark: link.stages(batch, ebno_db, mark), 5)
    total = sum(stages.values())
    for stage, t in stages.items():
        print(f"      {stage:32s} {t:9.3f} ms  {100 * t / total:5.1f} %")
    print(f"      {'sum of stages':32s} {total:9.3f} ms")
    bits = batch * c["num_tx"] * c["k"]
    print(f"    flat-fading MIMO link: {bits / it_ms / 1e3:.3f} Mbit/s of "
          f"info bits ({it_ms:.3f} ms per MC iteration, median of 5, "
          f"batch {batch} x {c['num_tx']} codewords, {ebno_db} dB), peak "
          f"memory {peak:.2f} GiB on {card}")

    # the correlation and Rayleigh models on the card against the CPU
    gen = torch.Generator(device=dev).manual_seed(FLAT_SEED)
    h = GenerateFlatFadingChannel(c["num_tx"], c["num_rx"], device=dev)(
        batch, generator=gen)
    r = exp_corr_mat(torch.tensor([0.2, 0.5, 0.8, 0.95]), c["num_rx"],
                     device=dev)
    err = check_against_cpu(
        "[26] PerColumnModel", PerColumnModel(r)(h),
        PerColumnModel(r.cpu())(h.cpu()), FLAT_CPU_RTOL)
    a, tau = RayleighBlockFading(1, c["num_rx"], 1, c["num_tx"],
                                 device=dev)(256, 14, generator=gen)
    if not bool((a == a[..., :1]).all()) or tau.device != dev:
        raise AssertionError("[26] Rayleigh block fading: not one draw "
                             "per block on the card")
    freqs = subcarrier_frequencies(64, 30e3, device=dev)
    err_ray = check_against_cpu(
        "[26] Rayleigh CIR -> OFDM", cir_to_ofdm_channel(freqs, a, tau),
        cir_to_ofdm_channel(freqs.cpu(), a.cpu(), tau.cpu()), FLAT_CPU_RTOL)
    a_np, tau_np = a.cpu().numpy(), tau.cpu().numpy()

    def examples():
        yield from zip(a_np, tau_np)

    rg = ResourceGrid(num_ofdm_symbols=14, fft_size=64,
                      subcarrier_spacing=30e3, num_tx=1,
                      num_streams_per_tx=c["num_tx"])
    x = QAMSource(4, device=dev)([256, 1, c["num_tx"], 14, 64],
                                 generator=gen)
    outs = []
    for d in (dev, torch.device("cpu")):
        dataset = CIRDataset(examples, 256, 1, c["num_rx"], 1, c["num_tx"],
                             1, 14, device=d)
        outs.append(OFDMChannel(dataset, rg, add_awgn=False,
                                return_channel=True, device=d)(x.to(d)))
    err_cir = max(check_against_cpu(f"[26] CIRDataset -> OFDMChannel {w}",
                                    on, cpu, FLAT_CPU_RTOL)
                  for w, on, cpu in zip(("y", "h"), *outs))
    print(f"    against the CPU (of the largest value): PerColumnModel "
          f"{err:.2e}, Rayleigh block fading -> OFDM {err_ray:.2e}, "
          f"CIRDataset of its draws -> OFDMChannel {err_cir:.2e} "
          f"(bound {FLAT_CPU_RTOL:.0e}), all on {dev}")

    # K1 alone at the links' code and batch, after the counts were read
    dec, it, n_cw = link.dec, link.dec.num_iter, FLAT_BSC["batch"]
    llr = dec.recover_llrs(noisy_llrs(link.enc, n_cw, 1.5, gen)[1])
    ker, plain = variant_calls("ldpc_lifted_bp", dec.lifted)
    shape = (f"BG2 Z={dec.lifted._z}, n={c['n']} x {n_cw}, BP-{it} "
             f"boxplus")
    err = assert_identical(ker(llr, it), plain(llr, it), f"[26] {shape}")
    (k_a, k_b), (p_a, p_b) = in_turns(lambda: ker(llr, it),
                                      lambda: plain(llr, it), 10, 2)
    bound = lifted_bound(dec.lifted, n_cw, it, per_update)
    print(f"    ldpc_lifted_bp, {shape}: max|kernel-plain| {err:.3e}; kernel "
          f"{k_a:.3f} / {k_b:.3f} ms, plain {p_a:.3f} / {p_b:.3f} ms per "
          f"call on {card}; bound {bound[0]:.3f} ms ({bound[1]}), "
          f"{100 * bound[0] / min(k_a, k_b):.1f} % of it; FP32 issue "
          f"{bound[2]:.3f} ms")
    print(f"      {launch_line('ldpc_lifted_bp', dec.lifted, n_cw)}")


PULSE_FILTERS = {
    "RaisedCosineFilter": lambda c, **kw: RaisedCosineFilter(
        c["span"], c["sps"], c["beta"], **kw),
    "RootRaisedCosineFilter": lambda c, **kw: RootRaisedCosineFilter(
        c["span"], c["sps"], c["beta"], **kw),
    "SincFilter": lambda c, **kw: SincFilter(c["span"], c["sps"], **kw),
    "CustomFilter": lambda c, **kw: CustomFilter(
        c["sps"], np.hanning(c["span"] * c["sps"] + 1), **kw),
}


def run_pulse_shaping(dev, card):
    """Phase 27: the pulse-shaping tutorial's chain on the card (its
    symbols back within the truncated RRC's ISI floor, its ACLR near the
    filter's), every filter class with and without each window against
    itself on the CPU, and ms per call of each stage."""
    c = PULSE
    rrc = RootRaisedCosineFilter(c["span"], c["sps"], c["beta"], device=dev)
    up = Upsampling(c["sps"], device=dev)
    down = Downsampling(c["sps"], offset=c["span"] * c["sps"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(FLAT_SEED + 1)
    x = QAMSource(4, device=dev)([c["batch"], c["num_symbols"]],
                                 generator=gen)
    with torch.no_grad():
        x_up = up(x)
        x_rrc = rrc(x_up)
        y = rrc(x_rrc, padding="full", conjugate=True)
        x_hat = down(y)[..., :c["num_symbols"]]
    on_card("[27]", [x, x_up, x_rrc, y, x_hat], dev)
    isi = float((x_hat - x).abs().max())
    aclr = float(empirical_aclr(x_rrc, oversampling=c["sps"]))
    print(f"    RRC span {c['span']}, {c['sps']} samples per symbol, beta "
          f"{c['beta']}, 16-QAM [{c['batch']}, {c['num_symbols']}]: max "
          f"|x_hat - x| {isi:.3e} (ISI floor {PULSE_ISI_MAX:.0e}); ACLR "
          f"empirical {aclr:.5f}, filter {rrc.aclr:.5f} (within "
          f"{PULSE_ACLR_RTOL:.0%})")
    if not isi <= PULSE_ISI_MAX:
        raise AssertionError(f"[27] cascade error {isi} > {PULSE_ISI_MAX}")
    if not abs(aclr - rrc.aclr) <= PULSE_ACLR_RTOL * rrc.aclr:
        raise AssertionError(f"[27] ACLR {aclr} against {rrc.aclr}")
    worst = 0.0
    paddings = ("full", "same", "valid")
    with torch.no_grad():
        for i, (name, make) in enumerate(PULSE_FILTERS.items()):
            for j, window in enumerate((None, "hann", "hamming",
                                        "blackman")):
                kw = dict(padding=paddings[(i + j) % 3], conjugate=bool(j % 2))
                card_f = make(c, window=window, device=dev)
                cpu_f = make(c, window=window, device="cpu")
                worst = max(worst, check_against_cpu(
                    f"[27] {name}, window {window}, {kw}",
                    card_f(x_up, **kw), cpu_f(x_up.cpu(), **kw),
                    PULSE_CPU_RTOL))
        times = {"upsample": median_ms(lambda: up(x), 10),
                 "RRC (full)": median_ms(lambda: rrc(x_up), 10),
                 "matched RRC (full)": median_ms(
                     lambda: rrc(x_rrc, conjugate=True), 10),
                 "downsample": median_ms(lambda: down(y), 10)}
    print(f"    {len(PULSE_FILTERS)} filter classes x 4 windows against the "
          f"CPU: largest error {worst:.2e} of the largest value (bound "
          f"{PULSE_CPU_RTOL:.0e})")
    print("    ms per call (median of 10, CUDA events): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()) + f" on {card}")


def optical_link(dev, precision, manakov, f, noise_free=False):
    """One span of the optical tutorial (SSFM over 80 km in 200 steps)
    and its EDFA: transparent at noise figure ``f``, or, ``noise_free``,
    g = 1 (no noise anywhere)."""
    c = OPTICAL
    span = SSFM(alpha=c["alpha"], beta_2=-21.67, gamma=1.27,
                length=c["length"], n_ssfm=c["n_ssfm"], sample_duration=1.0,
                t_norm=1e-12, with_manakov=manakov, precision=precision,
                device=dev)
    g = 1.0 if noise_free else float(np.exp(c["alpha"] * c["length"]))
    amp = EDFA(g=g, f=f, dt=1e-12, with_dual_polarization=manakov,
               precision=precision, device=dev)
    return span, amp


def run_spans(x, span, amp):
    for _ in range(OPTICAL["spans"]):
        x = amp(span(x))
    return x


def run_optical(dev, card):
    """Phase 28: the optical tutorial's 10-span link on a [2, 1024]
    waveform, as written and with ``with_manakov=True``: noise-free, the
    card against the CPU in single and double precision; with noise, the
    added power against the analytic ASE power; the adaptive schedule's
    step count on the card and the CPU; ms and launches per span."""
    c = OPTICAL
    gen = torch.Generator(device=dev).manual_seed(FLAT_SEED + 2)
    shape = (2, c["samples"])
    x64 = torch.complex(torch.randn(shape, generator=gen, device=dev,
                                    dtype=torch.float64),
                        torch.randn(shape, generator=gen, device=dev,
                                    dtype=torch.float64)) * (0.5e-3) ** 0.5
    timing = {}
    with torch.no_grad():
        for manakov in (False, True):
            what = "Manakov" if manakov else "as written"
            errs, cpu = {}, torch.device("cpu")
            for precision, x in (("double", x64),
                                 ("single", x64.to(torch.complex64))):
                links = [optical_link(d, precision, manakov, 5.0,
                                      noise_free=True) for d in (dev, cpu)]
                ys = [x.to(d) for d in (dev, cpu)]
                for i in range(c["spans"]):
                    ys = [amp(span(y)) for y, (span, amp) in zip(ys, links)]
                    if i == 0:
                        errs[precision, 1] = check_against_cpu(
                            f"[28] {what}, noise-free, {precision}, one "
                            f"span", *ys, OPTICAL_RTOL[precision])
                errs[precision] = check_against_cpu(
                    f"[28] {what}, noise-free, {precision}, "
                    f"{c['spans']} spans", *ys,
                    OPTICAL_LINK_RTOL[precision])
                if precision == "double":
                    exact = ys[0]
            # single precision's own error: the f32 link against the f64
            f32_err = float((ys[0].to(exact.dtype) - exact).abs().max()
                            / exact.abs().max())
            print(f"    {what}, noise-free, card against CPU: one span "
                  f"{errs['single', 1]:.2e} (single, bound "
                  f"{OPTICAL_RTOL['single']:.0e}), {errs['double', 1]:.2e} "
                  f"(double, {OPTICAL_RTOL['double']:.0e}); {c['spans']} "
                  f"spans {errs['single']:.2e} (single, bound "
                  f"{OPTICAL_LINK_RTOL['single']:.0e}; the f32 link "
                  f"against the f64 link on the card {f32_err:.2e}), "
                  f"{errs['double']:.2e} (double, "
                  f"{OPTICAL_LINK_RTOL['double']:.0e})")
            x = x64.to(torch.complex64)
            span, amp = optical_link(dev, "single", manakov, c["f"])
            clean = optical_link(dev, "single", manakov, 0.0)
            noise = run_spans(x, span, amp) - run_spans(x, *clean)
            power = float((noise.abs() ** 2).mean())
            want = c["spans"] * amp._p_n_ase
            half = 5 * want / noise.numel() ** 0.5
            print(f"    {what}: ASE power at the output {power:.4e} W, "
                  f"analytic {want:.4e} W +- {half:.1e}")
            if not abs(power - want) <= half:
                raise AssertionError(f"[28] {what}: noise power {power}, "
                                     f"analytic {want} +- {half}")
            timing[what] = (span, amp, x)

        # the adaptive schedule on a smooth pulse: the same steps
        t = torch.arange(c["samples"], dtype=torch.float64) - c["samples"] / 2
        pulse = (0.02 ** 0.5 * torch.exp(-t ** 2 / (2 * 12.0 ** 2)))
        pulse = torch.stack([pulse, 0.8 * pulse]).to(torch.complex64)
        steps = []
        for d in (dev, torch.device("cpu")):
            fiber = SSFM(length=OPTICAL_ADAPTIVE["length"], n_ssfm="adaptive",
                         phase_inc=OPTICAL_ADAPTIVE["phase_inc"], device=d)
            out = fiber(pulse.to(d))
            steps.append(fiber.steps)
            if d == dev:
                card_out = out
        err = check_against_cpu("[28] adaptive SSFM", card_out, out,
                                OPTICAL_RTOL["single"])
        print(f"    adaptive SSFM on a 20 mW pulse over "
              f"{OPTICAL_ADAPTIVE['length']} km: {steps[0]} steps on the "
              f"card, {steps[1]} on the CPU (one host read per step), "
              f"output against the CPU {err:.2e}")
        if steps[0] != steps[1]:
            raise AssertionError(f"[28] adaptive steps {steps}")

        # both forms timed before either is profiled: after a profiler
        # window every launch costs more
        ms = {what: (median_ms(lambda: span(x), 5),
                     median_ms(lambda: amp(x), 5))
              for what, (span, amp, x) in timing.items()}
        for what, (span, amp, x) in timing.items():
            dev_n, host_n, busy = launches_per_call(lambda: span(x))
            print(f"    {what}: {ms[what][0]:.3f} ms per span (SSFM, "
                  f"{c['n_ssfm']} steps) + {ms[what][1]:.4f} ms EDFA, median "
                  f"of 5 (CUDA events) on {card}; {dev_n} kernels and copies "
                  f"on the device, {host_n} cudaLaunchKernel per span, "
                  f"{busy:.3f} ms of device time (torch.profiler)")


def flat_phases(card, results, per_update):
    """Phases 26-28, run in a fresh process by ``main``; ``per_update``
    as ``lifted_bound`` takes it."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.seed = FLAT_SEED
    t0 = time.perf_counter()
    print(f"[26] coded MIMO over correlated flat fading (4 x 16, 16-QAM, "
          f"BG2 Z=64) and the BSC link through sim_ber, K1, on {card}")
    run_flat_links(dev, card, per_update)
    print(f"    phase 26: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    print(f"[27] pulse shaping (RRC, up/down-sampling, windows) on {card}")
    run_pulse_shaping(dev, card)
    print(f"    phase 27: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    print(f"[28] the optical link (10 x SSFM + EDFA) on {card}")
    run_optical(dev, card)
    print(f"    phase 28: {time.perf_counter() - t1:.1f} s; phases 26-28: "
          f"{time.perf_counter() - t0:.1f} s")
    sys.stdout.flush()
    results.put({})


def rt_scene(rt, name_or_scene, tx, rx, frequency=3.5e9):
    """A scene of the port's ``rt`` with iso V arrays, one tx and one rx
    (a list of positions gives one rx per position)."""
    scene = rt.load_scene(name_or_scene, frequency=frequency) \
        if isinstance(name_or_scene, str) else name_or_scene
    scene.tx_array = rt.PlanarArray(1, 1, pattern="iso", polarization="V")
    scene.rx_array = rt.PlanarArray(1, 1, pattern="iso", polarization="V")
    scene.add(rt.Transmitter("tx", tx))
    for i, p in enumerate(rx if isinstance(rx[0], list) else [rx]):
        scene.add(rt.Receiver(f"rx{i}", p))
    return scene


def host_synced_median_s(fn, reps=3):
    """bench.py's protocol: one warm-up call, then the median seconds of
    ``reps`` calls, each ending in a host sync."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def peak_gib(fn):
    """Peak device memory [GiB] of one call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def paths_per_depth(paths):
    """Valid paths of the first link per number of interactions."""
    valid = paths.valid[0, 0].cpu()
    depth = (paths.interactions >= 0).sum(dim=1).cpu()
    return [int((valid & (depth == d)).sum())
            for d in range(int(depth.max()) + 1)]


def link_gain(paths):
    return float((paths.a[0, 0, 0, 0].abs() ** 2).sum())


def check_rel(what, got, want, rtol):
    err = abs(got - want) / abs(want)
    if not err <= rtol:
        raise AssertionError(f"{what}: {got} against {want} ({err:.2e} > "
                             f"{rtol:.0e})")
    return err


def host_syncs(fn):
    """Host syncs of one call of ``fn``: the warnings of torch.cuda's sync
    debug mode."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def rt_stage_split(solve):
    """The solver's stages in one call of ``solve``, by the host clock
    with a device sync at each stage boundary (so the call is slower than
    a timed one): ({stage: seconds}, the call's seconds). Stages: setup
    (``PathSolver._setup``: the geometry to the device, the accel cache's
    lookup, the devices' positions), materials (the per-triangle material
    arrays), trace (``geometry.trace``), dedupe (the prefix dedupe around it and the
    duplicate-path pass), image method (images, points, bases and the
    Fresnel cascade: the rest of ``_eval_sequences``), transmission
    (occlusion or the through-blocker products), field
    (``combine_paths``), gain (the gain reduction), other (the rest: the
    radio map's cells, the sequences' host read, concatenation)."""
    import sionna_tpu_torch.rt.geometry as geometry
    import sionna_tpu_torch.rt.solver as solver_mod
    acc = {}

    def wrap(owner, name, key, static=False):
        fn = getattr(owner, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                acc[key] = acc.get(key, 0.) + time.perf_counter() - t0

        setattr(owner, name, staticmethod(timed) if static else timed)
        return owner, name, staticmethod(fn) if static else fn

    saved = [wrap(solver_mod.PathSolver, "_setup", "setup"),
             wrap(solver_mod.PathSolver, "_materials", "materials"),
             wrap(geometry, "trace", "trace"),
             wrap(solver_mod, "trace_unique", "trace_unique"),
             wrap(solver_mod.PathSolver, "_deduplicate", "dedupe_paths",
                  static=True),
             wrap(solver_mod.PathSolver, "_eval_sequences", "eval"),
             wrap(solver_mod, "transmission_jones_product", "transmission"),
             wrap(solver_mod, "transmission_jones_product_accel",
                  "transmission"),
             wrap(solver_mod, "any_blocking_hit", "transmission"),
             wrap(solver_mod, "combine_paths", "field"),
             wrap(solver_mod, "_gain", "gain")]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    stages = {
        "setup": acc.get("setup", 0.),
        "materials": acc.get("materials", 0.),
        "trace": acc.get("trace", 0.),
        "dedupe": acc.get("trace_unique", 0.) - acc.get("trace", 0.)
        + acc.get("dedupe_paths", 0.),
        "image method": acc.get("eval", 0.) - acc.get("transmission", 0.)
        - acc.get("field", 0.) - acc.get("gain", 0.),
        "transmission": acc.get("transmission", 0.),
        "field": acc.get("field", 0.),
        "gain": acc.get("gain", 0.),
    }
    stages["other"] = total - sum(stages.values())
    return stages, total


def print_stage_split(solve):
    stages, total = rt_stage_split(solve)
    print(f"    stages of one solve with a device sync at each boundary "
          f"({total * 1e3:.1f} ms): " + ", ".join(
              f"{k} {v * 1e3:.1f} ms ({100 * v / total:.1f} %)"
              for k, v in stages.items()))


def device_idle_share(solve):
    """(idle share, device seconds, host-clock seconds, kernels and copies)
    of one call of ``solve`` under ``torch.profiler``: the device time
    sums the device-side events' self times (each kernel and copy once)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    return 1. - busy / span, busy, span, sum(e.count for e in events)


def rt_canyon_phase(dev, card):
    """Phase 29: bench.py's canyon path solve on the card."""
    import sionna_tpu_torch.rt as rt
    from sionna_tpu_torch.phy.channel import cir_to_ofdm_channel
    c = RT_CANYON
    scene = rt_scene(rt, "simple_street_canyon", c["tx"], c["rx"])
    solver = rt.PathSolver()
    if solver.device != dev:
        raise AssertionError(f"[29] PathSolver() on {solver.device}")
    kw = dict(max_depth=c["max_depth"], samples_per_src=c["samples"])
    out = {}

    def solve():
        out["paths"] = solver(scene, **kw)
        out["paths"].cir(out_type="numpy")

    t = host_synced_median_s(solve)
    paths = out["paths"]
    on_card("[29] paths", [paths.a, paths.tau, paths.valid, paths.theta_t,
                           paths.doppler, paths.interactions, paths.types],
            dev)
    print(json.dumps({"metric": "rt_path_solver_ray_segments_per_s",
                      "value": c["samples"] * (c["max_depth"] + 1) / t / 1e6,
                      "unit": "Mrays/s", "card": card}))
    print(f"    {t * 1e3:.1f} ms per solve (median of 3, host-synced, "
          f"warm-up excluded), {paths.num_paths} candidate paths, peak "
          f"{peak_gib(solve):.2f} GiB, {host_syncs(solve)} host syncs per "
          f"solve, on {card}")
    print_stage_split(solve)
    per_depth, gain = paths_per_depth(paths), link_gain(paths)
    want = RT_JAX["canyon"]
    err = check_rel("[29] total gain against JAX", gain, want["gain"],
                    RT_GAIN_RTOL)
    print(f"    valid paths per depth {per_depth} (JAX on the CPU "
          f"{want['valid_per_depth']}), total gain {gain:.6e} (JAX "
          f"{want['gain']:.6e}, {err:.1e})")
    if per_depth != want["valid_per_depth"]:
        raise AssertionError("[29] valid paths per depth differ from JAX's")

    # the same solve by the port on the CPU in float64
    cpu = rt.PathSolver(device="cpu")(scene, **kw)

    def valid_set(p):
        inter = p.interactions.cpu().numpy()
        return {tuple(int(i) for i in inter[k] if i >= 0)
                for k in np.nonzero(p.valid[0, 0].cpu().numpy())[0]}

    card_set, cpu_set = valid_set(paths), valid_set(cpu)
    if card_set != cpu_set:
        print(f"    valid sequences only on the card {card_set - cpu_set}, "
              f"only on the CPU {cpu_set - card_set}")
        raise AssertionError("[29] valid sequences differ card/CPU")

    def by_sequence(p):
        inter = p.interactions.cpu().numpy()
        v = p.valid[0, 0].cpu().numpy()
        return {tuple(int(i) for i in inter[k] if i >= 0): k
                for k in np.nonzero(v)[0]}

    kc, kp = by_sequence(paths), by_sequence(cpu)
    seqs = sorted(kc)
    tau_c = paths.tau[0, 0].cpu().double().numpy()[[kc[q] for q in seqs]]
    tau_p = cpu.tau[0, 0].numpy()[[kp[q] for q in seqs]]
    mag_c = paths.a[0, 0, 0, 0].abs().cpu().double().numpy()[
        [kc[q] for q in seqs]]
    mag_p = cpu.a[0, 0, 0, 0].abs().double().numpy()[[kp[q] for q in seqs]]
    tau_err = float(np.max(np.abs(tau_c - tau_p) / tau_p))
    a_err = float(np.max(np.abs(mag_c - mag_p)) / np.max(mag_p))
    print(f"    card (float32 geometry) against the port on the CPU "
          f"(float64): {len(seqs)} valid sequences equal, tau "
          f"{tau_err:.2e} relative, |a| {a_err:.2e} of the largest")
    if not (tau_err <= RT_TAU_RTOL and a_err <= RT_A_RTOL):
        raise AssertionError("[29] card against CPU out of bounds")

    # Paths.cir through the port's cir_to_ofdm_channel, on the card
    a, tau = paths.cir(sampling_frequency=1e4, num_time_steps=14)
    freqs = (torch.arange(-64, 64, device=dev) * 30e3).float()
    h = cir_to_ofdm_channel(freqs, a[None], tau[None].float())
    on_card("[29] CIR -> OFDM", [a, tau, h], dev)
    if h.shape != (1, 1, 1, 1, 1, 14, 128) or not bool(
            torch.isfinite(h).all()):
        raise AssertionError(f"[29] CFR {tuple(h.shape)} or not finite")
    print(f"    Paths.cir -> cir_to_ofdm_channel on the card: "
          f"{tuple(h.shape)}, finite, mean |h|^2 "
          f"{float((h.abs() ** 2).mean()):.3e}")

    # trace_functional's gradient on the card against the CPU
    def grads(device):
        sc = rt_scene(rt, "simple_reflector", [-5., 0., 5.], [5., 1., 5.],
                      frequency=3e9)
        sc.set_material("itu_concrete")
        fn, args = rt.PathSolver(device=device).trace_functional(
            sc, max_depth=1, samples_per_src=5000)
        args = [x.clone().requires_grad_(True) for x in args]
        a_f, _, valid = fn(*args)
        loss = torch.where(valid[:, None, :, None], a_f.abs() ** 2,
                           0.).sum()
        loss.backward()
        return [x.grad for x in args]

    g_card, g_cpu = grads(dev), grads("cpu")
    errs = []
    for g, w in zip(g_card, g_cpu):
        on_card("[29] gradient", [g], dev)
        w = w.to(torch.complex128 if w.is_complex() else torch.float64)
        errs.append(float((g.cpu().to(w.dtype) - w).abs().max()
                          / w.abs().max()))
    print(f"    trace_functional gradients (tx, rx, eta, scat) card "
          f"against CPU: {', '.join(f'{e:.1e}' for e in errs[:3])} of the "
          f"largest (scat's is 0 on both)")
    if not max(errs[:3]) <= RT_GRAD_RTOL:
        raise AssertionError("[29] gradients differ card/CPU")
    return solve


def rt_city_phase(dev, card):
    """Phase 30: bench.py's 100k-triangle city on the card."""
    import sionna_tpu_torch.rt as rt
    import sionna_tpu_torch.rt.accel as accel
    import sionna_tpu_torch.rt.geometry as geometry
    import sionna_tpu_torch.rt.solver as solver_mod
    c = RT_CITY
    city = rt_scene(rt, rt.make_city(c["nx"], c["ny"], subdiv=c["subdiv"]),
                    c["tx"], c["rx"])
    solver = rt.PathSolver()
    kw = dict(max_depth=c["max_depth"], samples_per_src=c["samples"])
    out = {}

    def solve():
        out["paths"] = solver(city, **kw)
        out["paths"].tau.cpu()

    accel.STATS.reset()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    st = accel.STATS
    print(f"    {city.num_triangles} triangles; the first solve {first:.2f} "
          f"s: cluster builder compiled in "
          f"{accel.BVH_BUILDER.build_seconds:.2f} s (g++), "
          f"{st.native_builds} native build(s) in {st.build_s:.3f} s, "
          f"{st.numpy_builds} NumPy build(s)")
    if st.native_builds != 1 or st.numpy_builds != 0:
        raise AssertionError("[30] the native cluster builder did not run")
    t = host_synced_median_s(solve)
    paths = out["paths"]
    on_card("[30] paths", [paths.a, paths.tau, paths.valid], dev)
    print(json.dumps({"metric": "rt_city100k_ray_segments_per_s",
                      "value": c["samples"] * (c["max_depth"] + 1) / t / 1e3,
                      "unit": "krays/s", "card": card}))
    accel.STATS.reset()
    peak = peak_gib(solve)
    st = accel.STATS
    syncs = host_syncs(solve)
    print(f"    {t * 1e3:.1f} ms per solve (median of 3, host-synced), peak "
          f"{peak:.2f} GiB; per solve {st.chunks} accel ray chunks, "
          f"{st.skipped} skipped (no cluster entered), {st.repairs} took the "
          f"dense repair sweep; {syncs} host syncs; valid paths per depth "
          f"{paths_per_depth(paths)}, gain {link_gain(paths):.4e}, on "
          f"{card}")
    print_stage_split(solve)

    # the accelerated queries against the dense sweep, on the card
    acc = accel.build_accel(city.triangles.astype(np.float32), dev)
    tri = torch.as_tensor(city.triangles, dtype=torch.float32, device=dev)
    dirs = torch.as_tensor(geometry.fibonacci_sphere(c["samples"])[
        ::c["samples"] // c["check_rays"]][:c["check_rays"]],
        dtype=torch.float32, device=dev)
    orig = torch.as_tensor(c["tx"], dtype=torch.float32,
                           device=dev).expand_as(dirs)
    t_a, i_a, h_a = accel.nearest_hit_accel(orig, dirs, acc)
    t_d, i_d, h_d = geometry.nearest_hit(orig, dirs, tri)
    same_t = bool(torch.equal(t_a, t_d))
    # ids where the nearest distance belongs to one triangle only
    count = torch.zeros(dirs.shape[0], dtype=torch.int64, device=dev)
    for b in range(0, tri.shape[0], 4096):
        t_c, hit_c = geometry.moller_trumbore(orig, dirs, tri[b:b + 4096])
        count += (torch.where(hit_c, t_c, torch.inf) == t_d[:, None]).sum(1)
    unique = h_d & (count == 1)
    same_id = bool(torch.equal(i_a[unique], i_d[unique]))
    seg = dirs * 60.
    b_a = accel.any_blocking_hit_accel(orig, seg, acc)
    b_d = geometry.any_blocking_hit(orig, seg, tri)
    print(f"    nearest_hit_accel on {dirs.shape[0]} of the solve's rays "
          f"against the dense sweep on the card: {int(h_d.sum())} hits, t "
          f"{'identical' if same_t else 'DIFFERENT'}, ids "
          f"{'equal' if same_id else 'DIFFERENT'} on the {int(unique.sum())} "
          f"with a unique nearest t; any_blocking_hit_accel on 60 m "
          f"segments: {int(b_d.sum())} blocked, verdicts "
          f"{'identical' if torch.equal(b_a, b_d) else 'DIFFERENT'}")
    if not (same_t and same_id and torch.equal(b_a, b_d)
            and torch.equal(h_a, h_d)):
        raise AssertionError("[30] accelerated queries differ from the "
                             "dense sweep")

    # the cut city (accelerated path forced) against the JAX package
    cut = RT_CITY_CUT
    small = rt_scene(rt, rt.make_city(cut["nx"], cut["ny"],
                                      subdiv=cut["subdiv"]),
                     cut["tx"], cut["rx"])
    saved = solver_mod.ACCEL_MIN_TRIS
    solver_mod.ACCEL_MIN_TRIS = 0
    try:
        p = rt.PathSolver()(small, max_depth=cut["max_depth"],
                            samples_per_src=cut["samples"])
    finally:
        solver_mod.ACCEL_MIN_TRIS = saved
    want = RT_JAX["city"]
    err = check_rel("[30] cut city gain against JAX", link_gain(p),
                    want["gain"], RT_GAIN_RTOL)
    print(f"    cut city ({small.num_triangles} triangles, accelerated): "
          f"valid paths per depth {paths_per_depth(p)} (JAX "
          f"{want['valid_per_depth']}), gain {err:.1e} from JAX's")
    if paths_per_depth(p) != want["valid_per_depth"]:
        raise AssertionError("[30] cut city paths differ from JAX's")
    return solve


def rt_map_phase(dev, card):
    """Phase 31: bench.py's radio map on the card."""
    import sionna_tpu_torch.rt as rt
    c = RT_MAP
    scene = rt_scene(rt, "simple_street_canyon", RT_CANYON["tx"],
                     RT_CANYON["rx"])
    rm_solver = rt.RadioMapSolver()
    if rm_solver.device != dev:
        raise AssertionError(f"[31] RadioMapSolver() on {rm_solver.device}")
    kw = dict(cell_size=c["cell_size"], size=c["size"], center=c["center"],
              max_depth=c["max_depth"], samples_per_src=c["samples"])
    out = {}

    def solve():
        out["rm"] = rm_solver(scene, **kw)
        out["rm"].path_gain.cpu()

    t = host_synced_median_s(solve)
    rm = out["rm"]
    on_card("[31] map", [rm.path_gain, rm.rss, rm.sinr], dev)
    cells = c["size"][0] * c["size"][1]
    print(json.dumps({"metric": "rt_radio_map_cells_per_s",
                      "value": cells / t / 1e3, "unit": "kcells/s",
                      "card": card}))
    print(f"    {t * 1e3:.1f} ms per map of {cells} cells (median of 3, "
          f"host-synced), peak {peak_gib(solve):.2f} GiB, "
          f"{host_syncs(solve)} host syncs per map, on {card}")
    print_stage_split(solve)
    pg = rm.path_gain[0].double().cpu().numpy()
    live = pg > 1e-15
    db = 10. * np.log10(pg[live])
    want = RT_JAX["map"]
    print(f"    {int(live.sum())} of {pg.size} cells above 1e-15 (JAX "
          f"{want['live']}), mean {db.mean():.4f} dB (JAX "
          f"{want['mean_db']:.4f}), std {db.std():.4f} dB (JAX "
          f"{want['std_db']:.4f}), largest {pg.max():.6e} (JAX "
          f"{want['max']:.6e})")
    check_rel("[31] largest gain against JAX", float(pg.max()), want["max"],
              RT_GAIN_RTOL)
    ref = np.asarray(want["sample"])
    rel = np.abs(pg.reshape(-1)[::want["sample_stride"]] - ref) / ref
    corner = np.zeros(ref.size, bool)
    corner[want["sample_corner"]] = True
    print(f"    every {want['sample_stride']}th cell against JAX: "
          f"{rel[~corner].max():.2e} relative on {int((~corner).sum())} "
          f"cells; {rel[corner].max():.2e} on the {int(corner.sum())} "
          f"that a corner path reaches (ROADMAP.md 'Not faults')")
    if not rel[~corner].max() <= RT_GAIN_RTOL:
        raise AssertionError("[31] map cells differ from JAX's")
    if not (int(live.sum()) == want["live"]
            and abs(db.mean() - want["mean_db"]) <= RT_MAP_DB_ATOL
            and abs(db.std() - want["std_db"]) <= RT_MAP_DB_ATOL):
        raise AssertionError("[31] map statistics differ from JAX's")

    # a coarse map on the card against the port on the CPU
    coarse = dict(cell_size=(2.5, 2.5), size=(100., 20.), center=(0., 0.),
                  max_depth=2, samples_per_src=20_000)
    g_card = rm_solver(scene, **coarse).path_gain
    g_cpu = rt.RadioMapSolver(device="cpu")(scene, **coarse).path_gain
    on_card("[31] coarse map", [g_card], dev)
    g_card = g_card.double().cpu()
    keep = g_cpu > 1e-15
    err = float(((g_card - g_cpu).abs()[keep] / g_cpu[keep]).max())
    print(f"    coarse map {tuple(g_cpu.shape)} on the card against the CPU "
          f"(float64): {err:.2e} relative on {int(keep.sum())} cells")
    if not err <= RT_GAIN_RTOL:
        raise AssertionError("[31] coarse map differs card/CPU")

    # output="gain" against the paths' reduction, a few receivers
    import sionna_tpu_torch.rt.solver as solver_mod
    few = rt_scene(rt, "simple_street_canyon", RT_CANYON["tx"],
                   [[20., 5., 1.5], [-35., -3., 1.5], [0., 8., 1.5],
                    [45., -7., 1.5]])
    solver = rt.PathSolver()
    gain = solver(few, max_depth=2, samples_per_src=20_000, output="gain")
    paths = solver(few, max_depth=2, samples_per_src=20_000)
    on_card("[31] gain", [gain], dev)
    ref = solver_mod._gain(paths.a)
    err = float(((gain - ref).abs() / ref).max())
    print(f"    output='gain' against the paths' reduction on the card: "
          f"{err:.1e} relative ({gain.shape[0]} receivers)")
    if not err <= RT_GAIN_RTOL:
        raise AssertionError("[31] gain output differs from the paths")
    return solve


def rt_phases(card, results):
    """Phases 29-31, run in a fresh process by ``main``."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"[29] BASELINE config 4: bench.py's canyon path solve (depth 3, "
          f"200,000 rays) on {card}")
    solves = {"canyon": rt_canyon_phase(dev, card)}
    print(f"    phase 29: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    print(f"[30] bench.py's city (make_city(10, 10, subdiv=10), depth 2, "
          f"100,000 rays) on {card}")
    solves["city"] = rt_city_phase(dev, card)
    print(f"    phase 30: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    print(f"[31] bench.py's radio map (200 x 200 cells, depth 2, 100,000 "
          f"rays) on {card}")
    solves["map"] = rt_map_phase(dev, card)
    # torch.profiler last: after a profiler window every launch costs more
    for name, solve in solves.items():
        idle, busy, span, n = device_idle_share(solve)
        print(f"    {name}: device idle {100 * idle:.1f} % of a "
              f"{span * 1e3:.1f} ms call ({busy * 1e3:.1f} ms of device "
              f"time, {n} kernels and copies; torch.profiler) on {card}")
    print(f"    phase 31: {time.perf_counter() - t1:.1f} s; phases 29-31: "
          f"{time.perf_counter() - t0:.1f} s")
    sys.stdout.flush()
    results.put({})


def run_in_process(target, card, timeout, *args):
    """Runs ``target(card, results, *args)`` in a fresh spawned process and
    returns what it put on the queue ``results`` (None if nothing);
    raises unless it ends with 0 within ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=target, args=(card, results, *args))
    proc.start()
    deadline = time.monotonic() + timeout
    out = None
    # drain the queue before joining the process that writes to it
    while out is None and time.monotonic() < deadline:
        try:
            out = results.get(timeout=5)
        except queue.Empty:
            if not proc.is_alive():
                break
    proc.join(timeout=max(deadline - time.monotonic(), 1))
    if proc.is_alive():
        proc.terminate()
        proc.join()
        raise AssertionError(f"{target.__name__} did not end within "
                             f"{timeout} s")
    if proc.exitcode != 0:
        raise AssertionError(f"{target.__name__} failed (exit "
                             f"{proc.exitcode})")
    return out


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    # the port's blocks default to the card: no device given
    default_dev = {BinarySource().device, LDPC5GEncoder(100, 200).device,
                   BinarySource()([4]).device}
    print(f"    blocks built without a device: {sorted(map(str, default_dev))}")
    if default_dev != {dev}:
        raise AssertionError(f"blocks without a device on {default_dev}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        ops_job = pool.submit(sass_ops.function_ops)
        list(pool.map(lambda kern: kern.library(), KERNELS))
        function_ops = ops_job.result()
    ops_per_update = sass_ops.ops_per_update(function_ops)
    print(f"[2] built {', '.join(k.source.name for k in KERNELS)} and the "
          f"SASS probes in {time.perf_counter() - t0:.2f} s")
    for kern in KERNELS:
        for line in ptxas_report(kern):
            print(f"    ptxas {line}")
            # K3 keeps every per-edge value in registers or shared memory
            if kern is LAYERED_BP_KERNEL and local_memory_bytes(line):
                raise AssertionError(f"K3 uses local memory: {line}")
    print(f"    FP32 (instructions, operations) on the executed path of "
          f"{function_ops}; per boxplus edge-lane update {ops_per_update}; "
          f"per min-sum edge-lane update {sass_ops.MINSUM_OPS} (counted "
          f"from the min-sum function, sass_ops.MINSUM_OPS)")

    max_err = {}
    for phase, kern, layered in (("[3]", LIFTED_BP_KERNEL, False),
                                 ("[4]", LAYERED_BP_KERNEL, True)):
        print(f"{phase} {kern.name} variants vs plain torch on the card")
        kern.reset()
        max_err.update(check_kernel_against_plain(dev, layered))
        for name, _, k, variant, _ in VARIANTS:
            if k is kern and not k.variant_launches.get(variant):
                raise AssertionError(f"{phase} did not launch {name}")
        print(f"    all cases identical; max |kernel-plain| "
              f"{max(max_err.values()):.3e} (tolerance 0)")

    print("[5] coded-AWGN link through sim_ber on the card")
    run, dec, seen = make_link(dev)
    reset_launches()
    t0 = time.perf_counter()
    ber, bler = sim_ber(run, [3.0, 4.0], batch_size=LINK["batch"],
                        max_mc_iter=10, early_stop=False, verbose=True)
    torch.cuda.synchronize()
    link_s = time.perf_counter() - t0
    launches = LIFTED_BP_KERNEL.variant_launches.get("f32", 0)
    ber, bler = ber.tolist(), bler.tolist()
    print(f"    BER {ber}, BLER {bler}, {seen['calls']} decoder calls, "
          f"{launches} kernel launches, devices {sorted(seen['devices'])}, "
          f"{link_s:.2f} s")
    check_link_bands(bler, "coded-AWGN link")
    if seen["devices"] != {"cuda"}:
        raise AssertionError(f"link tensors on {seen['devices']}")
    if launches == 0 or launches != seen["calls"]:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{seen['calls']} decoder calls")

    print("[6] flagship link (BP-20 flooding) through sim_ber on the card")
    flood = Flagship(dev, num_iter=20)
    flood_launches = run_flagship(flood, "flooding", [8.0, 5.0])
    if flood_launches != {LIFTED_BP_KERNEL.name: {"f32": flood.calls},
                          LAYERED_BP_KERNEL.name: {}}:
        raise AssertionError(f"{flood_launches} for {flood.calls} "
                             "flooding decoder calls")

    print("[7] flagship link (layered, 10 iterations, lifted engine) "
          "through sim_ber")
    layered = Flagship(dev, num_iter=10, cn_schedule="layered",
                       engine="pallas")
    layered_launches = run_flagship(layered, "layered", [8.0])
    if layered_launches != {LIFTED_BP_KERNEL.name: {},
                            LAYERED_BP_KERNEL.name: {"f32": layered.calls}}:
        raise AssertionError(f"{layered_launches} for {layered.calls} "
                             "layered decoder calls")

    print(f"[8] times on {card} (warm-up excluded)")
    # every kernel variant alone at the flagship's code, batch 2048:
    # BP-20 flooding, layered-10 (the setting docs/PERFORMANCE.md
    # compares), and K1 at the coded-AWGN link's code and batch; each
    # output is first held against its plain version at that shape
    gen = torch.Generator(device=dev).manual_seed(2)
    llr_big = flood.dec.recover_llrs(
        noisy_llrs(flood.enc, FLAGSHIP["batch"], 2.5, gen)[1])
    llr_link = dec.recover_llrs(
        noisy_llrs(dec.encoder, LINK["batch"], 3.0, gen)[1])
    # BG1 at Z=384, the code the kernels' cluster layouts exist for
    bg1 = LDPC5GDecoder(LDPC5GEncoder(8448, 16896, device=dev),
                        cn_update="boxplus", engine="lifted", device=dev)
    llr_bg1 = bg1.recover_llrs(
        noisy_llrs(bg1.encoder, FLAGSHIP["batch"], 2.5, gen)[1])
    # the min-sum variant at the flagship's code and at config 3's
    # (k=3072, n=6144: phase 17's, 2048 codewords and 12 iterations)
    ms_flag = LDPC5GDecoder(flood.enc, cn_update="minsum", engine="lifted",
                            device=dev)
    cfg3 = LDPC5GDecoder(LDPC5GEncoder(3072, 6144, device=dev),
                         cn_update="minsum", num_iter=12, device=dev)
    llr_cfg3 = cfg3.recover_llrs(
        noisy_llrs(cfg3.encoder, FLAGSHIP["batch"], 2.5, gen)[1])
    times, shapes, bounds = {}, {}, {}
    # the first case of each variant fills its kernels-line entry: its
    # main path's shape, the flagship's but for the min-sum variant,
    # whose main path is config 3's (phase 17)
    cases = []
    for name, _, kern, _, _ in VARIANTS:
        it, schedule = ((10, "layered-10") if kern is LAYERED_BP_KERNEL
                        else (20, "BP-20"))
        minsum = name.endswith("minsum")
        if minsum:
            cases.append((name, cfg3.lifted, llr_cfg3, 12,
                          "n=6144 x 2048, BP-12 min-sum"))
        cases.append((name, (ms_flag if minsum else flood.dec).lifted,
                      llr_big, it, f"n=12288 x 2048, {schedule} "
                      + ("min-sum" if minsum else "boxplus")))
    cases += [
        ("ldpc_lifted_bp", dec.lifted, llr_link, 20,
         "n=2048 x 2000, BP-20 boxplus"),
        ("ldpc_layered_bp", dec.lifted, llr_link, 10,
         "n=2048 x 2000, layered-10 boxplus"),
        ("ldpc_lifted_bp", bg1.lifted, llr_bg1, 20,
         "n=16896 x 2048, BP-20 boxplus"),
        ("ldpc_layered_bp", bg1.lifted, llr_bg1, 10,
         "n=16896 x 2048, layered-10 boxplus"),
        ("ldpc_layered_bp_bf16", bg1.lifted, llr_bg1, 10,
         "n=16896 x 2048, layered-10 boxplus")]
    for name, lift, llr, it, shape in cases:
        ker, plain = variant_calls(name, lift)
        err = assert_identical(ker(llr, it), plain(llr, it),
                               f"{name} at {shape}")
        max_err[name] = max(max_err[name], err)
        (k1, k2), (p1, p2) = in_turns(lambda: ker(llr, it),
                                      lambda: plain(llr, it), 10, 2)
        per_update = ((sass_ops.MINSUM_OPS,) * 2 if name.endswith("minsum")
                      else ops_per_update["ratio" if name.endswith("ratio")
                                          else "log1p"])
        bound = lifted_bound(lift, llr.shape[0], it, per_update)
        print(f"    {name}, {shape}: max|kernel-plain| {err:.3e}; "
              f"kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / "
              f"{p2:.3f} ms per call; bound {bound[0]:.3f} ms "
              f"({bound[1]}), {100 * bound[0] / min(k1, k2):.1f} % of it; "
              f"FP32 issue {bound[2]:.3f} ms, "
              f"{100 * bound[2] / min(k1, k2):.1f} %")
        print(f"      {launch_line(name, lift, llr.shape[0])}")
        if name not in times:  # the kernels line: main path's shape
            times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
            shapes[name] = shape
            bounds[name] = bound
    ker_ms, plain_ms = times["ldpc_lifted_bp"]
    print(f"    ldpc_bp_codeword_iterations_per_s: kernel "
          f"{2048 * 20 / ker_ms:.3f} kiter/s, plain "
          f"{2048 * 20 / plain_ms:.3f} kiter/s "
          f"(n=12288, batch 2048, BP-20 boxplus)")

    batch = FLAGSHIP["batch"]
    for name, link in (("flooding BP-20", flood), ("layered-10", layered)):
        ms = cuda_ms(lambda: link(batch, 5.0), 10)
        print(f"    flagship_tdla_mimo_ofdm_info_bit_throughput "
              f"({name}): {batch * link.k / ms / 1e3:.3f} Mbit/s "
              f"({ms:.3f} ms per MC iteration, batch {batch}, Eb/N0 5 dB)")
        stages = link.stage_ms(batch, 5.0, 5)
        tot = sum(stages.values())
        for stage, t in stages.items():
            print(f"      {stage:30s} {t:9.3f} ms  {100 * t / tot:5.1f} %")
        print(f"      {'sum of stages':30s} {tot:9.3f} ms")
    busy, wall = device_busy(flood, batch, 5)
    print(f"    device busy share, flooding flagship (torch.profiler, 5 MC "
          f"iterations after 3): {busy:.3f} ms of CUDA time in {wall:.3f} ms "
          f"of wall time with the profiler on, {100 * busy / wall:.1f} %; "
          f"{busy / 5:.3f} ms of device time per iteration")

    n_iters = 10
    run(LINK["batch"], 4.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        run(LINK["batch"], 4.0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"    coded_awgn_ldpc_mc_info_bit_throughput: "
          f"{n_iters * LINK['batch'] * LINK['k'] / dt / 1e6:.3f} Mbit/s "
          f"(k=1024, n=2048, 16-QAM, BP-20, batch 2000, Eb/N0 4 dB, "
          f"{dt / n_iters * 1e3:.3f} ms per MC iteration)")

    print("[9] decoder-kernel tuning sweep "
          "(python -m sionna_tpu_torch.tools.ldpc_tune --quick)")
    reset_launches()
    sweep = ldpc_tune.sweep(quick=True)
    torch.cuda.synchronize()
    main_launches = {
        name: kern.variant_launches.get(variant, 0)
        for name, _, kern, variant, _ in VARIANTS}
    main_launches.update({"ldpc_lifted_bp": flood_launches[
        LIFTED_BP_KERNEL.name]["f32"], "ldpc_layered_bp": layered_launches[
            LAYERED_BP_KERNEL.name]["f32"]})
    print(f"    launches {main_launches}")
    for name, label, *_ in VARIANTS:
        if label is None:  # no knob of the sweep: phase 17's main path
            continue
        if label not in sweep or not main_launches[name]:
            raise AssertionError(f"the sweep did not launch {name}")
        print(f"    hard-decision flip rate of {label} against f32 on the "
              f"probe LLRs: {sweep[label][4]:.3e}")

    print("[10] generic-code link (n=648 802.11n LDPC, LDPCBPDecoder "
          "boxplus-phi BP-20, segment engine) through sim_ber")
    generic, gseen = make_generic_link(dev)
    reset_launches()
    t0 = time.perf_counter()
    _, gbler = sim_ber(generic, [1.5, 2.0], batch_size=GENERIC["batch"],
                       max_mc_iter=GENERIC["mc_iter"], early_stop=False,
                       verbose=True)
    torch.cuda.synchronize()
    gbler = gbler.tolist()
    print(f"    BLER {gbler}, {gseen['calls']} decoder calls, devices "
          f"{sorted(gseen['devices'])}, {time.perf_counter() - t0:.2f} s")
    for snr, p in zip([1.5, 2.0], gbler):
        lo, hi = bler_band("generic", snr)
        if not lo <= p <= hi:
            raise AssertionError(f"generic-code BLER at {snr} dB {p} "
                                 f"outside [{lo}, {hi}]")
    check_no_kernel("[10]", gseen["devices"])

    print("[11] coded-AWGN link with engine=\"segment\" through sim_ber")
    srun, sdec, sseen = make_link(dev, engine="segment")
    reset_launches()
    _, sbler = sim_ber(srun, [3.0, 4.0], batch_size=LINK["batch"],
                       max_mc_iter=10, early_stop=False, verbose=True)
    torch.cuda.synchronize()
    sbler = sbler.tolist()
    print(f"    BLER {sbler}, {sseen['calls']} decoder calls, devices "
          f"{sorted(sseen['devices'])}")
    check_link_bands(sbler, "segment-engine link")
    check_no_kernel("[11]", sseen["devices"])
    _, llr = noisy_llrs(sdec.encoder, LINK["batch"], 3.0, gen)
    with torch.no_grad():
        (s1, s2), (k1, k2) = in_turns(lambda: sdec(llr), lambda: dec(llr),
                                      10, 10)
    print(f"    decoder call, n=2048 x 2000, BP-20: segment engine "
          f"(boxplus-phi) {s1:.3f} / {s2:.3f} ms, K1 (boxplus) {k1:.3f} / "
          f"{k2:.3f} ms")

    print("[12] weighted BP: 3 SGD steps through the segment engine")
    reset_launches()
    losses = weighted_bp_steps(dev, 3, gen)
    print(f"    losses {losses}")
    check_no_kernel("[12]", {"cuda"})

    print(f"[13] demapper: separable-PAM against table path on {card}")
    demap_paths(dev, gen)

    print(f"[14] flagship receiver variants through sim_ber at 8 dB, BP-20 "
          f"(K1), on {card}")
    run_receivers(dev)

    # phases 15-16 time eager, launch-bound decoders in a process of
    # their own: after a torch.profiler window (phases 8 and 14) every
    # later launch in the process costs more (the SC decoder went from
    # 20.7 to 38.5-41.9 ms per call)
    sys.stdout.flush()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_in_process(fec_phases, card, 600)
    print(f"    phases 15-16 took {time.perf_counter() - t0:.1f} s")
    # phases 17-19 likewise, in a fresh process: they report the
    # launches of K1's min-sum variant on its main path (phase 17)
    t0 = time.perf_counter()
    main_launches.update(run_in_process(mimo_phases, card, 600))
    print(f"    phases 17-19 took {time.perf_counter() - t0:.1f} s")
    # phases 20-22 (BASELINE config 5), likewise
    t0 = time.perf_counter()
    run_in_process(sys_phases, card, 600, ops_per_update["log1p"])
    print(f"    phases 20-22 took {time.perf_counter() - t0:.1f} s")
    # phases 23-25 (the 5G NR PUSCH link), likewise
    t0 = time.perf_counter()
    run_in_process(nr_phases, card, 600, ops_per_update["log1p"])
    print(f"    phases 23-25 took {time.perf_counter() - t0:.1f} s")
    # phases 26-28 (flat fading, pulse shaping, the optical link), likewise
    t0 = time.perf_counter()
    run_in_process(flat_phases, card, 600, ops_per_update["log1p"])
    print(f"    phases 26-28 took {time.perf_counter() - t0:.1f} s")
    # phases 29-31 (BASELINE config 4, the ray tracer), likewise
    t0 = time.perf_counter()
    run_in_process(rt_phases, card, 600)
    print(f"    phases 29-31 took {time.perf_counter() - t0:.1f} s; the "
          f"script {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "sionna_tpu_torch/csrc/" + kern.source.name,
        "replaces": replaces,
        "launches": main_launches[name],
        "max_abs_err": max_err[name],
        "shape": shapes[name],
        "ms": times[name][0],
        "plain_ms": times[name][1],
        "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1],
        "library_ms": None,
    } for name, _, kern, _, replaces in VARIANTS]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
