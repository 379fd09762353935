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
8. holds every kernel variant identical to its plain version at the
   flagship's n=12288 x 2048 (BP-20 flooding, layered-10), K1 and K3
   f32 at the link's n=2048 x 2000, K1 f32 and both K3 variants at
   BG1's n=16896 x 2048 (the cluster layouts), with each launch
   configuration; times each variant's first case (its main path's
   shape) against its plain version (CUDA events, warm-up excluded),
   beside its bound: the kernels line's entries of K1-K4 (``VARIANTS``);
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
    phase-5 bands, no lifted kernel launched;
12. takes three SGD steps of weighted BP (``WeightedBPCallback`` weights
    on the v2c messages of the link's decoder, segment engine, BCE loss)
    with every tensor on the card: finite loss and gradients;
13. holds the demapper's separable-PAM path (the default for Gray QAM)
    against its table path (a ``points`` override) at the flagship's
    shape (batch 2048 x 3072 16-QAM symbols, app and maxlog): the LLRs
    within the bound of ``tests/test_torch_mapping.py``;
14. runs the flagship's receiver variants through ``sim_ber`` at 8 dB,
    BP-20 through K1: LS with linear interpolation and the LMMSE
    equalizer, time-averaged linear and ZF, ``LMMSEInterpolator("t-f")``
    from the TDL-A covariances and LMMSE (batch 256, its memory),
    nearest-neighbour and MF: BLER bands from a JAX run of the same links
    (``tools/flagship_rx_bler.py``), one K1 launch per decoder call,
    every tensor on the card, each estimator against itself on the CPU;
    the first again from a checkpoint (no decoder call, the same BLER)
    and the last with a ``Profiler`` (its spans' counts printed);
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
    the CPU.

Phases 17-19 run in a process of their own: each link through
``sim_ber`` against its band from a JAX run of the same link
(``tools/mimo_ofdm_cdl_bler.py``), every tensor on ``cuda:0``, one K1
launch per decoder call. No kernel is written for them: the JAX
package's CDL, precoders and detectors are XLA code. Phase 17 is the
main path of K1's min-sum variant, whose launches the kernels line
reports.

20. runs BASELINE config 5 as ``bench.bench_sys`` does
    (``sionna_tpu_torch.tools.sys_slots.MulticellSlots``: a hexagonal
    grid of 21 UMi sectors with 4 UTs each, the distance-proxy SINR,
    ``PHYAbstraction``, OLLA's ``step`` at a BLER target of 0.1, 1000
    REs per UT): 50 slots per call, one warm-up call, 3 calls with one
    host read each, every slot under ``torch.cuda``'s sync debug mode
    "error" (a slot that reads the card back fails); the NACK share
    inside its band from ``tools/sys_ref.py --part slots``, the drop
    equal to the JAX package's (its SHA-256);
21. runs the same grid at 10 UTs per sector (210 UTs) with the TR 38.901
    UMi channel (omni arrays, downlink) over 14 symbols x 612
    subcarriers at 30 kHz for 20 slots
    (``sionna_tpu_torch.tools.sys_slots.DownlinkSlots``: CIR -> OFDM,
    pathloss, PF scheduling per sector, fair downlink power control,
    spreading, CBF effective channel and LMMSE post-equalization SINR,
    OLLA, EESM, PHY abstraction): SINR and HARQ in range; the mean and
    standard deviation of the 4,410 links' gain [dB], of the drop's draw
    and of each of 16 repetitions of new LSPs and one channel, inside
    the band of one JAX repetition, and their means over the
    repetitions inside the band of the difference of means
    (``tools/sys_ref.py --part gain``);
22. makes BLER table points on the card with
    ``PHYAbstraction.new_bler_table`` (PUSCH, MCS table 1, MCS 5, 14 and
    20, code blocks of 1000 bits, three SNRs each) through
    ``CodedAWGNChannelNR``, whose decoder is K1: one K1 launch per
    decoder call, each BLER inside its band from ``tools/sys_ref.py
    --part bler`` and printed beside the shipped table's value; then K1
    at each MCS's code (x 2000, BP-20) held identical to its plain
    decode.

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
    launch per ``TBDecoder`` call and two of the "lin" taps' kernel
    (``csrc/lin_interp.cu``) per estimator call; then perfect CSI, the
    time domain (``TimeChannel``, ``OFDMDemodulator``) and the min-sum
    ``TBDecoder`` (BP-12, K2) on one batch at 15 dB: BER 0, one launch
    of the right variant (and none of the taps' kernel without an
    estimator);
25. runs the same settings at 273 PRBs (100 MHz at 30 kHz: a 167,976-bit
    TB in 20 code blocks of BG1 at Z=384, n=15728), batch 64, for 6 MC
    iterations: their TB BLER, one K1 launch, two of the taps' kernel and
    one of the per-RE LMMSE kernel (``csrc/lmmse_per_re.cu``) per
    iteration; K1 alone on the iteration's own decoder input (1,280
    codewords, BP-20) identical to its plain decode.

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
    one K1 launch per decoder call, one launch of the whitened-LMMSE
    kernel per MC iteration of the MIMO link (none in the BSC link's),
    every tensor on ``cuda:0``; ``PerColumnModel``, Rayleigh block fading
    and a ``CIRDataset`` of its draws into ``OFDMChannel`` against
    themselves on the CPU; K1 alone at the links' n=1024 x 16,384 held
    identical to its plain decode;
27. runs the pulse-shaping tutorial (``docs/tutorials/10_pulse_shaping.md``:
    RRC span 32, 4 samples per symbol, beta 0.22, 16-QAM [64, 1024],
    upsampling, shaping, matched filter, downsampling): the symbols back
    within the truncated RRC's ISI floor, the empirical ACLR near the
    filter's, each filter class with and without each window against
    itself on the CPU;
28. runs the optical tutorial's link (``docs/tutorials/09_optical_channel.md``:
    10 spans of ``SSFM(n_ssfm=200, length=80)`` and a transparent
    ``EDFA(f=5)`` on a [2, 1024] waveform), as written and with
    ``with_manakov=True``: noise-free (g = 1, no amplification) the card
    against the CPU after one span and after ten, in single and double
    precision; the ASE power at the output against its analytic value;
    the adaptive schedule's step count on the card and on the CPU.

Phases 26-28 run in a process of their own. No kernel is written for
them: the JAX package's signal and channel blocks are NumPy and XLA
code; phase 26's decoder runs K1.

29. runs BASELINE config 4's canyon path solve as bench.py:334-360 does
    (``simple_street_canyon`` at 3.5 GHz, iso V arrays, tx at [-20, 0,
    10], rx at [20, 5, 1.5], ``PathSolver()`` with no device, depth 3,
    200,000 rays): the valid paths per interaction depth and the total
    gain against the JAX package's on the CPU (``tools/rt_ref.py``); the
    same solve by the port on the CPU in float64: the same valid
    interaction sequences, tau and |a| within bounds; ``Paths.cir``
    through ``cir_to_ofdm_channel`` on the card; ``trace_functional``'s
    gradients on the card against the CPU's;
30. runs bench.py's city (``make_city(10, 10, subdiv=10)``: 100,200
    triangles, so the clustered acceleration structure; tx at [0, 0, 30],
    rx at [0, 32, 1.5], depth 2, 100,000 rays): the accel's ray chunks,
    skips and dense repair sweeps; the native cluster builder's build (it
    fails if the NumPy builder ran); ``nearest_hit_accel`` and
    ``any_blocking_hit_accel`` on 8,192 of the solve's rays against the
    dense sweep on the card (t identical, ids equal where t is unique);
    a cut city (``make_city(3, 3, subdiv=4)``, accelerated) against the
    JAX package's paths on the CPU;
31. runs bench.py's radio map (200 x 200 cells of 1 m at height 1.5 on
    the canyon, depth 2, 100,000 rays, ``RadioMapSolver()``): the map's
    statistics against the JAX package's on the CPU; a coarse map
    on the card against the port on the CPU; ``output="gain"`` against
    the paths' reduction for four receivers.

Phases 29-31 run in a process of their own, every tensor of a solve on
``cuda:0``. No kernel is written for them: the JAX package's ray tracer
is XLA code with no Pallas kernel (``sionna_tpu/rt/``), so the port's is
plain torch.

32. renders at upstream Sionna RT's default ``Scene.render`` resolution,
    655 x 500 (327,500 rays; ``RT_RENDER``'s cameras), phase 29's canyon
    with its tx and rx as markers, the same view under phase 31's 200 x
    200 radio map, phase 30's cut city and bench.py's 100,200-triangle
    city (the natively built clustered structure): the canyon, the
    overlay and the cut city against the JAX
    package's images on the CPU (``tools/rt_render_ref.py``: pixel-class
    counts, channel means, every 997th pixel, those shaded from another
    triangle on a shared edge printed apart); the city's accelerated hits
    against the dense sweep on the card (t and hits identical, ids equal
    where t is unique);
33. loads ``tests/data/mitsuba_fixture/street_canyon.xml`` (triangles and
    materials identical to the procedural canyon's) and solves phase 29's
    canyon on it on the card: identical to the procedural canyon's solve,
    valid paths per depth and gain as JAX's; exports bench.py's city with
    ``export_mitsuba_xml`` to a temporary directory and loads it back
    (the exporter's float32 vertices, rounded to 1e-9 m first), its solve
    against phase 30's: valid paths and interactions identical, tau and
    |a| within phase 29's bounds.

Phases 32-33 run in a process of their own. No kernel is written for
them: the JAX package's renderer and loader hold no Pallas kernel; the
render traces its rays through phase 30's intersection code.

34. runs phase 5's link through ``sim_ber`` over ``torch.distributed``
    ranks, each a spawned process joined by ``init_multihost``: two gloo
    ranks sharing the card (``distribute="multihost"``, 1,000 codewords
    each per iteration) and one NCCL rank (NCCL takes one rank per card;
    ``distribute="all"``, the group's world): the BLER bands of phase 5,
    the counters every rank saw equal to the sums of the ranks' own
    counts, one K1 launch per decoder call on every rank, the 3 dB point
    ended on its summed block-error target at the same iteration on
    every rank (before one rank's own errors would have);
35. runs the port's five examples (``sionna_tpu_torch/examples``) at
    full size on the card, each as ``__main__`` in a fresh process with
    its time limit (``EXAMPLES``): the time each took, its last lines,
    example 01's BER within 5 standard errors of the closed form at every
    point, example 03's BLER at 8 dB inside the JAX band of phase 17's
    link (a check that the example runs the link: its sweep stops at 100
    block errors, 512 codewords, so the band is wide; phase 17 holds the
    link tightly), one launch of K1's min-sum variant per call of
    ``LDPC5GDecoder`` (counted on its ``forward``) in 02 and 03 and no
    kernel launch in the others.
36. the gradient kernels of the lifted decoder (a fresh process,
    ``grad_phases``): K5f and K5b (``csrc/ldpc_lifted_bp_grad.cu``), K5Lf
    and K5Lb (``csrc/ldpc_layered_bp_grad.cu``), built in phase 2 beside
    K1 and K3, whose code and layouts the tape kernels K5f and K5Lf run.
    For the codes of phases 3-4 (n=16896 and n=25344 too: the cluster
    layouts of K1, K3 and the backward kernels) and the three check-node
    rules: K5f's marginals identical to K1's (K5Lf's to K3's) at 0, 1,
    5 and 20 iterations (10 layered); at 0, 1 and 5 its tapes identical to
    the plain tape forward's (``lifted_grad.flooding_tape_forward``,
    ``layered_tape_forward``) and K5b (K5Lb) on that tape against the
    plain reverse on the card, the largest error over the largest
    |gradient| within ``GRAD_REL_TOL``. Then at the link's n=2048 x 2000
    and the flagship's n=12288 x 2048 (BP-20, layered-10, boxplus): the
    same three checks and the tape and backward kernels' layouts; at the
    link, ms per call (CUDA events, warm-up excluded) of the tape and
    backward kernels beside the plain tape forward and reverse (the
    timed backward calls identical to the first) and each kernel's
    bound: the kernels line's four K5 entries (``GRAD_VARIANTS``);
37. trains a 16-QAM constellation through the quick-start link at full
    width (``TRAIN``: ``LDPC5GEncoder(1024, 2048)``, ``Mapper`` with
    ``points=``, ``AWGN``, ``Demapper("app", points=)``,
    ``LDPC5GDecoder(hard_out=False, cn_update="boxplus")``, BCE of the
    info bits against the soft output, ``torch.optim.Adam`` on the
    points): 10 steps at BP-20 on the default engine, then 10 with
    ``cn_schedule="layered", engine="lifted"`` at 10 iterations; the loss
    per step, one launch of the tape and of the backward kernel per step
    and none of K1/K3, finite gradients, and the loss on a fixed
    evaluation batch lower after the steps than before;
38. the linear interpolators' kernel (``csrc/lin_interp.cu``) at the
    273-PRB PUSCH's shape: ptxas's report, the kernel against its plain
    version (``lin_interp_plain``) within a few f32 roundings of the
    taps' magnitudes, ms per call of both in turns and of the dense
    complex64 operator's einsum (the port's path before the kernel;
    ``library_ms``), and the kernel's share of its byte bound: the
    kernels line's ``lin_interp`` entry;
39. the whitened-LMMSE kernel (``csrc/lmmse_whitened.cu``) on one MC
    iteration's own channel uses of phase 26's MIMO link (N = 1,048,576,
    M = 16, K = 4, S = N0 I): ptxas's report, the kernel against its
    plain path (``lmmse_equalizer_plain``, the library calls it
    replaced) over every channel use within ``LMMSE_RTOL`` of the
    largest value, ms per call of both in turns, and the kernel's share
    of its byte bound: the kernels line's ``lmmse_whitened`` entry; then
    the per-RE kernel (``csrc/lmmse_per_re.cu``) likewise on one MC
    iteration's own REs of phase 25's 273-PRB PUSCH (N = 2,935,296, M =
    4, K = 2, an S at each RE, as its detector hands them): the
    ``lmmse_per_re`` entry; then the channel-precoding kernel
    (``csrc/precode_channel.cu``) at the 273-PRB PUSCH's h (64 x 4 x 2 x
    14 x 3,276, TPMI 1) against its plain path (``precode_channel_plain``,
    the cuBLAS product it replaced, also ``library_ms``): the
    ``precode_channel`` entry.

Phases 15 and 16 run in a process of their own; each link is held to
its BLER band from a JAX run of the same link
(``tools/fec_links_bler.py``), with every tensor on the card and no
lifted kernel launched, and its decoder on one batch against the same
decoder on the CPU. No kernel serves them: the JAX package's polar,
convolutional and turbo decoders are XLA code.

Prints the kernels' JSON line (one entry per kernel variant, ``ms`` /
``plain_ms`` / ``bound_ms`` at the entry's ``shape``), the card again,
and last ``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
Run from the repository root: ``python3 chip_smoke.py``.

Each on-card job has one home. This script checks that every path runs
correctly on the card and prints each kernel's time alone (the kernels
line); the benchmark (``BENCHMARK.json``, ``benchmark/``) measures the
port end to end; ``sionna_tpu_torch.tools.kernel_compare`` times a
kernel against its old version; a kernel's own card checks (launch
counts, host syncs, higher-precision references, edge shapes) live in
its ``card``-marked test file (``tests/test_torch_lin_interp_card.py``,
``tests/test_torch_lmmse_card.py``,
``tests/test_torch_lmmse_per_re_card.py``,
``tests/test_torch_precode_card.py``). A later kernel adds a card
test file and one ``kernels`` entry, and no phase; a path whose speed
matters gets a benchmark cell.
"""

import contextlib
import glob
import hashlib
import io
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
from sionna_tpu_torch.phy.fec.ldpc import lifted_grad
from sionna_tpu_torch.phy.fec.ldpc.lifted_grad import (
    LAYERED_BP_GRAD_KERNEL, LIFTED_BP_GRAD_KERNEL)
from sionna_tpu_torch.phy.fec.conv import (BCJRDecoder, ConvEncoder,
                                           ViterbiDecoder)
from sionna_tpu_torch.phy.fec.linear import LinearEncoder
from sionna_tpu_torch.phy.fec.polar import Polar5GDecoder, Polar5GEncoder
from sionna_tpu_torch.phy.fec.turbo import TurboDecoder, TurboEncoder
from sionna_tpu_torch.phy.fec.utils import load_parity_check_examples, pcm2gm
from sionna_tpu_torch.phy.mimo import StreamManagement, lmmse_equalizer
from sionna_tpu_torch.phy.mimo.equalization import (
    LMMSE_PER_RE_KERNEL, LMMSE_WHITENED_KERNEL, lmmse_equalizer_plain,
    lmmse_per_re_cuda, lmmse_whitened_cuda)
from sionna_tpu_torch.phy.ofdm import (EPDetector, KBestDetector,
                                       LinearDetector, LMMSEEqualizer,
                                       LMMSEInterpolator, LSChannelEstimator,
                                       MaximumLikelihoodDetector,
                                       MFEqualizer, MMSEPICDetector,
                                       OFDMDemodulator, OFDMModulator,
                                       ResourceGrid, ResourceGridMapper,
                                       RZFPrecoder, ZFEqualizer,
                                       tdl_freq_cov_mat, tdl_time_cov_mat)
from sionna_tpu_torch.phy.ofdm.channel_estimation import (
    LIN_INTERP_KERNEL, lin_interp_cuda, lin_interp_plain)
from sionna_tpu_torch.phy.nr import (PUSCHConfig, PUSCHLSChannelEstimator,
                                    PUSCHReceiver, PUSCHTransmitter,
                                    TBDecoder, TBEncoder)
from sionna_tpu_torch.phy.nr.pusch_receiver import (
    PRECODE_CHANNEL_KERNEL, precode_channel_cuda, precode_channel_plain)
from sionna_tpu_torch.phy.nr.utils import CodedAWGNChannelNR
from sionna_tpu_torch.phy.signal import (CustomFilter, Downsampling,
                                         RaisedCosineFilter,
                                         RootRaisedCosineFilter, SincFilter,
                                         Upsampling, empirical_aclr)
from sionna_tpu_torch.phy.utils import Profiler, ebnodb2no, sim_ber
from sionna_tpu_torch.sys import PHYAbstraction
from sionna_tpu_torch.tools import ldpc_tune, sass_ops
# phase 36: a backward kernel against the plain reverse on the same tape,
# the largest |error| over the largest |gradient| (two f32 sums of the
# same terms in other orders)
from sionna_tpu_torch.tools.kernel_compare import GRAD_REL_TOL
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
# the gradient kernels (phases 36-37), built in phase 2 with KERNELS
GRAD_KERNELS = (LIFTED_BP_GRAD_KERNEL, LAYERED_BP_GRAD_KERNEL)
_DEC = "sionna_tpu/phy/fec/ldpc/decoding.py"
# Each gradient kernel: (name in the kernels line, label, kernel, variant
# as the wrapper counts it, the TPU code it replaces)
GRAD_VARIANTS = [
    ("ldpc_lifted_bp_grad_tape", "K5f", LIFTED_BP_GRAD_KERNEL, "forward",
     LIFTED_BP_GRAD_KERNEL.replaces),
    ("ldpc_lifted_bp_grad_backward", "K5b", LIFTED_BP_GRAD_KERNEL,
     "backward", LIFTED_BP_GRAD_KERNEL.replaces),
    ("ldpc_layered_bp_grad_tape", "K5Lf", LAYERED_BP_GRAD_KERNEL, "forward",
     LAYERED_BP_GRAD_KERNEL.replaces),
    ("ldpc_layered_bp_grad_backward", "K5Lb", LAYERED_BP_GRAD_KERNEL,
     "backward", LAYERED_BP_GRAD_KERNEL.replaces),
]
# phase 37: the training step (the quick-start link with a trainable
# constellation and the decoder in the loss)
TRAIN = dict(k=1024, n=2048, nbps=4, batch=2000, ebno_db=3.0, steps=10,
             lr=1e-2)
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
# PRBs (100 MHz at 30 kHz), batch 64, 6 MC iterations, at an SNR where
# every TB should decode
NR_DIR = "tests/nr"
# the 12 waveforms tests/test_nr.py holds the JAX package to (all 83
# take about 20 s of host work, the DMRS and CRC tables of each
# configuration; tests/test_torch_pusch.py runs them all on the CPU)
GOLDEN_IDS = (0, 5, 11, 19, 27, 35, 43, 51, 59, 67, 75, 82)
WAVEFORM_ATOL = 1e-5
PUSCH_FC = 3.5e9
PUSCH = dict(n_size_grid=16, ebno_db=3.5, batch=256, mc_iter=40)
PUSCH_CHECK = dict(ebno_db=15.0, batch=16)
PUSCH_FULL = dict(n_size_grid=273, ebno_db=10.0, batch=64, mc_iter=6)
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
# Phase 39: the whitened-LMMSE kernel against its plain path, of the
# largest value (tests/test_torch_lmmse_card.py's FLAT_RTOL, the bound of
# each against complex128: float32 whitening and a 4 x 4 Cholesky solve
# over channels of condition number up to about 20)
LMMSE_RTOL = 4e-5
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


# Phase 32's views at upstream Sionna RT's default Scene.render resolution
# (655 x 500; the renderer's default fov of 45 degrees): phase 29's canyon
# (and the same view under phase 31's radio map), phase 30's cut city and
# bench.py's city, each with its phase's tx and rx as markers; a camera
# (position, look-at point) per scene
RT_RENDER = dict(resolution=(655, 500), sample_stride=997,
                 views={"canyon": ([-60., 0., 30.], [0., 0., 5.]),
                        "city_cut": ([-16., -100., 60.], [-16., 16., 0.]),
                        "city": ([0., -200., 80.], [0., 32., 0.])})
# against JAX's images of the same views on the CPU: each pixel class's
# count (sky, geometry, tx and rx markers, map overlay) within a share of
# the pixels, the per-channel means absolute, every sample_stride-th pixel
# absolute (but where the two hit different triangles on a shared edge)
RT_RENDER_COUNT_SHARE = 0.005
RT_RENDER_MEAN_ATOL = 1e-3
RT_RENDER_PIXEL_ATOL = 1e-4
# PYTHONPATH=. python tools/rt_render_ref.py (the JAX package on the CPU)
RT_RENDER_JAX = {
    "canyon": {
        "mean": [0.4295101045901311, 0.4086268674683935, 0.38246186424191214],
        "counts": {"sky": 23935, "geometry": 301857, "tx": 1341,
                   "rx": 367, "overlay": 0},
        "sample": [
            [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72,
            0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.5806102, 0.5618808, 0.5337868], [0.72,
            0.82, 0.92], [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82,
            0.92], [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92],
            [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.5806102, 0.5618808,
            0.5337868], [0.72, 0.82, 0.92], [0.5806102, 0.5618808, 0.5337868],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.5806102,
            0.5618808, 0.5337868], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.3180028, 0.3077447,
            0.2923574], [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92],
            [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.5806102,
            0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.5806102, 0.5618808,
            0.5337868], [0.72, 0.82, 0.92], [0.5806102, 0.5618808, 0.5337868],
            [0.72, 0.82, 0.92], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.5806102, 0.5618808, 0.5337868],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.5806102,
            0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.5806102, 0.5618808,
            0.5337868], [0.72, 0.82, 0.92], [0.5806102, 0.5618808, 0.5337868],
            [0.72, 0.82, 0.92], [0.5806102, 0.5618808, 0.5337868], [0.72,
            0.82, 0.92], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.5806102, 0.5618808, 0.5337868],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.4214106, 0.3558578,
            0.2809404], [0.5806102, 0.5618808, 0.5337868], [0.4214106,
            0.3558578, 0.2809404], [0.5806102, 0.5618808, 0.5337868],
            [0.4214106, 0.3558578, 0.2809404], [0.5806102, 0.5618808,
            0.5337868], [0.4214106, 0.3558578, 0.2809404], [0.5806102,
            0.5618808, 0.5337868], [0.4214106, 0.3558578, 0.2809404],
            [0.5806102, 0.5618808, 0.5337868], [0.3180028, 0.3077447,
            0.2923574], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.4214106, 0.3558578, 0.2809404], [0.5806102,
            0.5618808, 0.5337868], [0.4214106, 0.3558578, 0.2809404],
            [0.5806102, 0.5618808, 0.5337868], [0.4214106, 0.3558578,
            0.2809404], [0.5806102, 0.5618808, 0.5337868], [0.4214106,
            0.3558578, 0.2809404], [0.5806102, 0.5618808, 0.5337868],
            [0.4214106, 0.3558578, 0.2809404], [0.5806102, 0.5618808,
            0.5337868], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.5806102, 0.5618808,
            0.5337868], [0.4214106, 0.3558578, 0.2809404], [0.5806102,
            0.5618808, 0.5337868], [0.4214106, 0.3558578, 0.2809404],
            [0.5806102, 0.5618808, 0.5337868], [0.4214106, 0.3558578,
            0.2809404], [0.5806102, 0.5618808, 0.5337868], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.5806102, 0.5618808,
            0.5337868], [0.4214106, 0.3558578, 0.2809404], [0.5806102,
            0.5618808, 0.5337868], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.85, 0.15, 0.1], [0.3180028,
            0.3077447, 0.2923574], [0.85, 0.15, 0.1], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.4214106, 0.3558578, 0.2809404]],
        "sample_tri": [
            -1, -1, -1, -1, -1, -1, 2, 13, 3, 13, 3, 13, 3, 13, 3, 13, 4, 13,
            -1, 13, -1, 13, -1, -1, -1, 2, -1, 2, 16, 3, 17, 3, 12, 3, 12, 3,
            12, 4, 12, 5, 13, -1, 13, -1, 13, -1, 2, -1, 2, -1, 3, 16, 3, 17,
            3, 17, 3, 12, 4, 12, 4, 12, 5, 12, -1, 12, -1, 12, -1, 2, -1, 3,
            -1, 3, 16, 3, 17, 3, 17, 4, 17, 4, 12, 5, 12, 5, 12, 0, 12, 0, 12,
            0, 3, 0, 3, 0, 3, 16, 3, 17, 4, 17, 4, 17, 4, 17, 5, 12, 0, 12, 0,
            12, 0, 3, 0, 3, 0, 3, 0, 4, 16, 4, 17, 4, 17, 4, 17, 5, 17, 5, 17,
            0, 12, 0, 12, 0, 3, 0, 3, 0, 4, 0, 4, 16, 4, 17, 4, 17, 4, 17, 5,
            17, 0, 17, 0, 17, 0, 12, 0, 3, 0, 4, 0, 4, 0, 4, 16, 4, 17, 4, 17,
            5, 17, 5, 17, 1, 17, 1, 17, 0, 17, 0, 4, 0, 4, 0, 4, 0, 4, 16, 4,
            16, 4, 17, 5, 17, 1, 17, 1, 17, 1, 17, 1, 17, 0, 4, 0, 4, 0, 4, 0,
            4, 16, 4, 16, 5, 17, 5, 17, 1, 17, 1, 17, 1, 17, 1, 4, 1, 4, 1, 4,
            0, 4, 0, 4, 0, 4, 16, 5, 17, 1, 17, 1, 17, 1, 17, 1, 17, 1, 4, 1,
            4, 1, 4, 1, 4, 1, 4, 0, 5, 16, 1, 17, 1, 17, 1, 17, 1, 17, 1, 17,
            1, 4, 1, 4, 1, 4, 1, 4, 1, 4, 1, 5, 16, 1, 17, 1, 17, 1, 17, 1,
            17, 1, 17, 1, 4, 1, 4, 1, 4, 1, 4, 1, 5, 1, 1, 16, 1, 17, 1, 17,
            1, 17, 1, 17, 1, 17, 1, 4, 1, 4, 1, 4, 1, 4, 1, 5, 1, 1],
    },
    "map": {
        "mean": [0.4922127143826876, 0.49371188331432925, 0.3665843846369563],
        "counts": {"sky": 15939, "geometry": 209256, "tx": 1341,
                   "rx": 247, "overlay": 100717},
        "sample": [
            [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72,
            0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.5806102, 0.5618808, 0.5337868], [0.72,
            0.82, 0.92], [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92],
            [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.72, 0.82,
            0.92], [0.72, 0.82, 0.92], [0.5806102, 0.5618808, 0.5337868],
            [0.72, 0.82, 0.92], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.5806102, 0.5618808, 0.5337868],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.5806102,
            0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.5806102, 0.5618808,
            0.5337868], [0.72, 0.82, 0.92], [0.5806102, 0.5618808, 0.5337868],
            [0.72, 0.82, 0.92], [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82,
            0.92], [0.5806102, 0.5618808, 0.5337868], [0.3180028, 0.3077447,
            0.2923574], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.5806102, 0.5618808, 0.5337868],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.5806102, 0.5618808, 0.5337868],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.4335263, 0.6958593, 0.6332433],
            [0.5806102, 0.5618808, 0.5337868], [0.4775316, 0.7132567,
            0.612264], [0.5806102, 0.5618808, 0.5337868], [0.483704, 0.7156969,
            0.6093214], [0.5806102, 0.5618808, 0.5337868], [0.4977883,
            0.7212651, 0.6026068], [0.5806102, 0.5618808, 0.5337868],
            [0.4590867, 0.7059645, 0.6210575], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.3180028, 0.3077447,
            0.2923574], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.5806102, 0.5618808, 0.5337868],
            [0.4296981, 0.5732124, 0.3615747], [0.5806102, 0.5618808,
            0.5337868], [0.4320081, 0.5741257, 0.3604734], [0.5806102,
            0.5618808, 0.5337868], [0.435651, 0.5755659, 0.3587367],
            [0.5806102, 0.5618808, 0.5337868], [0.4403463, 0.5774222,
            0.3564983], [0.5806102, 0.5618808, 0.5337868], [0.4441328,
            0.5789192, 0.3546931], [0.5806102, 0.5618808, 0.5337868],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.4685085, 0.5885561,
            0.3430721], [0.5806102, 0.5618808, 0.5337868], [0.4667058,
            0.5878434, 0.3439315], [0.5806102, 0.5618808, 0.5337868],
            [0.4681717, 0.588423, 0.3432327], [0.5806102, 0.5618808,
            0.5337868], [0.4732568, 0.5904333, 0.3408084], [0.5806102,
            0.5618808, 0.5337868], [0.4769396, 0.5918893, 0.3390526],
            [0.5806102, 0.5618808, 0.5337868], [0.4809435, 0.5934722,
            0.3371438], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.5048265, 0.6029144, 0.3257577],
            [0.5806102, 0.5618808, 0.5337868], [0.5063527, 0.6035178,
            0.3250301], [0.5806102, 0.5618808, 0.5337868], [0.5093244,
            0.6046926, 0.3236133], [0.5806102, 0.5618808, 0.5337868],
            [0.5131374, 0.6062001, 0.3217955], [0.5806102, 0.5618808,
            0.5337868], [0.5141368, 0.6065952, 0.3213191], [0.3180028,
            0.3077447, 0.2923574], [0.5195974, 0.608754, 0.3187158],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.539454, 0.6166043, 0.3092492], [0.3180028, 0.3077447,
            0.2923574], [0.5422965, 0.6177281, 0.3078941], [0.3180028,
            0.3077447, 0.2923574], [0.5460479, 0.6192112, 0.3061057],
            [0.5806102, 0.5618808, 0.5337868], [0.550657, 0.6210334,
            0.3039083], [0.5806102, 0.5618808, 0.5337868], [0.5508201,
            0.6210979, 0.3038305], [0.3180028, 0.3077447, 0.2923574],
            [0.5564242, 0.6233134, 0.3011588], [0.3180028, 0.3077447,
            0.2923574], [0.5623162, 0.6256429, 0.2983498], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.5837597,
            0.6341205, 0.2881268], [0.3180028, 0.3077447, 0.2923574],
            [0.5895895, 0.6364253, 0.2853474], [0.3180028, 0.3077447,
            0.2923574], [0.5898134, 0.6365138, 0.2852407], [0.3180028,
            0.3077447, 0.2923574], [0.5965527, 0.6391782, 0.2820278],
            [0.3180028, 0.3077447, 0.2923574], [0.6031464, 0.641785,
            0.2788843], [0.3180028, 0.3077447, 0.2923574], [0.6022367,
            0.6414254, 0.2793179], [0.3180028, 0.3077447, 0.2923574],
            [0.6081865, 0.6437777, 0.2764814], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.6195273, 0.6482612, 0.2710747],
            [0.3180028, 0.3077447, 0.2923574], [0.6295894, 0.6522393,
            0.2662777], [0.3180028, 0.3077447, 0.2923574], [0.6410105,
            0.6567546, 0.2608328], [0.3180028, 0.3077447, 0.2923574], [0.85,
            0.15, 0.1], [0.3180028, 0.3077447, 0.2923574], [0.85, 0.15, 0.1],
            [0.3180028, 0.3077447, 0.2923574], [0.6496232, 0.6601596,
            0.2567267], [0.3180028, 0.3077447, 0.2923574], [0.6548312,
            0.6622186, 0.2542439], [0.3180028, 0.3077447, 0.2923574],
            [0.6505861, 0.6605402, 0.2562677], [0.3180028, 0.3077447,
            0.2923574], [0.6175585, 0.644952, 0.2587547], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.6242565, 0.6476, 0.2555614], [0.3180028, 0.3077447,
            0.2923574], [0.6695779, 0.6680486, 0.2472134], [0.3180028,
            0.3077447, 0.2923574], [0.6811596, 0.6726274, 0.2416919],
            [0.3180028, 0.3077447, 0.2923574], [0.6873533, 0.6750761,
            0.2387391], [0.3180028, 0.3077447, 0.2923574], [0.7029042,
            0.6812242, 0.2313253], [0.3180028, 0.3077447, 0.2923574],
            [0.7019631, 0.6808521, 0.2317739], [0.3180028, 0.3077447,
            0.2923574], [0.707764, 0.6831455, 0.2290084], [0.3180028,
            0.3077447, 0.2923574], [0.6994636, 0.6798639, 0.2329656],
            [0.3180028, 0.3077447, 0.2923574], [0.6895363, 0.6759392,
            0.2376984], [0.3180028, 0.3077447, 0.2923574], [0.685964,
            0.6745269, 0.2394015], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.6968656,
            0.6788368, 0.2342042], [0.3180028, 0.3077447, 0.2923574],
            [0.7112782, 0.6845348, 0.227333], [0.3180028, 0.3077447,
            0.2923574], [0.7349787, 0.6939048, 0.216034], [0.3180028,
            0.3077447, 0.2923574], [0.7428306, 0.697009, 0.2122906],
            [0.3180028, 0.3077447, 0.2923574], [0.758135, 0.7030596,
            0.2049944], [0.3180028, 0.3077447, 0.2923574], [0.7563315,
            0.7023466, 0.2058541], [0.3180028, 0.3077447, 0.2923574],
            [0.7478298, 0.6989855, 0.2099073], [0.3180028, 0.3077447,
            0.2923574], [0.741748, 0.696581, 0.2128067], [0.3180028, 0.3077447,
            0.2923574], [0.724159, 0.6896272, 0.2211922], [0.3180028,
            0.3077447, 0.2923574], [0.7059755, 0.6824384, 0.2298611],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.7094759, 0.6838223, 0.2281923], [0.3180028,
            0.3077447, 0.2923574], [0.7291481, 0.6915997, 0.2188137],
            [0.3180028, 0.3077447, 0.2923574], [0.7531356, 0.7010831,
            0.2073778], [0.3180028, 0.3077447, 0.2923574], [0.7701379,
            0.7078049, 0.199272], [0.3180028, 0.3077447, 0.2923574],
            [0.7811214, 0.7121472, 0.1940357], [0.3180028, 0.3077447,
            0.2923574], [0.7884244, 0.7150345, 0.190554], [0.3180028,
            0.3077447, 0.2923574], [0.7859405, 0.7140524, 0.1917382],
            [0.3180028, 0.3077447, 0.2923574], [0.774412, 0.7094947,
            0.1972343], [0.3180028, 0.3077447, 0.2923574], [0.7584728,
            0.7031931, 0.2048333], [0.3180028, 0.3077447, 0.2923574],
            [0.7372078, 0.6947861, 0.2149713], [0.3180028, 0.3077447,
            0.2923574], [0.7344366, 0.6936905, 0.2162924], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.7344813, 0.6937081, 0.2162711], [0.3180028, 0.3077447,
            0.2923574], [0.7480615, 0.699077, 0.2097968], [0.3180028,
            0.3077447, 0.2923574], [0.7681232, 0.7070084, 0.2002325],
            [0.3180028, 0.3077447, 0.2923574], [0.774412, 0.7094947,
            0.1972343], [0.3180028, 0.3077447, 0.2923574], [0.7859405,
            0.7140524, 0.1917382], [0.3180028, 0.3077447, 0.2923574],
            [0.7900937, 0.7156944, 0.1897582], [0.3180028, 0.3077447,
            0.2923574], [0.7765727, 0.7103489, 0.1962043], [0.3180028,
            0.3077447, 0.2923574], [0.7701379, 0.7078049, 0.199272],
            [0.3180028, 0.3077447, 0.2923574], [0.7531356, 0.7010831,
            0.2073778], [0.3180028, 0.3077447, 0.2923574], [0.7433288,
            0.697206, 0.2120531], [0.3180028, 0.3077447, 0.2923574],
            [0.7204468, 0.6881596, 0.222962], [0.7094759, 0.6838223,
            0.2281923], [0.3180028, 0.3077447, 0.2923574], [0.7291481,
            0.6915997, 0.2188137], [0.3180028, 0.3077447, 0.2923574],
            [0.748085, 0.6990864, 0.2097856], [0.3180028, 0.3077447,
            0.2923574], [0.749639, 0.6997007, 0.2090447], [0.3180028,
            0.3077447, 0.2923574], [0.7620313, 0.7046, 0.2031368], [0.3180028,
            0.3077447, 0.2923574], [0.7679123, 0.706925, 0.2003331],
            [0.3180028, 0.3077447, 0.2923574], [0.7679123, 0.706925,
            0.2003331], [0.3180028, 0.3077447, 0.2923574], [0.752831,
            0.7009627, 0.207523], [0.3180028, 0.3077447, 0.2923574],
            [0.7478298, 0.6989855, 0.2099073], [0.3180028, 0.3077447,
            0.2923574], [0.734387, 0.6936709, 0.2163161], [0.3180028,
            0.3077447, 0.2923574], [0.726529, 0.6905642, 0.2200623],
            [0.6655906, 0.6639414, 0.2358556], [0.7032458, 0.6813592,
            0.2311625], [0.7032458, 0.6813592, 0.2311625]],
        "sample_cell": [
            -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
            -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
            -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
            30398, 16797, 28994, 15593, 27791, 14590, 26388, 13587, 25385,
            12784, 24183, 11782, 22980, 10979, 21977, 9977, 20975, 9174, 19972,
            30371, 18970, 29369, 17968, 28166, 17166, 27164, 16163, 26162,
            15361, 25160, 14559, 24158, 13757, 23156, 12956, 22354, 12154,
            21553, 11552, 20551, 10750, 19749, 28548, 18947, 27746, 18146,
            26745, 17344, 25943, 16743, 24942, 15941, 24140, 15140, 23339,
            14538, 22537, 13937, 21936, 13136, 21135, 12534, 20334, 28133,
            19732, 27331, 18931, 26530, 18330, 25729, 17529, 24928, 16927,
            24127, 16326, 23526, 15725, 22725, 15124, 22124, 14523, 21522,
            13922, 20721, 13321, 20120, 26920, 19519, 26319, 18919, 25518,
            18318, 24917, 17717, 24316, 17116, 23515, 16515, 22914, 16114,
            22314, 15513, 21713, 14912, 21112, 14512, 20511, 13911, 20110,
            26110, 19510, 25509, 18909, 24908, 18308, 24308, 17907, 23707,
            17307, 23106, 16906, 22505, 16305, 22105, 15905, 21504, 15304,
            20903, 14903, 20503, 14503, 19902, 25302, 19501, 24701, 18901,
            24300, 18500, 23700, 17900, 23299, 17499, 22699, 17099, 22298,
            16498, 21698, 16097, 21297, 15697, 20696, 15296, 20296, 14896,
            19895, 24695, 19295, 24295, 18894, 23694, 18494, 23294, 18093,
            22893, 17693, 22293, 17092, 21892, 16692, 21492, 16291, 21091,
            15891, 20691, 15491, 20090, 24690, 19690, 24290, 19289, 23889,
            18889, 23289, 18489, 22888, 18088, 22488, 17688, 22087, 17287,
            21687, 16887, 21287, 16487, 20886, 16086, 20486, 15886, 20085,
            24285, 19685, 23885, 19285, 23484, 18884, 23084, 18484, 22684,
            18084, 22283, 17883, 21883, 17483, 21483, 17083, 21082, 16682,
            20682, 16282, 20282, 16082, 20081, 23881, 19681, 23481, 19281,
            23080, 18880, 22680, 18480, 22480, 18280, 22080, 17879, 21679,
            17479, 21279, 17279, 20879, 16879, 20678, 16478, 20278, 16278,
            19878, 23478, 19477, 23277, 19277, 22877, 18877, 22477, 18677,
            22076, 18276, 21876, 17876, 21476, 17676, 21076, 17276, 20875,
            17075, 20475, 16675, 20075, 16475, 19875, 23274, 19474, 22874,
            19274, 22674, 18874, 22274, 18674, 21874, 18273, 21673],
        "sample_cell_gain": [
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            7.74855267e-12, 5.53093704e-09, 1.29661984e-11, 2.04747108e-09,
            2.90166141e-10, 3.87699123e-10, 3.48057166e-10, 3.38975265e-10,
            4.00291938e-10, 1.47053151e-11, 2.33336106e-09, 1.62055733e-11,
            2.76914669e-09, 1.09483828e-11, 8.04129829e-09, 1.09662565e-11,
            1.24354962e-08, 1.20000216e-11, 1.3219652e-08, 1.24915234e-11,
            1.51991433e-08, 1.3701644e-11, 1.03586348e-08, 1.62936487e-11,
            3.54521235e-09, 2.65313344e-11, 5.00571862e-10, 2.61023633e-11,
            2.3342054e-11, 5.05399576e-11, 2.68033443e-11, 2.54641759e-11,
            3.0060749e-11, 2.10529962e-11, 1.72611508e-11, 4.29461533e-09,
            2.07432526e-11, 2.1802304e-08, 2.38472055e-11, 2.23069918e-08,
            2.55651299e-11, 2.31267467e-08, 2.74772132e-11, 2.42279175e-08,
            2.72442936e-11, 2.51540619e-08, 2.481906e-11, 3.6603881e-10,
            5.30911204e-10, 3.84806437e-10, 5.02349051e-10, 4.70936512e-10,
            4.88304508e-10, 5.38736611e-10, 4.44885184e-10, 6.10292483e-10,
            4.07035378e-10, 3.20415985e-11, 3.20247935e-08, 5.94801222e-11,
            3.14579509e-08, 5.37303466e-11, 3.1918173e-08, 4.70619863e-11,
            3.35672858e-08, 4.85539317e-11, 3.4814672e-08, 4.71147045e-11,
            3.62233656e-08, 8.61679728e-10, 5.6631827e-10, 8.57075355e-10,
            7.08323844e-10, 8.28810409e-10, 8.23151047e-10, 7.98090927e-10,
            9.29060773e-10, 7.16833259e-10, 1.02006636e-09, 6.44563458e-10,
            1.09228027e-09, 4.58931808e-08, 6.79308554e-11, 4.65923335e-08,
            7.45646045e-11, 4.79844466e-08, 9.09364528e-11, 4.98317299e-08,
            8.09640965e-11, 5.03276105e-08, 1.35947553e-09, 5.31252056e-08,
            1.41915324e-09, 1.04401487e-09, 1.46250978e-09, 1.26716426e-09,
            1.44564083e-09, 1.44564083e-09, 1.42635093e-09, 1.59706992e-09,
            1.36399836e-09, 1.7368218e-09, 6.46748575e-08, 1.82213722e-09,
            6.65220199e-08, 1.79304349e-09, 6.90408726e-08, 1.25115654e-10,
            7.22665661e-08, 1.32384978e-10, 7.23834219e-08, 2.06777373e-09,
            7.6515775e-08, 2.26668018e-09, 8.11150755e-08, 2.32281461e-09,
            1.93514849e-09, 2.47682563e-09, 2.24888996e-09, 2.5745448e-09,
            2.5745448e-09, 2.56129584e-09, 2.85029444e-09, 2.30908737e-09,
            2.82424462e-09, 1.00314637e-07, 2.8773488e-09, 1.06279074e-07,
            2.90557556e-09, 1.06515174e-07, 2.7553626e-09, 1.13869646e-07,
            2.97507219e-09, 1.21556354e-07, 3.4177341e-09, 1.20465828e-07,
            3.83484844e-09, 1.2778014e-07, 4.10719903e-09, 3.80473608e-09,
            4.58168836e-09, 4.54114479e-09, 4.61098804e-09, 4.64273642e-09,
            1.04527977e-08, 4.8837574e-09, 1.42974145e-07, 4.97291008e-09,
            1.57961395e-07, 4.62894834e-09, 1.76885081e-07, 4.52094318e-09,
            1.79782063e-07, 4.1416226e-09, 1.97282148e-07, 4.76916151e-09,
            1.92640414e-07, 5.22952082e-09, 2.02840909e-07, 6.3965353e-09,
            1.94486816e-07, 6.95676627e-09, 2.00682081e-07, 8.19600032e-09,
            2.0214916e-08, 2.0214916e-08, 9.00109676e-09, 2.14450523e-07,
            8.18269985e-09, 2.34748995e-07, 7.87176901e-09, 2.63290758e-07,
            6.97292579e-09, 2.79952815e-07, 6.17560625e-09, 3.26582523e-07,
            6.08024742e-09, 3.23551973e-07, 6.90703139e-09, 3.42691436e-07,
            8.32584668e-09, 3.1563826e-07, 1.02696234e-08, 2.86073202e-07,
            1.27928033e-08, 2.76125689e-07, 1.46458143e-08, 3.6083442e-08,
            1.84206481e-08, 1.49373403e-08, 3.07617455e-07, 1.27285738e-08,
            3.54832338e-07, 1.0819015e-08, 4.48741645e-07, 9.64417524e-09,
            4.85042904e-07, 8.88999629e-09, 5.64453501e-07, 8.48834514e-09,
            5.5445787e-07, 1.00326547e-08, 5.09670258e-07, 1.24735138e-08,
            4.79867936e-07, 1.51498458e-08, 4.03128638e-07, 1.85499456e-08,
            3.36673168e-07, 5.3803312e-08, 2.72561458e-08, 3.48552902e-07,
            2.18392362e-08, 4.23554837e-07, 1.75964416e-08, 5.37177755e-07,
            1.46746517e-08, 6.35727872e-07, 1.19924204e-08, 7.08808045e-07,
            1.08989653e-08, 7.6199359e-07, 1.10563949e-08, 7.43470991e-07,
            1.34774512e-08, 6.6322616e-07, 1.68716241e-08, 5.66345648e-07,
            2.12838369e-08, 4.58762116e-07, 2.4051559e-08, 4.4633839e-07,
            3.10449479e-08, 3.10449479e-08, 4.46535864e-07, 2.4051559e-08,
            5.10840948e-07, 2.12838369e-08, 6.23165647e-07, 1.68716241e-08,
            6.6322616e-07, 1.34774512e-08, 7.43470991e-07, 1.21840689e-08,
            7.7469889e-07, 1.34774512e-08, 6.77575883e-07, 1.46746517e-08,
            6.35727872e-07, 1.82503364e-08, 5.37177698e-07, 2.28981634e-08,
            4.87442435e-07, 2.72448037e-08, 3.88572232e-07, 3.48552902e-07,
            2.72448037e-08, 4.23554837e-07, 5.3803312e-08, 5.10960547e-07,
            1.95649932e-08, 5.1888793e-07, 1.678643e-08, 5.86667795e-07,
            1.37300029e-08, 6.21865013e-07, 1.24735138e-08, 6.21865013e-07,
            1.31187488e-08, 5.35559138e-07, 1.58619748e-08, 5.09670258e-07,
            1.74047798e-08, 4.46118833e-07, 4.72779256e-08, 4.12706015e-07,
            3.22976462e-07, 3.27689719e-07, 3.27689719e-07],
    },
    "city_cut": {
        "mean": [0.5205085717933096, 0.5321253763100573, 0.5386381518252933],
        "counts": {"sky": 99866, "geometry": 227075, "tx": 382,
                   "rx": 177, "overlay": 0},
        "sample": [
            [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72,
            0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82,
            0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92],
            [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72,
            0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82,
            0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92],
            [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72,
            0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82,
            0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92],
            [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72,
            0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82,
            0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92],
            [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72,
            0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82,
            0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92],
            [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72,
            0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82,
            0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92],
            [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92],
            [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.72,
            0.82, 0.92], [0.358404, 0.3468425, 0.3295004], [0.72, 0.82, 0.92],
            [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.5806102,
            0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.5806102, 0.5618808,
            0.5337868], [0.72, 0.82, 0.92], [0.5806102, 0.5618808, 0.5337868],
            [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.5806102, 0.5618808,
            0.5337868], [0.358404, 0.3468425, 0.3295004], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.72, 0.82, 0.92], [0.3180028, 0.3077447,
            0.2923574], [0.72, 0.82, 0.92], [0.72, 0.82, 0.92], [0.3180028,
            0.3077447, 0.2923574], [0.72, 0.82, 0.92], [0.3180028, 0.3077447,
            0.2923574], [0.72, 0.82, 0.92], [0.3180028, 0.3077447, 0.2923574],
            [0.72, 0.82, 0.92], [0.3180028, 0.3077447, 0.2923574], [0.72,
            0.82, 0.92], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.5806102, 0.5618808,
            0.5337868], [0.358404, 0.3468425, 0.3295004], [0.5806102,
            0.5618808, 0.5337868], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.358404, 0.3468425, 0.3295004], [0.5806102,
            0.5618808, 0.5337868], [0.4214106, 0.3558578, 0.2809404], [0.72,
            0.82, 0.92], [0.4214106, 0.3558578, 0.2809404], [0.72, 0.82,
            0.92], [0.3180028, 0.3077447, 0.2923574], [0.72, 0.82, 0.92],
            [0.3180028, 0.3077447, 0.2923574], [0.72, 0.82, 0.92], [0.3180028,
            0.3077447, 0.2923574], [0.72, 0.82, 0.92], [0.3180028, 0.3077447,
            0.2923574], [0.5806102, 0.5618808, 0.5337868], [0.4214106,
            0.3558578, 0.2809404], [0.5806102, 0.5618808, 0.5337868],
            [0.4214106, 0.3558578, 0.2809404], [0.5806102, 0.5618808,
            0.5337868], [0.358404, 0.3468425, 0.3295004], [0.5806102,
            0.5618808, 0.5337868], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.358404, 0.3468425,
            0.3295004], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.4214106, 0.3558578, 0.2809404], [0.72,
            0.82, 0.92], [0.4214106, 0.3558578, 0.2809404], [0.72, 0.82,
            0.92], [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92],
            [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82, 0.92], [0.5806102,
            0.5618808, 0.5337868], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.3180028, 0.3077447,
            0.2923574], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.358404,
            0.3468425, 0.3295004], [0.3180028, 0.3077447, 0.2923574],
            [0.358404, 0.3468425, 0.3295004], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.1, 0.7, 0.2],
            [0.72, 0.82, 0.92], [0.4214106, 0.3558578, 0.2809404], [0.72,
            0.82, 0.92], [0.5806102, 0.5618808, 0.5337868], [0.72, 0.82,
            0.92], [0.5806102, 0.5618808, 0.5337868], [0.4214106, 0.3558578,
            0.2809404], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.5806102, 0.5618808, 0.5337868],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.3180028, 0.3077447, 0.2923574],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.358404, 0.3468425, 0.3295004], [0.3180028,
            0.3077447, 0.2923574], [0.358404, 0.3468425, 0.3295004],
            [0.4214106, 0.3558578, 0.2809404], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.72, 0.82, 0.92],
            [0.4214106, 0.3558578, 0.2809404], [0.72, 0.82, 0.92], [0.3180028,
            0.3077447, 0.2923574], [0.72, 0.82, 0.92], [0.3180028, 0.3077447,
            0.2923574], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.5806102, 0.5618808, 0.5337868],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.4214106, 0.3558578, 0.2809404],
            [0.5806102, 0.5618808, 0.5337868], [0.4214106, 0.3558578,
            0.2809404], [0.5806102, 0.5618808, 0.5337868], [0.358404,
            0.3468425, 0.3295004], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.4214106,
            0.3558578, 0.2809404], [0.72, 0.82, 0.92], [0.4214106, 0.3558578,
            0.2809404], [0.72, 0.82, 0.92], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.4214106, 0.3558578,
            0.2809404], [0.5806102, 0.5618808, 0.5337868], [0.4214106,
            0.3558578, 0.2809404], [0.4214106, 0.3558578, 0.2809404],
            [0.4214106, 0.3558578, 0.2809404], [0.4214106, 0.3558578,
            0.2809404], [0.72, 0.82, 0.92], [0.4214106, 0.3558578, 0.2809404],
            [0.72, 0.82, 0.92], [0.4214106, 0.3558578, 0.2809404], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.5806102, 0.5618808, 0.5337868], [0.5806102,
            0.5618808, 0.5337868], [0.5806102, 0.5618808, 0.5337868],
            [0.5806102, 0.5618808, 0.5337868], [0.5806102, 0.5618808,
            0.5337868], [0.358404, 0.3468425, 0.3295004], [0.4214106,
            0.3558578, 0.2809404], [0.4214106, 0.3558578, 0.2809404],
            [0.4214106, 0.3558578, 0.2809404], [0.4214106, 0.3558578,
            0.2809404], [0.72, 0.82, 0.92], [0.4214106, 0.3558578, 0.2809404],
            [0.4214106, 0.3558578, 0.2809404], [0.358404, 0.3468425,
            0.3295004], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.3180028, 0.3077447,
            0.2923574], [0.5806102, 0.5618808, 0.5337868], [0.3180028,
            0.3077447, 0.2923574], [0.5806102, 0.5618808, 0.5337868],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.5806102,
            0.5618808, 0.5337868], [0.3180028, 0.3077447, 0.2923574],
            [0.5806102, 0.5618808, 0.5337868], [0.358404, 0.3468425,
            0.3295004], [0.4214106, 0.3558578, 0.2809404], [0.4214106,
            0.3558578, 0.2809404], [0.4214106, 0.3558578, 0.2809404],
            [0.4214106, 0.3558578, 0.2809404], [0.4214106, 0.3558578,
            0.2809404], [0.4214106, 0.3558578, 0.2809404], [0.4214106,
            0.3558578, 0.2809404], [0.358404, 0.3468425, 0.3295004],
            [0.3180028, 0.3077447, 0.2923574], [0.5806102, 0.5618808,
            0.5337868], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.4214106, 0.3558578, 0.2809404],
            [0.4214106, 0.3558578, 0.2809404], [0.4214106, 0.3558578,
            0.2809404], [0.4214106, 0.3558578, 0.2809404], [0.4214106,
            0.3558578, 0.2809404], [0.4214106, 0.3558578, 0.2809404],
            [0.4214106, 0.3558578, 0.2809404], [0.4214106, 0.3558578,
            0.2809404], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.4214106, 0.3558578, 0.2809404], [0.4214106,
            0.3558578, 0.2809404], [0.4214106, 0.3558578, 0.2809404],
            [0.4214106, 0.3558578, 0.2809404], [0.4214106, 0.3558578,
            0.2809404], [0.4214106, 0.3558578, 0.2809404], [0.4214106,
            0.3558578, 0.2809404], [0.4214106, 0.3558578, 0.2809404],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574], [0.3180028,
            0.3077447, 0.2923574], [0.3180028, 0.3077447, 0.2923574],
            [0.3180028, 0.3077447, 0.2923574], [0.3180028, 0.3077447,
            0.2923574], [0.3180028, 0.3077447, 0.2923574]],
        "sample_tri": [
            -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
            -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
            -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
            -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 1335,
            383, 1323, -1, 1327, -1, -1, 943, -1, 833, -1, 837, -1, 841, -1,
            844, -1, -1, 368, 1419, 356, 1328, 360, 1312, 415, 1351, -1, 1355,
            -1, -1, 883, -1, 887, -1, 871, -1, 875, -1, 879, 195, -1, 199,
            1434, 203, 1362, 222, 1171, 351, 1170, 23, -1, 23, -1, 866, -1,
            870, -1, 889, -1, 893, 193, 11, 212, 11, 216, 1428, 200, 1345,
            204, 1277, 397, 1168, 7, -1, 7, -1, 690, -1, 694, -1, 678, 243,
            682, 227, 701, 231, 26, 251, 1360, 235, 1255, 239, 1257, 22, 1187,
            22, -1, 22, -1, 688, -1, 692, 18, 676, 242, 680, 226, 735, 230,
            10, 234, 10, 254, 1270, 238, 1272, 22, 1186, 6, -1, 6, -1, 722,
            -1, 726, 51, 710, 55, 714, 39, 718, 43, 10, 58, 10, 62, 1265, 237,
            1185, 21, 1204, 21, -1, 21, -1, 531, 34, 535, 34, 519, 53, 539,
            57, 523, 57, 527, 61, 25, 45, 9, 21, 9, 21, -1, 21, -1, 5, 33,
            514, 48, 534, 52, 518, 36, 522, 56, 537, 40, 541, 44, 525, 179, 9,
            21, 9, 5, -1, 5, 17, 615, 83, 513, 67, 513, 87, 532, 91, 536, 91,
            536, 95, 540, 79, 524, 181, 9, 5, 9, 5, 1, 5, 1, 617, 82, 512, 66,
            563, 86, 567, 90, 571, 90, 555, 94, 575, 78, 559, 20, 24, 20, 24,
            20, 16, 20, 16, 562, 81, 562, 65, 566, 85, 550, 89, 554, 73, 554,
            93, 558, 77, 557, 20, 24, 20, 8, 20, 16, 20, 16, 561, 80, 545, 64,
            564, 84, 548, 88],
    },
}
# the map view's rays hit the canyon's triangles
RT_RENDER_JAX["map"]["sample_tri"] = RT_RENDER_JAX["canyon"]["sample_tri"]
# phase 33: the Mitsuba bundle of the canyon committed for the loader tests
MITSUBA_FIXTURE = "tests/data/mitsuba_fixture/street_canyon.xml"
# phase 34: phase 5's link over torch.distributed ranks on the card (the
# summed block errors end the 3 dB point before one rank's own would)
DIST_LINK = dict(max_mc_iter=10, target_block_errors=2000)
# phase 35: the port's examples at full size, each with its time limit [s]
EXAMPLES = {"01_uncoded_awgn_ber.py": 180, "02_coded_bler_ldpc_polar.py": 240,
            "03_mimo_ofdm_cdl.py": 240, "04_rt_coverage_map.py": 180,
            "05_sys_multicell.py": 120}


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
    for kern in KERNELS + (LIN_INTERP_KERNEL, LMMSE_WHITENED_KERNEL,
                           LMMSE_PER_RE_KERNEL):
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
    _, bler = sim_ber(link, snrs, batch_size=FLAGSHIP["batch"],
                      max_mc_iter=FLAGSHIP["mc_iter"], early_stop=False,
                      verbose=True)
    torch.cuda.synchronize()
    launches = {kern.name: dict(kern.variant_launches) for kern in KERNELS}
    bler = bler.tolist()
    print(f"    {schedule}: BLER {bler}, {link.calls} decoder calls, "
          f"launches {launches}, devices {sorted(link.devices)}")
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
    exponent of each symbol."""
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
    last with a Profiler."""
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
        reset_launches()
        _, bler = sim_ber(link, [8.0], batch_size=batch,
                          max_mc_iter=mc_iter, early_stop=False,
                          verbose=True, checkpoint_path=ckpt,
                          profiler=prof)
        torch.cuda.synchronize()
        launches = {kern.name: dict(kern.variant_launches)
                    for kern in KERNELS}
        bler = float(bler[0])
        lo, hi = bler_band(name, 8.0)
        print(f"    {name} (LS {interp}, {eq.upper()}), batch {batch}: BLER "
              f"{bler} (band [{lo:.4f}, {hi:.4f}]), {link.calls} decoder "
              f"calls, launches {launches}, devices {sorted(link.devices)}")
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
            print(f"    {name}: Profiler spans {prof.counts}")


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


def run_fec_link(dev, name):
    """Phases 15-16: FEC link ``name`` through sim_ber at its Eb/N0 with
    every lifted-kernel count at 0 just before; its band, every tensor on
    the card, no lifted kernel; its decoder on one batch on the card
    against the same decoder on the CPU."""
    cfg = FEC_LINKS[name]
    ebno_db, batch = cfg["ebno_db"], cfg["batch"]
    link = FecLink(dev, name)
    reset_launches()
    _, bler = sim_ber(link, [ebno_db], batch_size=batch,
                      max_mc_iter=cfg["mc_iter"], early_stop=False,
                      verbose=True)
    torch.cuda.synchronize()
    bler = float(bler[0])
    lo, hi = bler_band(name, ebno_db)
    print(f"    {name} at {ebno_db} dB, batch {batch} x {cfg['mc_iter']}: "
          f"BLER {bler} (band [{lo:.4f}, {hi:.4f}]), {link.calls} decoder "
          f"calls, devices {sorted(link.devices)}")
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


def fec_phases(card, results):
    """Phases 15 and 16, run in a fresh process by ``main``; puts an
    empty dict on ``results`` when they pass."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[15] polar link (5G k=512 n=1024, QPSK, AWGN, APP demapper; SC "
          f"at batch 8192, SCL-8 at 4096) through sim_ber on {card}")
    for name in ("polar_sc", "polar_scl8"):
        run_fec_link(dev, name)
    print(f"[16] convolutional (rate 1/2, K=7) and turbo (rate 1/3, K=4, 6 "
          f"iterations) codes, k=1024, through sim_ber on {card}; cut to "
          + ", ".join(f"{n} {FEC_LINKS[n]['mc_iter']} x "
                      f"{FEC_LINKS[n]['batch']}" for n in
                      ("conv_viterbi", "conv_bcjr", "turbo"))
          + " blocks (their decoders loop over time eagerly)")
    for name in ("conv_viterbi", "conv_bcjr", "turbo"):
        run_fec_link(dev, name)
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
    model)."""

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

    def __call__(self, batch_size, ebno_db):
        """One MC iteration: (b, b_hat)."""
        rg, no = self.rg, self.no(ebno_db)
        b = self.src([batch_size, 1, MIMO_STREAMS, self.k])
        x_rg = self.rg_mapper(self.mapper(self.enc(b)))
        made = [no, b, x_rg]
        if self.name == "dl_time":
            cp = 6
            a, tau = self.cdl(batch_size, rg.num_time_samples + self.l_tot - 1,
                              rg.bandwidth)
            h_time = cir_to_time_channel(rg.bandwidth, a, tau, self.l_min,
                                         self.l_max, normalize=True)
            a_freq = a[..., cp:-1:128 + cp][..., :rg.num_ofdm_symbols]
            h_freq = cir_to_ofdm_channel(self.freqs, a_freq, tau,
                                         normalize=True)
            x_pre, _ = self.precoder(x_rg, h_freq)
            x_time = self.mod(x_pre)
            y_time = self.channel(x_time, h_time, no)
            y = self.demod(y_time)
            h_hat, err_var = self.est(y, no)
            x_hat, no_eff = self.equ(y, h_hat, err_var, no)
            llr = self.demapper(x_hat, no_eff)
            made += [a, tau, h_time, h_freq, x_pre, x_time, y_time, y, h_hat,
                     err_var, x_hat, no_eff, llr]
        else:
            # OFDMChannel's two halves, its CIR sampler split off
            a, tau = self.cdl(batch_size, rg.num_ofdm_symbols,
                              1 / rg.ofdm_symbol_duration)
            h = cir_to_ofdm_channel(self.freqs, a, tau, normalize=True)
            y = self.channel.app(x_rg, h, no)
            made += [a, tau, h, y]
            if self.name == "ul_freq":
                h_hat, err_var = self.est(y, no)
                llr = self.det(y, h_hat, err_var, no)
                made += [h_hat, err_var]
            else:
                llr = self.detect(self.det, y, h, no)
            made.append(llr)
        b_hat = self.dec(llr)
        self.calls += 1
        self.devices.update(str(t.device) for t in made + [b_hat])
        return b, b_hat


def run_mimo_link(dev, name, decoder_variant):
    """Phases 17-19: link ``name`` through sim_ber at its Eb/N0 with every
    count at 0 just before and read just after: its band, every tensor on
    cuda:0, one K1 launch of ``decoder_variant`` per decoder call.
    Returns (link, launches of the variant)."""
    cfg = MIMO_LINKS[name]
    ebno_db, batch = cfg["ebno_db"], cfg["batch"]
    link = MimoLink(dev, name)
    reset_launches()
    _, bler = sim_ber(link, [ebno_db], batch_size=batch,
                      max_mc_iter=cfg["mc_iter"], early_stop=False,
                      verbose=False)
    torch.cuda.synchronize()
    launches = {kern.name: dict(kern.variant_launches) for kern in KERNELS}
    bler = float(bler[0])
    lo, hi = bler_band(name, ebno_db)
    print(f"    {name} at {ebno_db} dB, batch {batch} x {cfg['mc_iter']} "
          f"({batch * MIMO_STREAMS * cfg['mc_iter']} blocks): BLER {bler} "
          f"(band [{lo:.4f}, {hi:.4f}]), {link.calls} decoder calls, "
          f"launches {launches}, devices {sorted(link.devices)}")
    if not lo <= bler <= hi:
        raise AssertionError(f"{name} BLER {bler} outside [{lo}, {hi}]")
    if link.devices != {"cuda:0"}:
        raise AssertionError(f"{name} tensors on {link.devices}")
    if launches != {LIFTED_BP_KERNEL.name: {decoder_variant: link.calls},
                    LAYERED_BP_KERNEL.name: {}}:
        raise AssertionError(f"{name}: {launches} for {link.calls} decoder "
                             "calls")
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
    for name in ("det_lmmse", "det_kbest", "det_ep", "det_mmsepic",
                 "det_ml"):
        link, _ = run_mimo_link(dev, name, "f32")
        ebno_db = MIMO_LINKS[name]["ebno_db"]
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


def run_multicell_slots(dev):
    """Phase 20: bench_sys's loop, every slot under the sync debug mode
    "error"."""
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
    for _ in range(cfg["calls"]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, bits, n_nack = sim.run(state, n, gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        total_bits += int(bits)
        nacks += int(n_nack)
    on_card("[20]", [sim.n_re, sim.sinr_base, state[0], state[1], bits,
                     sim.phy_abs.bler_table_interp], dev)
    slots = n * cfg["calls"]
    outcomes = slots * sim.num_ut
    lo, hi = rate_band(*SYS_SLOTS_JAX, outcomes)
    share = nacks / outcomes
    print(f"    {slots} slots: {total_bits} bits decoded, no host sync "
          f"inside a slot")
    print(f"    NACK share {share:.5f} ({nacks} of {outcomes}); band "
          f"[{lo:.5f}, {hi:.5f}] (JAX {SYS_SLOTS_JAX[0]} of "
          f"{SYS_SLOTS_JAX[1]})")
    if not lo <= share <= hi or total_bits <= 0:
        raise AssertionError(f"[20] NACK share {share} outside "
                             f"[{lo}, {hi}] or no bits")


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


def run_downlink_slots(dev):
    """Phase 21: the UMi downlink chain at 210 UTs."""
    cfg = SYS_DOWNLINK
    config.seed = cfg["seed"]
    gen = torch.Generator(device=dev).manual_seed(21)
    sim = DownlinkSlots(generator=gen, device=dev)
    print(f"    {sim.num_bs} sectors, {sim.num_ut} UTs, {sim.num_sym} x "
          f"{sim.num_sc} REs")
    check_drop("UMi", sim.topology, SYS_GAIN_TOPOLOGY)

    # the links' gain over the drop's frozen LSPs and one channel draw
    check_link_gain(sim.link_gain_db(gen), "one draw", dev)

    state = sim.init_state()
    bits = harq = 0
    for _ in range(cfg["slots"]):
        state, out = sim.slot(state, generator=gen)
        bits += int(out["bits"].sum())
        harq += int((out["harq"] >= 0).sum())
    on_card("[21]", list(out.values()) + list(state[0]) + list(state[1:]),
            dev)
    sinr = out["sinr"]
    if not (torch.isfinite(sinr).all() and (sinr >= 0).all()
            and sinr.shape == (1, sim.num_sym, sim.num_sc, sim.num_ut, 1)
            and bool(((out["harq"] >= -1) & (out["harq"] <= 1)).all())):
        raise AssertionError("[21] SINR or HARQ out of range")
    print(f"    {cfg['slots']} slots: {bits} bits decoded, {harq} HARQ "
          f"outcomes")

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


def run_bler_points(dev):
    """Phase 22: BLER table points through CodedAWGNChannelNR (K1); then
    K1 at each MCS's code held identical to its plain version."""
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
    decoders = {}
    reset_launches()
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
    k1 = LIFTED_BP_KERNEL.variant_launches.get("f32", 0)
    print(f"    K1 (ldpc_lifted_bp, f32) launches {k1} in {seen['calls']} "
          f"decoder calls, {LIFTED_BP_KERNEL.launches} lifted launches in "
          f"all; devices {sorted(map(str, seen['devices']))}")
    if k1 != seen["calls"] or LIFTED_BP_KERNEL.launches != k1:
        raise AssertionError("[22] K1 launches differ from decoder calls")
    on_card("[22]", [phy_abs.bler_table_interp,
                     *channel.decoder.buffers()], dev)
    if seen["devices"] != {dev}:
        raise AssertionError(f"[22] tensors on {seen['devices']}")

    # K1 alone at each MCS's code, after the counts were read: the
    # decoder's own input (rate recovery of BPSK LLRs), held identical to
    # the plain decode
    gen = torch.Generator(device=dev).manual_seed(22)
    batch = cfg["batch"]
    for mcs, dec in decoders.items():
        it = dec.num_iter
        llr = dec.recover_llrs(noisy_llrs(dec.encoder, batch, 3.0, gen)[1])
        ker, plain = variant_calls("ldpc_lifted_bp", dec.lifted)
        shape = (f"MCS {mcs}'s code (k={dec.encoder.k}, n={dec.encoder.n}, "
                 f"Z={dec.lifted._z}) x {batch}, BP-{it} boxplus")
        err = assert_identical(ker(llr, it), plain(llr, it), f"[22] {shape}")
        print(f"    ldpc_lifted_bp, {shape}: max|kernel-plain| {err:.3e}")


def sys_phases(card, results):
    """Phases 20-22, run in a fresh process by ``main``."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[20] BASELINE config 5 as bench_sys runs it (21 UMi sectors x 4 "
          f"UTs, distance-proxy SINR, OLLA, PHY abstraction) on {card}")
    run_multicell_slots(dev)
    print(f"[21] config 5 with the TR 38.901 UMi channel (21 sectors x 10 "
          f"UTs, 14 x 612 REs at 30 kHz, downlink) on {card}")
    run_downlink_slots(dev)
    print(f"[22] BLER table points through CodedAWGNChannelNR (K1) on "
          f"{card}")
    run_bler_points(dev)
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
    cases = sorted(glob.glob(os.path.join(NR_DIR, "tb_refs", "*.npz")))
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
    print(f"    {len(GOLDEN_IDS)} stored waveforms within {WAVEFORM_ATOL:g} "
          f"(max |port - stored| {worst:.3e}); {len(cases)} TB references "
          f"bit-exact with and without the scrambler; every output on {dev}")


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
    call."""

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
        self.k = self.tx._tb_size

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


def run_pusch_link(dev):
    """Phase 24: the tutorial's PUSCH link over CDL-B through sim_ber at
    PUSCH["ebno_db"], every count at 0 just before and read just after:
    the TB BLER inside the JAX band, one K1 launch per TBDecoder call and
    two of the "lin" taps' kernel (complex64 and float32) per estimator
    call; then perfect CSI (no estimator; one launch of the channel's
    precoding kernel) and the time domain at a high SNR (BER 0), and the
    min-sum TBDecoder on K2. Returns the precoding kernel's launches."""
    cfg = PUSCH
    link = PuschLink(dev, cfg["n_size_grid"])
    reset_launches()
    ber, bler = sim_ber(link, [cfg["ebno_db"]], batch_size=cfg["batch"],
                        max_mc_iter=cfg["mc_iter"], early_stop=False,
                        verbose=False)
    torch.cuda.synchronize()
    launches = {kern.name: dict(kern.variant_launches) for kern in KERNELS}
    lin = dict(LIN_INTERP_KERNEL.variant_launches)
    bler = float(bler[0])
    lo, hi = bler_band("pusch", cfg["ebno_db"])
    print(f"    {cfg['n_size_grid']} PRBs (TB {link.k} bits, "
          f"{link.tx._tb_encoder.num_cbs} code blocks of n="
          f"{link.tx._tb_encoder.ldpc_encoder.n}) at {cfg['ebno_db']} dB, "
          f"batch {cfg['batch']} x {cfg['mc_iter']}: TB BLER {bler:.5f} "
          f"(band [{lo:.4f}, {hi:.4f}]), BER {float(ber[0]):.3e}, "
          f"{link.calls} TBDecoder calls, launches {launches}, "
          f"{LIN_INTERP_KERNEL.name} {lin}, devices "
          f"{sorted(link.devices)}")
    if not lo <= bler <= hi:
        raise AssertionError(f"[24] TB BLER {bler} outside [{lo}, {hi}]")
    if link.devices != {"cuda:0"}:
        raise AssertionError(f"[24] tensors on {link.devices}")
    if launches != {LIFTED_BP_KERNEL.name: {"f32": link.calls},
                    LAYERED_BP_KERNEL.name: {}}:
        raise AssertionError(f"[24] {launches} for {link.calls} TBDecoder "
                             "calls")
    if lin != {"c64": link.calls, "f32": link.calls}:
        raise AssertionError(f"[24] {LIN_INTERP_KERNEL.name} {lin} for "
                             f"{link.calls} estimator calls")
    precode_launches = 0
    for what, kw, variant in (
            ("perfect CSI", dict(csi="perfect"), "f32"),
            ("time domain (TimeChannel, OFDMDemodulator)",
             dict(domain="time"), "f32"),
            ("min-sum TBDecoder, BP-12", dict(minsum=True), "f32+minsum")):
        link = PuschLink(dev, cfg["n_size_grid"], **kw)
        reset_launches()
        PRECODE_CHANNEL_KERNEL.reset()
        b, b_hat = link(PUSCH_CHECK["batch"], PUSCH_CHECK["ebno_db"])
        ber = float((b != b_hat).float().mean())
        launches = {kern.name: dict(kern.variant_launches)
                    for kern in KERNELS}
        lin = dict(LIN_INTERP_KERNEL.variant_launches)
        precode = dict(PRECODE_CHANNEL_KERNEL.variant_launches)
        print(f"    {what}: BER {ber} at {PUSCH_CHECK['ebno_db']} dB, batch "
              f"{PUSCH_CHECK['batch']}; launches {launches}, "
              f"{LIN_INTERP_KERNEL.name} {lin}, "
              f"{PRECODE_CHANNEL_KERNEL.name} {precode}; devices "
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
        if lin != ({} if link.perfect else {"c64": 1, "f32": 1}):
            raise AssertionError(f"[24] {what}: {LIN_INTERP_KERNEL.name} "
                                 f"{lin} in one call")
        if precode != ({"2x2": 1} if link.perfect else {}):
            raise AssertionError(f"[24] {what}: "
                                 f"{PRECODE_CHANNEL_KERNEL.name} {precode} "
                                 f"in one call")
        precode_launches += sum(precode.values())
    return precode_launches


def run_pusch_full_width(dev):
    """Phase 25: the same settings at 273 PRBs (100 MHz at 30 kHz), batch
    64: after a warm-up, every count at 0 before PUSCH_FULL["mc_iter"]
    iterations and read after (one K1 launch, two of the "lin" taps'
    kernel and one of the per-RE LMMSE kernel per iteration), their TB
    BLER; then K1 alone on the last iteration's own decoder input, held
    identical to its plain decode. Returns the launches of the taps'
    kernel and of the per-RE LMMSE kernel in the counted iterations."""
    cfg = PUSCH_FULL
    batch, ebno_db, iters = cfg["batch"], cfg["ebno_db"], cfg["mc_iter"]
    link = PuschLink(dev, cfg["n_size_grid"])
    enc = link.tx._tb_encoder
    print(f"    {cfg['n_size_grid']} PRBs: TB {enc.tb_size} bits, "
          f"{enc.num_cbs} code blocks of k={enc.cb_size}, n="
          f"{enc.ldpc_encoder.n} (BG{enc.ldpc_encoder._bg[-1]}, Z="
          f"{enc.ldpc_encoder.z}), rate-matched lengths "
          f"{sorted(set(enc.cw_lengths.tolist()))}")
    seen = {}
    dec = link.rx._tb_decoder._decoder
    dec.register_forward_pre_hook(
        lambda module, args: seen.__setitem__("llr_cb", args[0]))
    with torch.no_grad():
        link(batch, ebno_db)  # warm-up: the scrambler's sequences, plans
        reset_launches()
        errors = 0
        for _ in range(iters):
            b, b_hat = link(batch, ebno_db)
            errors += int((b != b_hat).any(dim=-1).sum())
        torch.cuda.synchronize()
        k1 = LIFTED_BP_KERNEL.variant_launches.get("f32", 0)
        launches = {kern.name: dict(kern.variant_launches)
                    for kern in KERNELS}
        lin = dict(LIN_INTERP_KERNEL.variant_launches)
        per_re = dict(LMMSE_PER_RE_KERNEL.variant_launches)
    bler = errors / (iters * batch)
    print(f"    {iters} MC iterations at {ebno_db} dB: TB BLER {bler:.4f}, "
          f"launches {launches} (one K1 launch per iteration), "
          f"{LIN_INTERP_KERNEL.name} {lin} (two per estimator call), "
          f"{LMMSE_PER_RE_KERNEL.name} {per_re} (one per detector call), "
          f"devices {sorted(link.devices)}")
    if k1 != iters or launches != {LIFTED_BP_KERNEL.name: {"f32": iters},
                                   LAYERED_BP_KERNEL.name: {}}:
        raise AssertionError(f"[25] {launches} in {iters} iterations")
    if lin != {"c64": iters, "f32": iters}:
        raise AssertionError(f"[25] {LIN_INTERP_KERNEL.name} {lin} in "
                             f"{iters} iterations")
    if per_re != {"4x2": iters}:
        raise AssertionError(f"[25] {LMMSE_PER_RE_KERNEL.name} {per_re} in "
                             f"{iters} iterations")
    if link.devices != {"cuda:0"}:
        raise AssertionError(f"[25] tensors on {link.devices}")
    if not bler <= PUSCH_FULL_MAX_BLER:
        raise AssertionError(f"[25] TB BLER {bler} at {ebno_db} dB above "
                             f"{PUSCH_FULL_MAX_BLER}")

    # K1 alone at the iteration's own code and input, after the counts
    # were read
    llr = dec.recover_llrs(seen["llr_cb"])
    it = dec.num_iter
    ker, plain = variant_calls("ldpc_lifted_bp", dec.lifted)
    shape = (f"BG1 Z={dec.lifted._z}, n={dec.encoder.n} x {llr.shape[0]}, "
             f"BP-{it} boxplus-phi")
    err = assert_identical(ker(llr, it), plain(llr, it), f"[25] {shape}")
    print(f"    ldpc_lifted_bp, {shape}: max|kernel-plain| {err:.3e}")
    return sum(lin.values()), sum(per_re.values())


def nr_phases(card, results):
    """Phases 23-25, run in a fresh process by ``main``. Puts the "lin"
    taps' kernel's and the per-RE LMMSE kernel's launches in phase 25's
    counted iterations, and the channel-precoding kernel's in phase 24's
    perfect-CSI call, on ``results``."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    config.seed = PUSCH_SEED
    print(f"[23] the PUSCH transmitter and TB encoder against the stored "
          f"references on {card}")
    run_nr_goldens(dev)
    print(f"[24] the PUSCH tutorial's link (16 PRBs, 2 layers, TPMI 1, "
          f"MCS 14) over CDL-B through sim_ber on {card}")
    precode_launches = run_pusch_link(dev)
    print(f"[25] the same settings at 273 PRBs, batch 64 on {card}")
    lin_launches, per_re_launches = run_pusch_full_width(dev)
    sys.stdout.flush()
    results.put({LIN_INTERP_KERNEL.name: lin_launches,
                 LMMSE_PER_RE_KERNEL.name: per_re_launches,
                 PRECODE_CHANNEL_KERNEL.name: precode_launches})


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

    def channel_uses(self, batch_size, ebno_db):
        """The MIMO link up to the equalizer: (info bits [batch, 4, 512],
        symbols' shape, y [N, 16], h [N, 16, 4], S = N0 I [16, 16]), N =
        batch x 256 channel uses."""
        c = FLAT
        b = self.src([batch_size, c["num_tx"], c["k"]])
        x = self.mapper(self.enc(b))
        no = ebnodb2no(ebno_db, c["nbps"], c["k"] / c["n"]).to(self.dev) \
            * c["num_rx"] ** 0.5
        y, h = self.channel(x.reshape(-1, c["num_tx"]), no)
        self.devices.update(str(t.device) for t in (b, x, no, y, h))
        return b, x.shape, y, h, (no * self.eye).to(torch.complex64)

    def __call__(self, batch_size, ebno_db):
        """One MC iteration of the MIMO link: (info bits, decisions)
        [batch, 4, 512]."""
        b, shape, y, h, s = self.channel_uses(int(batch_size), ebno_db)
        x_hat, no_eff = lmmse_equalizer(y, h, s)
        llr = self.demapper(x_hat.reshape(shape), no_eff.reshape(shape))
        b_hat = self.dec(llr)
        self.devices.update(str(t.device) for t in (x_hat, llr, b_hat))
        return b, b_hat

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


def run_flat_links(dev):
    """Phase 26: both links through sim_ber, every count at 0 just before
    and read just after: BLER inside the JAX band, one K1 launch per
    decoder call, every tensor on the card; PerColumnModel and Rayleigh
    block fading against themselves on the CPU, CIRDataset into
    OFDMChannel on the card; K1 alone at the links' code and batch,
    held identical to its plain decode. Returns the whitened-LMMSE
    kernel's launches in the MIMO link's sim_ber: one per MC iteration
    (none in the BSC link's)."""
    c, cb = FLAT, FLAT_BSC
    link = FlatLink(dev)
    lmmse_launches = {}
    for name, model, point, batch, mc_iter, per_call in (
            ("mimo", link, c["ebno_db"], c["batch"], c["mc_iter"],
             c["num_tx"]),
            ("bsc", link.bsc, cb["pb"], cb["batch"], cb["mc_iter"], 1)):
        link.calls, link.devices = 0, set()
        reset_launches()
        ber, bler = sim_ber(model, [point], batch_size=batch,
                            max_mc_iter=mc_iter, early_stop=False,
                            verbose=False)
        torch.cuda.synchronize()
        launches = {kern.name: dict(kern.variant_launches)
                    for kern in KERNELS + (LMMSE_WHITENED_KERNEL,)}
        bler = float(bler[0])
        lo, hi = rate_band(*FLAT_JAX[name], batch * per_call * mc_iter)
        print(f"    {name} at {point}: BLER {bler:.5f} over "
              f"{batch * per_call * mc_iter} codewords (band [{lo:.4f}, "
              f"{hi:.4f}]), BER {float(ber[0]):.3e}, {link.calls} decoder "
              f"calls, launches {launches}, devices {sorted(link.devices)}")
        if not lo <= bler <= hi:
            raise AssertionError(f"[26] {name}: BLER {bler} outside "
                                 f"[{lo}, {hi}]")
        if link.devices != {str(dev)}:
            raise AssertionError(f"[26] {name}: tensors on {link.devices}")
        lmmse = {"c64": mc_iter} if name == "mimo" else {}
        if launches != {LIFTED_BP_KERNEL.name: {"f32": link.calls},
                        LAYERED_BP_KERNEL.name: {},
                        LMMSE_WHITENED_KERNEL.name: lmmse} \
                or link.calls != mc_iter:
            raise AssertionError(f"[26] {name}: {launches} for {link.calls} "
                                 "decoder calls")
        if name == "mimo":
            lmmse_launches = lmmse

    batch = c["batch"]

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
    print(f"    ldpc_lifted_bp, {shape}: max|kernel-plain| {err:.3e}")
    return lmmse_launches


PULSE_FILTERS = {
    "RaisedCosineFilter": lambda c, **kw: RaisedCosineFilter(
        c["span"], c["sps"], c["beta"], **kw),
    "RootRaisedCosineFilter": lambda c, **kw: RootRaisedCosineFilter(
        c["span"], c["sps"], c["beta"], **kw),
    "SincFilter": lambda c, **kw: SincFilter(c["span"], c["sps"], **kw),
    "CustomFilter": lambda c, **kw: CustomFilter(
        c["sps"], np.hanning(c["span"] * c["sps"] + 1), **kw),
}


def run_pulse_shaping(dev):
    """Phase 27: the pulse-shaping tutorial's chain on the card (its
    symbols back within the truncated RRC's ISI floor, its ACLR near the
    filter's), every filter class with and without each window against
    itself on the CPU."""
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
    print(f"    {len(PULSE_FILTERS)} filter classes x 4 windows against the "
          f"CPU: largest error {worst:.2e} of the largest value (bound "
          f"{PULSE_CPU_RTOL:.0e})")


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


def run_optical(dev):
    """Phase 28: the optical tutorial's 10-span link on a [2, 1024]
    waveform, as written and with ``with_manakov=True``: noise-free, the
    card against the CPU in single and double precision; with noise, the
    added power against the analytic ASE power; the adaptive schedule's
    step count on the card and the CPU."""
    c = OPTICAL
    gen = torch.Generator(device=dev).manual_seed(FLAT_SEED + 2)
    shape = (2, c["samples"])
    x64 = torch.complex(torch.randn(shape, generator=gen, device=dev,
                                    dtype=torch.float64),
                        torch.randn(shape, generator=gen, device=dev,
                                    dtype=torch.float64)) * (0.5e-3) ** 0.5
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


def flat_phases(card, results):
    """Phases 26-28, run in a fresh process by ``main``."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.seed = FLAT_SEED
    t0 = time.perf_counter()
    print(f"[26] coded MIMO over correlated flat fading (4 x 16, 16-QAM, "
          f"BG2 Z=64) and the BSC link through sim_ber, K1, on {card}")
    lmmse_launches = run_flat_links(dev)
    print(f"    phase 26 took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    print(f"[27] pulse shaping (RRC, up/down-sampling, windows) on {card}")
    run_pulse_shaping(dev)
    print(f"    phase 27 took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    print(f"[28] the optical link (10 x SSFM + EDFA) on {card}")
    run_optical(dev)
    print(f"    phase 28 took {time.perf_counter() - t1:.1f} s; phases 26-28 "
          f"took {time.perf_counter() - t0:.1f} s")
    sys.stdout.flush()
    results.put({LMMSE_WHITENED_KERNEL.name: lmmse_launches})


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


def rt_canyon_phase(dev):
    """Phase 29: bench.py's canyon path solve on the card."""
    import sionna_tpu_torch.rt as rt
    from sionna_tpu_torch.phy.channel import cir_to_ofdm_channel
    c = RT_CANYON
    scene = rt_scene(rt, "simple_street_canyon", c["tx"], c["rx"])
    solver = rt.PathSolver()
    if solver.device != dev:
        raise AssertionError(f"[29] PathSolver() on {solver.device}")
    kw = dict(max_depth=c["max_depth"], samples_per_src=c["samples"])
    paths = solver(scene, **kw)
    paths.cir(out_type="numpy")
    on_card("[29] paths", [paths.a, paths.tau, paths.valid, paths.theta_t,
                           paths.doppler, paths.interactions, paths.types],
            dev)
    print(f"    {paths.num_paths} candidate paths")
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


def rt_city_phase(dev):
    """Phase 30: bench.py's 100k-triangle city on the card."""
    import sionna_tpu_torch.rt as rt
    import sionna_tpu_torch.rt.accel as accel
    import sionna_tpu_torch.rt.geometry as geometry
    import sionna_tpu_torch.rt.solver as solver_mod
    c = RT_CITY
    city = rt_scene(rt, rt.make_city(c["nx"], c["ny"], subdiv=c["subdiv"]),
                    c["tx"], c["rx"])
    kw = dict(max_depth=c["max_depth"], samples_per_src=c["samples"])
    accel.STATS.reset()
    paths = rt.PathSolver()(city, **kw)
    st = accel.STATS
    print(f"    {city.num_triangles} triangles: {st.native_builds} native "
          f"build(s) of the cluster structure (g++), {st.numpy_builds} NumPy "
          f"build(s); {st.chunks} accel ray chunks, {st.skipped} skipped (no "
          f"cluster entered), {st.repairs} took the dense repair sweep; "
          f"valid paths per depth {paths_per_depth(paths)}, gain "
          f"{link_gain(paths):.4e}")
    if st.native_builds != 1 or st.numpy_builds != 0:
        raise AssertionError("[30] the native cluster builder did not run")
    on_card("[30] paths", [paths.a, paths.tau, paths.valid], dev)

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
    unique = unique_nearest(orig, dirs, tri, t_d)
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


def rt_map_phase(dev):
    """Phase 31: bench.py's radio map on the card."""
    import sionna_tpu_torch.rt as rt
    c = RT_MAP
    scene = rt_scene(rt, "simple_street_canyon", RT_CANYON["tx"],
                     RT_CANYON["rx"])
    rm_solver = rt.RadioMapSolver()
    if rm_solver.device != dev:
        raise AssertionError(f"[31] RadioMapSolver() on {rm_solver.device}")
    rm = rm_solver(scene, cell_size=c["cell_size"], size=c["size"],
                   center=c["center"], max_depth=c["max_depth"],
                   samples_per_src=c["samples"])
    on_card("[31] map", [rm.path_gain, rm.rss, rm.sinr], dev)
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


def rt_phases(card, results):
    """Phases 29-31, run in a fresh process by ``main``."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"[29] BASELINE config 4: bench.py's canyon path solve (depth 3, "
          f"200,000 rays) on {card}")
    rt_canyon_phase(dev)
    print(f"    phase 29 took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    print(f"[30] bench.py's city (make_city(10, 10, subdiv=10), depth 2, "
          f"100,000 rays) on {card}")
    rt_city_phase(dev)
    print(f"    phase 30 took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    print(f"[31] bench.py's radio map (200 x 200 cells, depth 2, 100,000 "
          f"rays) on {card}")
    rt_map_phase(dev)
    print(f"    phase 31 took {time.perf_counter() - t1:.1f} s; phases 29-31 "
          f"took {time.perf_counter() - t0:.1f} s")
    sys.stdout.flush()
    results.put({})


def render_scene(rt, view):
    """Phase 32's scene of ``view`` ("canyon", "map", "city_cut", "city")
    in the package ``rt`` (the port's, or the JAX package's for
    ``tools/rt_render_ref.py``): its phase's tx and rx, and the camera."""
    if view in ("canyon", "map"):
        c = RT_CANYON
        scene = rt_scene(rt, "simple_street_canyon", c["tx"], c["rx"])
    else:
        c = RT_CITY_CUT if view == "city_cut" else RT_CITY
        scene = rt_scene(rt, rt.make_city(c["nx"], c["ny"],
                                          subdiv=c["subdiv"]),
                         c["tx"], c["rx"])
    pos, look = RT_RENDER["views"]["canyon" if view == "map" else view]
    cam = rt.Camera("cam", pos)
    cam.look_at(look)
    scene.add(cam)
    return scene


def render_map(rt, scene):
    """Phase 31's radio map of the canyon ``scene``, the overlay of
    phase 32's "map" view."""
    c = RT_MAP
    return rt.RadioMapSolver()(scene, cell_size=c["cell_size"],
                               size=c["size"], center=c["center"],
                               max_depth=c["max_depth"],
                               samples_per_src=c["samples"])


def render_stats(img, plain=None):
    """Per-channel means, pixel-class counts and every
    ``RT_RENDER["sample_stride"]``-th pixel of a rendered [h, w, 3] image.
    Sky and markers are the pixels of exactly their colour; ``plain``
    (the same view without the radio map) marks the overlay's pixels as
    those that differ from it; geometry is the rest."""
    from sionna_tpu_torch.rt.render import _SKY, RX_COLOR, TX_COLOR
    px = np.asarray(img, np.float32).reshape(-1, 3)

    def exactly(color):
        return int(np.all(px == np.float32(color), axis=-1).sum())

    counts = {"sky": exactly(_SKY), "tx": exactly(TX_COLOR),
              "rx": exactly(RX_COLOR), "overlay": 0 if plain is None else int(
                  np.any(px != np.asarray(plain, np.float32).reshape(-1, 3),
                         axis=-1).sum())}
    counts["geometry"] = px.shape[0] - sum(counts.values())
    return {"mean": px.astype(np.float64).mean(0).tolist(), "counts": counts,
            "sample": px[::RT_RENDER["sample_stride"]].tolist()}


def check_render_against_jax(view, stats, hits, triangles, cell_gain=None):
    """Phase 32's image of ``view`` against JAX's (``RT_RENDER_JAX``):
    counts, means and sampled pixels; a sampled pixel off by more than the
    tolerance is excused where its ray hits another triangle than JAX's
    (``hits``: the port's ids of the sampled rays) on an edge the two
    share, or, under the radio map, where the card's gain of its map cell
    (``cell_gain``, at JAX's ``sample_cell``) is more than RT_GAIN_RTOL
    from JAX's (phase 31's corner and shared-edge cells). Returns the
    excused pixels."""
    want = RT_RENDER_JAX[view]
    n_px = RT_RENDER["resolution"][0] * RT_RENDER["resolution"][1]
    for name, n in want["counts"].items():
        if abs(stats["counts"][name] - n) > RT_RENDER_COUNT_SHARE * n_px:
            raise AssertionError(f"[32] {view}: {stats['counts'][name]} "
                                 f"{name} pixels against JAX's {n}")
    err = np.abs(np.subtract(stats["mean"], want["mean"])).max()
    if not err <= RT_RENDER_MEAN_ATOL:
        raise AssertionError(f"[32] {view}: channel means {stats['mean']} "
                             f"against JAX's {want['mean']}")
    diff = np.abs(np.subtract(stats["sample"], want["sample"])).max(-1)
    if cell_gain is not None:
        ref = np.asarray(want["sample_cell_gain"])
        cell_off = ((np.asarray(want["sample_cell"]) >= 0)
                    & (np.abs(cell_gain - ref) > RT_GAIN_RTOL * ref))
    else:
        cell_off = np.zeros(diff.shape, bool)
    excused = []
    for k in np.nonzero(diff > RT_RENDER_PIXEL_ATOL)[0]:
        a, b = int(hits[k]), int(want["sample_tri"][k])
        shared = 0 if min(a, b) < 0 else len(
            set(map(tuple, triangles[a])) & set(map(tuple, triangles[b])))
        if not cell_off[k] and (a == b or shared < 2):
            raise AssertionError(
                f"[32] {view}: sampled pixel {k * RT_RENDER['sample_stride']} "
                f"{stats['sample'][k]} against JAX's {want['sample'][k]} "
                f"(triangle {a}, JAX's {b})")
        excused.append((int(k) * RT_RENDER["sample_stride"], a, b,
                        float(diff[k])))
    return excused, err, float(diff[diff <= RT_RENDER_PIXEL_ATOL].max())


def unique_nearest(orig, dirs, tri, t_min):
    """[R] bool: the rays whose nearest distance ``t_min`` belongs to one
    triangle only (an id is ambiguous on a shared edge), on the card."""
    from sionna_tpu_torch.rt.geometry import moller_trumbore
    count = torch.zeros(dirs.shape[0], dtype=torch.int64, device=dirs.device)
    block = max(64, 32_000_000 // dirs.shape[0])
    for b in range(0, tri.shape[0], block):
        t_c, hit_c = moller_trumbore(orig, dirs, tri[b:b + block])
        count += (torch.where(hit_c, t_c, torch.inf)
                  == t_min[:, None]).sum(1)
    return torch.isfinite(t_min) & (count == 1)


def rt_render_phase(dev):
    """Phase 32: the renderer at 655 x 500 on the card."""
    import importlib
    import sionna_tpu_torch.rt as rt
    import sionna_tpu_torch.rt.accel as accel
    import sionna_tpu_torch.rt.geometry as geometry
    render_mod = importlib.import_module("sionna_tpu_torch.rt.render")
    res = RT_RENDER["resolution"]
    n_px = res[0] * res[1]
    scenes = {v: render_scene(rt, v) for v in ("canyon", "city_cut", "city")}
    rm = render_map(rt, scenes["canyon"])
    on_card("[32] map", [rm.path_gain], dev)

    def render(view):
        scene = scenes["canyon" if view == "map" else view]
        return scene.render(resolution=res,
                            radio_map=rm if view == "map" else None)

    accel.STATS.reset()
    images = {"city": render("city")}
    st = accel.STATS
    print(f"    the city's {scenes['city'].num_triangles} triangles: "
          f"{st.native_builds} native build of the accel structure, "
          f"{st.numpy_builds} NumPy; {st.chunks} accel ray chunks, "
          f"{st.repairs} dense repair sweeps")
    if st.native_builds != 1 or st.numpy_builds != 0 or st.chunks == 0:
        raise AssertionError("[32] the city's render did not take the "
                             "natively built accel path")
    for view in ("canyon", "map", "city_cut"):
        images[view] = render(view)
    for view, img in images.items():
        if img.shape != (res[1], res[0], 3) or img.dtype != np.float32 \
                or not np.isfinite(img).all() or img.min() < 0 \
                or img.max() > 1:
            raise AssertionError(f"[32] {view}: image {img.shape} "
                                 f"{img.dtype} outside [0, 1]")

    # the canyon (with and without the map) and the cut city against JAX
    for view in ("canyon", "map", "city_cut"):
        scene = scenes["canyon" if view == "map" else view]
        stats = render_stats(images[view],
                             images["canyon"] if view == "map" else None)
        orig, dirs = render_mod.camera_rays(scene.cameras["cam"], res, 45.)
        s = slice(None, None, RT_RENDER["sample_stride"])
        tri = torch.as_tensor(scene.triangles, dtype=torch.float32,
                              device=dev)
        _, idx, hit = geometry.nearest_hit(
            torch.as_tensor(orig[s], dtype=torch.float32, device=dev),
            torch.as_tensor(dirs[s], dtype=torch.float32, device=dev), tri)
        hits = torch.where(hit, idx, -1).cpu().numpy()
        cell_gain = None
        if view == "map":
            cells = np.asarray(RT_RENDER_JAX["map"]["sample_cell"])
            gain = rm.path_gain[0].double().cpu().numpy().reshape(-1)
            cell_gain = np.where(cells >= 0, gain[np.maximum(cells, 0)], 0.)
        excused, mean_err, pix_err = check_render_against_jax(
            view, stats, hits, scene.triangles, cell_gain)
        on_map = ""
        if view == "map":
            plain = render_stats(images["canyon"])["sample"]
            under = np.any(np.not_equal(stats["sample"], plain), axis=-1)
            on_map = f" ({int(under.sum())} of them under the overlay)"
        print(f"    {view}: pixels {stats['counts']} (JAX "
              f"{RT_RENDER_JAX[view]['counts']}); channel means within "
              f"{mean_err:.1e} of JAX's; {len(stats['sample'])} sampled "
              f"pixels{on_map} within {pix_err:.1e}, {len(excused)} apart "
              f"(pixel, triangle, JAX's, error) on a shared edge"
              + (" or a map cell off JAX's" if view == "map" else "")
              + f" {excused}")

    # the city's accelerated hits against the dense sweep, on the card
    scene = scenes["city"]
    orig, dirs = render_mod.camera_rays(scene.cameras["cam"], res, 45.)
    o = torch.as_tensor(orig, dtype=torch.float32, device=dev)
    d = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    host_tri = scene.triangles.astype(np.float32)
    tri = torch.as_tensor(host_tri, device=dev)
    t_a, i_a, h_a = geometry.nearest_hit(
        o, d, tri, accel=accel.build_accel(host_tri, dev))
    t_d, i_d, h_d = geometry.nearest_hit(o, d, tri)
    unique = unique_nearest(o, d, tri, t_d)
    torch.cuda.synchronize()
    same = (torch.equal(t_a, t_d) and torch.equal(h_a, h_d)
            and torch.equal(i_a[unique], i_d[unique]))
    print(f"    city: the render's {n_px} accelerated rays against the dense "
          f"sweep on the card: {int(h_d.sum())} hits, t and hits "
          f"{'identical' if same else 'DIFFERENT'}, ids equal on the "
          f"{int(unique.sum())} with a unique nearest t")
    if not same:
        raise AssertionError("[32] the city's accelerated hits differ from "
                             "the dense sweep")


def rt_mitsuba_phase(dev):
    """Phase 33: the Mitsuba loader on the card."""
    import tempfile
    import sionna_tpu_torch.rt as rt
    c = RT_CANYON
    fixture = rt_scene(rt, MITSUBA_FIXTURE, c["tx"], c["rx"])
    twin = rt_scene(rt, "simple_street_canyon", c["tx"], c["rx"])
    if not (np.array_equal(fixture.triangles, twin.triangles)
            and [m.name for m in fixture.triangle_materials]
            == [m.name for m in twin.triangle_materials]):
        raise AssertionError("[33] the fixture's triangles differ from the "
                             "procedural canyon's")
    kw = dict(max_depth=c["max_depth"], samples_per_src=c["samples"])
    p_fix, p_twin = rt.PathSolver()(fixture, **kw), rt.PathSolver()(twin, **kw)
    on_card("[33] paths", [p_fix.a, p_fix.tau], dev)
    same = all(torch.equal(getattr(p_fix, f), getattr(p_twin, f))
               for f in ("valid", "tau", "a", "interactions"))
    want = RT_JAX["canyon"]
    err = check_rel("[33] fixture gain against JAX", link_gain(p_fix),
                    want["gain"], RT_GAIN_RTOL)
    print(f"    fixture ({fixture.num_triangles} triangles): triangles and "
          f"materials identical to the procedural canyon's; phase 29's "
          f"solve on the card {'identical' if same else 'DIFFERENT'} "
          f"(valid, tau, a), valid "
          f"paths per depth {paths_per_depth(p_fix)} (JAX "
          f"{want['valid_per_depth']}), gain {err:.1e} from JAX's")
    if not same or paths_per_depth(p_fix) != want["valid_per_depth"]:
        raise AssertionError("[33] the fixture's solve differs")

    c = RT_CITY
    city = rt_scene(rt, rt.make_city(c["nx"], c["ny"], subdiv=c["subdiv"]),
                    c["tx"], c["rx"])
    with tempfile.TemporaryDirectory() as tmp:
        path = rt.export_mitsuba_xml(city, os.path.join(tmp, "city.xml"))
        back = rt.load_scene(path, frequency=city.frequency)
    # the bundle's vertices: the exporter's (rounded to 1e-9 m, merged,
    # then float32); 1,458 of the 901,800 coordinates are one float32 ULP
    # from the city's own float32 geometry on the card
    if not (np.array_equal(back.triangles, np.round(city.triangles, 9)
                           .astype(np.float32).astype(np.float64))
            and [m.name for m in back.triangle_materials]
            == [m.name for m in city.triangle_materials]):
        raise AssertionError("[33] the re-imported city's triangles differ")
    moved = int((back.triangles != city.triangles.astype(np.float32)).sum())
    back = rt_scene(rt, back, c["tx"], c["rx"])
    kw = dict(max_depth=c["max_depth"], samples_per_src=c["samples"])
    p_back, p_city = rt.PathSolver()(back, **kw), rt.PathSolver()(city, **kw)
    same = all(torch.equal(getattr(p_back, f), getattr(p_city, f))
               for f in ("valid", "interactions"))
    valid = p_city.valid[0, 0]
    tau_err = float(((p_back.tau - p_city.tau)[0, 0][valid].abs()
                     / p_city.tau[0, 0][valid]).max())
    a_err = float((p_back.a - p_city.a).abs().max() / p_city.a.abs().max())
    gain_err = check_rel("[33] re-imported city's gain", link_gain(p_back),
                         link_gain(p_city), RT_GAIN_RTOL)
    print(f"    city ({city.num_triangles} triangles): exported and "
          f"loaded back; triangles the exporter's float32 vertices "
          f"({moved} coordinates one ULP from the city's float32 ones), "
          f"materials identical; "
          f"against phase 30's solve on the card: valid paths and "
          f"interactions {'identical' if same else 'DIFFERENT'} (per depth "
          f"{paths_per_depth(p_back)}), tau {tau_err:.1e}, |a| {a_err:.1e} "
          f"of the largest, gain {gain_err:.1e}")
    if not (same and tau_err <= RT_TAU_RTOL and a_err <= RT_A_RTOL):
        raise AssertionError("[33] the re-imported city's solve differs")


def render_phases(card, results):
    """Phases 32-33, run in a fresh process by ``main``."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"[32] the renderer at {RT_RENDER['resolution'][0]} x "
          f"{RT_RENDER['resolution'][1]} on {card}")
    rt_render_phase(dev)
    print(f"    phase 32 took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    print(f"[33] the Mitsuba loader: {MITSUBA_FIXTURE} and the city's "
          f"round trip, solved on {card}")
    rt_mitsuba_phase(dev)
    print(f"    phase 33 took {time.perf_counter() - t1:.1f} s; phases 32-33 "
          f"took {time.perf_counter() - t0:.1f} s")
    sys.stdout.flush()
    results.put({})


def sim_rank(rank, world, backend, distribute, port, device, results):
    """One rank of phase 34 on ``device``: phase 5's link through
    ``sim_ber`` over a ``torch.distributed`` group joined by
    ``init_multihost``; puts its own counts, the summed counters it saw
    and its K1 launches on ``results``."""
    from sionna_tpu_torch.phy.utils import init_multihost
    os.environ["LOCAL_RANK"] = "0"
    dev = torch.device(device)
    config.device = dev
    init_multihost(f"127.0.0.1:{port}", world, rank, backend=backend)
    run, _, seen = make_link(dev)
    snrs = [3.0, 4.0]
    own = {e: torch.zeros(4, dtype=torch.int64, device=dev) for e in snrs}

    def counted(batch_size, ebno_db):
        b, b_hat = run(batch_size, ebno_db)
        ne = b != b_hat
        own[ebno_db] += torch.stack([
            ne.sum(), ne.any(dim=-1).sum(),
            torch.tensor(b.numel(), device=dev),
            torch.tensor(b.shape[0], device=dev)])
        return b, b_hat

    summed = {}

    def callback(it, i, ebno, bit_e, blk_e, nb, nblk):
        summed[i] = [it, int(bit_e[i]), int(blk_e[i]), int(nb[i]),
                     int(nblk[i])]

    reset_launches()
    _, bler = sim_ber(counted, snrs, batch_size=LINK["batch"],
                      max_mc_iter=DIST_LINK["max_mc_iter"],
                      num_target_block_errors=DIST_LINK["target_block_errors"],
                      device_iters=1, early_stop=False, verbose=rank == 0,
                      distribute=distribute, callback=callback)
    results.put((rank, {
        "bler": bler.tolist(), "summed": [summed[i] for i in range(2)],
        "own": [own[e].tolist() for e in snrs], "calls": seen["calls"],
        "launches": LIFTED_BP_KERNEL.variant_launches.get("f32", 0),
        "devices": sorted(seen["devices"]),
        "backend": str(torch.distributed.get_backend())}))
    torch.distributed.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world, backend, distribute, timeout, device="cuda:0"):
    """Phase 34's ranks as spawned processes; returns their results in
    rank order, or raises unless all end with 0 within ``timeout`` s."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=sim_rank, args=(r, world, backend, distribute,
                                                port, device, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out = {}
    try:
        while len(out) < world and time.monotonic() < deadline:
            try:
                rank, res = results.get(timeout=5)
                out[rank] = res
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world or len(out) != world:
        raise AssertionError(f"[34] {world} {backend} rank(s): exit codes "
                             f"{codes}, {len(out)} results in {timeout} s")
    return [out[r] for r in range(world)]


def distributed_phase(card, runs=((2, "gloo", "multihost"),
                                  (1, "nccl", "all")), device="cuda:0"):
    """Phase 34: phase 5's link through ``sim_ber`` over torch.distributed
    ranks on the card: two gloo ranks sharing it, and one NCCL rank (NCCL
    takes one rank per card, and "multihost" asks for two or more ranks:
    the group's world through distribute="all")."""
    for world, backend, distribute in runs:
        ranks = run_ranks(world, backend, distribute, 240, device)
        r0 = ranks[0]
        check_link_bands(r0["bler"], f"[34] {world} {backend} rank(s)")
        for i in range(2):
            total = np.sum([r["own"][i] for r in ranks], axis=0).tolist()
            if any(r["summed"][i] != r0["summed"][i] for r in ranks) \
                    or r0["summed"][i][1:] != [total[0], total[1], total[2],
                                               total[3]]:
                raise AssertionError(
                    f"[34] point {i}: summed counters "
                    f"{[r['summed'][i] for r in ranks]} against the ranks' "
                    f"own {[r['own'][i] for r in ranks]}")
        for rank, r in enumerate(ranks):
            if r["backend"] != backend \
                    or r["devices"] != [torch.device(device).type] \
                    or r["launches"] == 0 or r["launches"] != r["calls"]:
                raise AssertionError(f"[34] rank {rank}: {r}")
        # the summed block errors end the 3 dB point on every rank at once,
        # before one rank's own would have
        if not (r0["summed"][0][0] < DIST_LINK["max_mc_iter"]
                and r0["summed"][0][2] >= DIST_LINK["target_block_errors"]
                and (world == 1 or max(r["own"][0][1] for r in ranks)
                     < DIST_LINK["target_block_errors"])):
            raise AssertionError(f"[34] the 3 dB point's stop: "
                                 f"{r0['summed'][0]}")
        print(f"    {world} rank(s), {backend}, distribute={distribute!r}: "
              f"BLER {r0['bler']}; iterations per point "
              f"{[s[0] for s in r0['summed']]} on every rank; summed counters "
              f"[bit errors, block errors, bits, blocks] "
              f"{[s[1:] for s in r0['summed']]} = the sums of the ranks' own; "
              f"decoder calls = K1 launches per rank "
              f"{[r['calls'] for r in ranks]}, on {card}")


def qam16_ber(ebno_db):
    """The BER of Gray-labelled 16-QAM over AWGN (per-axis 4-PAM with
    threshold decisions, exact)."""
    a = np.sqrt(0.4 * 10 ** (ebno_db / 10))
    from scipy.special import erfc
    return 3 / 8 * erfc(a) + 1 / 4 * erfc(3 * a) - 1 / 8 * erfc(5 * a)


def sim_rows(text):
    """The rows of ``sim_ber``'s table in ``text``: (Eb/N0, BER, BLER, bit
    errors, bits, block errors, blocks)."""
    rows = []
    for line in text.splitlines():
        f = [x.strip() for x in line.split("|")]
        if len(f) != 9:
            continue
        try:
            rows.append((float(f[0]), float(f[1]), float(f[2]), int(f[3]),
                         int(f[4]), int(f[5]), int(f[6])))
        except ValueError:
            continue
    return rows


def run_example(card, results, path):
    """Runs the example program ``path`` as ``__main__`` in this fresh
    process (on the card: no FAST or CPU switch), its standard output
    captured; puts (the output, the kernels' launches by variant, the
    calls of ``LDPC5GDecoder``) on ``results``."""
    import runpy
    for k in ("SIONNA_TPU_EXAMPLES_FAST", "SIONNA_TPU_EXAMPLES_CPU"):
        os.environ.pop(k, None)
    calls = [0]
    forward = LDPC5GDecoder.forward

    def counted(self, *args, **kwargs):
        calls[0] += 1
        return forward(self, *args, **kwargs)

    LDPC5GDecoder.forward = counted
    sys.argv = [path]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(path, run_name="__main__")
    results.put((out.getvalue(), {
        kern.name: dict(kern.variant_launches) for kern in KERNELS},
        calls[0]))


def examples_phase(card):
    """Phase 35: the port's five examples at full size on the card, each
    in a fresh process with its time limit."""
    root = os.path.dirname(os.path.abspath(__file__))
    for script, limit in EXAMPLES.items():
        t0 = time.perf_counter()
        text, launches, calls = run_in_process(
            run_example, card, limit,
            os.path.join(root, "sionna_tpu_torch", "examples", script))
        wall = time.perf_counter() - t0
        print(f"    {script} took {wall:.1f} s on {card}; last lines:")
        for line in text.strip().splitlines()[-4:]:
            print(f"      {line}")
        rows = sim_rows(text)
        ran = {k: v for k, v in launches.items() if v}
        if script.startswith("01"):
            # per axis 2 bits of one symbol: twice the binomial variance
            for ebno, ber, _, _, nbits, _, _ in rows:
                p = qam16_ber(ebno)
                tol = 5 * np.sqrt(2 * p * (1 - p) / nbits)
                if not abs(ber - p) <= tol:
                    raise AssertionError(f"[35] 01: BER {ber} at {ebno} dB, "
                                         f"closed form {p} +- {tol}")
            print(f"      BER within 5 standard errors of the closed form at "
                  f"all {len(rows)} points")
        if script.startswith("03"):
            row = next((r for r in rows if r[0] == 8.0), None)
            if row is None:
                raise AssertionError("[35] 03: no row at 8 dB")
            lo, hi = rate_band(*MIMO_JAX[("ul_freq", 8.0)], row[6])
            print(f"      BLER at 8 dB {row[2]} ({row[5]} of {row[6]} "
                  f"codewords), the JAX band [{lo:.4f}, {hi:.4f}] "
                  f"(phase 17's link)")
            if not lo <= row[2] <= hi:
                raise AssertionError("[35] 03: BLER at 8 dB outside the "
                                     "JAX band")
        # examples 02 and 03 decode with min-sum LDPC: one K2 launch per
        # decoder call; the others launch no kernel
        want = ({LIFTED_BP_KERNEL.name: {"f32+minsum": calls}} if calls
                else {})
        if script[:2] in ("02", "03") and not calls:
            raise AssertionError(f"[35] {script}: no LDPC decoder call")
        print(f"      kernel launches {ran or 'none'} in {calls} LDPC "
              f"decoder calls")
        if ran != want:
            raise AssertionError(f"[35] {script}: launches {ran}, want "
                                 f"{want}")


def grad_ptxas_report(kern):
    """One line per kernel of a gradient kernel's library: ptxas's
    registers, stack, spill and shared-memory figures."""
    lines, entry = [], None
    for line in kern.build_log.splitlines():
        m = re.search(r"Compiling entry function '.*?\d+((?:flooding|layered)"
                      r"_(?:tape|reverse)_kernel(?:I(?:L[bi]\d+E)+E)?)", line)
        if m:
            entry = m.group(1)
        elif entry and ("registers" in line or "spill" in line
                        or "smem" in line):
            lines.append(f"{kern.name}<{entry}>: "
                         f"{line.split(':', 1)[-1].strip()}")
    return lines


def grad_bound(lift, batch, num_iter, ops, layered):
    """(bound ms, "bytes" or "operations") of one call of a gradient
    kernel: the bytes it must move at 3.35 TB/s (the LLRs or dL/dmarg
    read and the marginals or dL/dllr written, the tape written by the
    tape kernel and read by the backward kernel, once each) against its
    FP32 operations at 67 TFLOP/s: the edge-lane updates of the call
    times ``ops`` per update (K1's count for a tape kernel,
    ``sass_ops.backward_ops_per_update`` for a backward kernel)."""
    z, n_e, n_c = lift._z, len(lift._edges), lift._n_col_blocks
    tape = num_iter * (n_e + (n_c if layered else 0)) * batch * z * 4
    n_bytes = 2 * batch * n_c * z * 4 + tape
    updates = batch * num_iter * n_e * z
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = updates * ops / PEAK_F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def grad_calls(lift, layered):
    """The (tape, backward) kernel wrappers and their plain versions for
    ``lift``, each pair taking what the other of the pair returns."""
    if layered:
        return (lifted_grad.layered_tape_cuda,
                lifted_grad.layered_reverse_cuda,
                lifted_grad.layered_tape_forward, lifted_grad.layered_reverse)
    return (lifted_grad.flooding_tape_cuda,
            lifted_grad.flooding_reverse_cuda,
            lifted_grad.flooding_tape_forward, lifted_grad.flooding_reverse)


def grad_layout_text(lift, layered):
    """The tape kernel's layout (K1's or K3's f32) and the backward
    kernel's for ``lift``, in words."""
    if layered:
        tape = lift.k3_layout(None)
        lay = lift._grad_plans["k5lb"]
        return (f"K5Lf layout (K3's f32): {tape.cluster} block(s) of "
                f"{tape.threads} threads, {tape.lanes} lanes each, "
                f"{tape.smem_bytes} B; K5Lb layout: one block of "
                f"{lay.threads} threads, {lay.smem_bytes} B, v2c in device "
                f"memory, dL/dc2v in "
                f"{'shared' if lay.gc_on_chip else 'device'} memory")
    tape = lift.k1_layout()
    lay = lift._grad_plans["k5b"]
    return (f"K5f layout (K1's): {tape.cluster} block(s) of {tape.threads} "
            f"threads, {tape.smem_bytes} B, {len(tape.reg_edges)} register "
            f"edges; K5b layout: {lay.cluster} block(s), {lay.threads} "
            f"threads, {lay.smem_bytes} B, tape rows "
            f"{'staged by cp.async' if lay.staged else 'read from the tape'}")


def check_grad(got, want, what):
    """Raises unless the backward kernel's ``got`` is finite and within
    GRAD_REL_TOL of the largest |gradient| of the plain reverse's
    ``want``. Returns (max |got - want|, that over max |want|)."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: gradient not finite")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= GRAD_REL_TOL * scale:
        raise AssertionError(f"{what}: backward kernel off the plain "
                             f"reverse by {err} of {scale}")
    return err, err / scale if scale else 0.0


def check_grad_kernels(dev, layered):
    """Phase 36, first part: for the codes of phases 3-4 (n=25344 too)
    and three check-node rules, the tape kernel's marginals identical to
    K1's (K3's) at 0, 1, 5 and 20 (10) iterations; at 0, 1 and 5 its
    tapes identical to the plain tape forward's and the backward kernel
    on that tape against the plain reverse, within GRAD_REL_TOL of the
    largest |gradient| (the plain reverse at 20 iterations is phase 36's
    second part, at the main path's shapes). Returns {kernels-line name:
    max |kernel - plain|}."""
    gen = torch.Generator(device=dev).manual_seed(36)
    names = [v[0] for v in GRAD_VARIANTS if (v[2] is LAYERED_BP_GRAD_KERNEL)
             == layered]
    max_err = dict.fromkeys(names, 0.0)
    iters, deep = (0, 1, 5), 10 if layered else 20
    # and the largest 5G code, whose backward layouts differ (K5b a cluster
    # of 6, K5Lb 209 KB of posterior and dL/dpost in one block)
    codes = [(100, 200, None, 256), (LINK["k"], LINK["n"], LINK["nbps"], 500),
             (6144, 12288, None, 128), (8448, 16896, None, 32),
             (8448, 25344, None, 16)]
    worst = 0.0
    for k, n, nbps, batch in codes:
        enc = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps, device=dev)
        for cn in ("boxplus", "minsum", "offset-minsum"):
            dec = LDPC5GDecoder(enc, cn_update=cn, engine="lifted",
                                device=dev)
            lift = dec.lifted
            tape_k, back_k, tape_p, back_p = grad_calls(lift, layered)
            llr = dec.recover_llrs(noisy_llrs(enc, batch, 2.0, gen)[1])
            rel = []
            for it in iters + (deep,):
                marg, *tapes = tape_k(lift, llr, it)
                with torch.no_grad():
                    ref = lift(llr, it, layered=layered)
                what = f"{'K5Lf' if layered else 'K5f'} ({k},{n}) {cn} {it}"
                max_err[names[0]] = max(max_err[names[0]], assert_identical(
                    marg, ref, f"{what} iters against K{3 if layered else 1}"))
                if it == deep:
                    continue
                _, *plain_tapes = tape_p(lift, llr, it)
                for t, pt in zip(tapes, plain_tapes):
                    if it:
                        assert_identical(t, pt, f"{what} iters: tape")
                g = torch.randn(marg.shape, generator=gen, device=dev)
                err, r = check_grad(back_k(lift, llr, *tapes, g),
                                    back_p(lift, llr, *tapes, g),
                                    f"{what} iters")
                max_err[names[1]] = max(max_err[names[1]], err)
                rel.append(r)
            worst = max(worst, *rel)
            print(f"  ({k},{n}) x {batch} {cn:13s}: marginals identical "
                  f"at iters {iters + (deep,)}, tapes at {iters}; backward "
                  f"|err| / max|grad| {', '.join(f'{r:.2e}' for r in rel)}")
    print(f"    largest |err| / max|grad| {worst:.3e} (tolerance "
          f"{GRAD_REL_TOL:g})")
    return max_err


def kept(out, key, fn):
    """A call of ``fn`` that leaves its output at ``out[key]``, the last
    call's output freed before it starts (as a call whose output is
    dropped leaves the allocator its memory)."""
    def call():
        out.pop(key, None)
        out[key] = fn()
    return call


def time_grad_kernels(dev, card, function_ops, max_err):
    """Phase 36, second part: at the link's n=2048 x 2000 and the
    flagship's n=12288 x 2048 (BP-20 flooding, layered-10; boxplus), the
    tape kernel's marginals identical to K1's/K3's and its tapes to the
    plain tape forward's, the backward kernel within GRAD_REL_TOL of the
    plain reverse (their errors folded into ``max_err``). At the link,
    the main path of phase 37, ms per call of the tape kernel, the
    backward kernel and the plain pair (CUDA events, warm-up excluded;
    kernel, plain, kernel), the timed backward calls identical to the
    first, and the bounds (``sass_ops`` counts of ``function_ops``).
    Returns {kernels-line name: (ms, plain ms, (bound ms, bound_by),
    shape)} at the link."""
    fwd_ops = sass_ops.ops_per_update(function_ops)["log1p"][1]
    gen = torch.Generator(device=dev).manual_seed(37)
    out = {}
    for k, n, nbps, batch, ebno in ((LINK["k"], LINK["n"], LINK["nbps"],
                                     LINK["batch"], 3.0),
                                    (6144, 12288, None, 2048, 2.5)):
        enc = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps, device=dev)
        dec = LDPC5GDecoder(enc, cn_update="boxplus", engine="lifted",
                            device=dev)
        lift = dec.lifted
        llr = dec.recover_llrs(noisy_llrs(enc, batch, ebno, gen)[1])
        g = torch.randn(llr.shape, generator=gen, device=dev)
        for layered, it in ((False, 20), (True, 10)):
            shape = (f"n={n} x {batch}, "
                     f"{'layered-10' if layered else 'BP-20'} boxplus")
            tape_k, back_k, tape_p, back_p = grad_calls(lift, layered)
            base = layered_bp_cuda if layered else lifted_bp_cuda
            f_name, b_name = [v[0] for v in GRAD_VARIANTS
                              if (v[2] is LAYERED_BP_GRAD_KERNEL) == layered]
            torch.cuda.empty_cache()
            marg, *tapes = tape_k(lift, llr, it)
            got = back_k(lift, llr, *tapes, g)
            with torch.no_grad():
                max_err[f_name] = max(max_err[f_name], assert_identical(
                    marg, base(lift, llr, it), f"{f_name} at {shape} "
                    f"against K{3 if layered else 1}"))
            for t, pt in zip(tapes, tape_p(lift, llr, it)[1:]):
                torch.cuda.synchronize()
                if not torch.equal(t, pt):  # no |t - pt| temporary
                    raise AssertionError(f"{f_name} at {shape}: tape off "
                                         f"the plain tape forward's")
            err, rel = check_grad(got, back_p(lift, llr, *tapes, g),
                                  f"{b_name} at {shape}")
            max_err[b_name] = max(max_err[b_name], err)
            print(f"    {shape}: marginals and tapes identical, backward "
                  f"|err| / max|grad| {rel:.2e}; "
                  f"{grad_layout_text(lift, layered)}")
            if n == LINK["n"]:
                # kernel, plain, kernel: the plain pair once after a
                # warm-up call (without it the first call measured up to
                # 8x the second)
                f1 = cuda_ms(lambda: tape_k(lift, llr, it), 5)
                pf = cuda_ms(lambda: tape_p(lift, llr, it), 1)
                f2 = cuda_ms(lambda: tape_k(lift, llr, it), 5)
                # the timed backward calls give the first call's gradient
                res = {}
                timed_back = kept(res, "back",
                                  lambda: back_k(lift, llr, *tapes, g))
                b1 = cuda_ms(timed_back, 5)
                assert_identical(res.pop("back"), got, f"{b_name} at "
                                 f"{shape}: a timed call against the first")
                pb = cuda_ms(lambda: back_p(lift, llr, *tapes, g), 1)
                b2 = cuda_ms(timed_back, 5)
                assert_identical(res.pop("back"), got, f"{b_name} at "
                                 f"{shape}: a timed call against the first")
                fb = grad_bound(lift, batch, it, fwd_ops, layered)
                bb = grad_bound(lift, batch, it,
                                sass_ops.backward_ops_per_update(
                                    function_ops, layered), layered)
                print(f"      tape kernel {f1:.3f} / {f2:.3f} ms (bound "
                      f"{fb[0]:.3f} ms, {fb[1]}, "
                      f"{100 * fb[0] / min(f1, f2):.1f} %), backward kernel "
                      f"{b1:.3f} / {b2:.3f} ms (bound {bb[0]:.3f} ms, "
                      f"{bb[1]}, {100 * bb[0] / min(b1, b2):.1f} %); plain "
                      f"tape forward {pf:.1f} ms, plain reverse {pb:.1f} ms; "
                      f"on {card}")
                out[f_name] = ((f1 + f2) / 2, pf, fb, shape)
                out[b_name] = ((b1 + b2) / 2, pb, bb, shape)
            del marg, tapes, got
    return out


def train_constellation(dev, layered, gen):
    """Phase 37: TRAIN["steps"] Adam steps on 16-QAM points through the
    quick-start link, the decoder in the loss. Returns (losses per step,
    the tape and backward kernels' launches and K1/K3's in the steps,
    evaluation loss before, after)."""
    k, n, nbps, batch = TRAIN["k"], TRAIN["n"], TRAIN["nbps"], TRAIN["batch"]
    src = BinarySource(device=dev)
    enc = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps, device=dev)
    knobs = (dict(cn_schedule="layered", engine="lifted", num_iter=10)
             if layered else dict(num_iter=20))
    dec = LDPC5GDecoder(enc, cn_update="boxplus", hard_out=False,
                        device=dev, **knobs)
    mapper = Mapper("qam", nbps, device=dev)
    demapper = Demapper("app", "qam", nbps, device=dev)
    awgn = AWGN(device=dev)
    no = ebnodb2no(TRAIN["ebno_db"], nbps, k / n).to(dev)
    points = torch.nn.Parameter(mapper.constellation.points.detach().clone())
    opt = torch.optim.Adam([points], lr=TRAIN["lr"])

    def loss_fn(g):
        u = src([batch, k], generator=g)
        pts = points / torch.sqrt(torch.mean(torch.abs(points) ** 2))
        y = awgn(mapper(enc(u), points=pts), no, generator=g)
        out = dec(demapper(y, no, points=pts))
        return torch.nn.functional.binary_cross_entropy_with_logits(out, u)

    def eval_loss():
        with torch.no_grad():
            return float(loss_fn(torch.Generator(device=dev).manual_seed(99)))

    before = eval_loss()
    for kern in KERNELS + GRAD_KERNELS:
        kern.reset()
    losses = []
    for _ in range(TRAIN["steps"]):
        opt.zero_grad()
        loss = loss_fn(gen)
        loss.backward()
        if not bool(torch.isfinite(points.grad).all()):
            raise AssertionError(f"[37] gradient not finite: {points.grad}")
        opt.step()
        losses.append(loss.item())
    grad_kern = LAYERED_BP_GRAD_KERNEL if layered else LIFTED_BP_GRAD_KERNEL
    launches = (dict(grad_kern.variant_launches),
                sum(kern.launches for kern in KERNELS))
    return losses, launches, before, eval_loss()


def grad_phases(card, results, function_ops):
    """Phases 36-37, run in a fresh process by ``main``; puts the
    gradient kernels' kernels-line entries on ``results``."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    print(f"[36] gradient kernels K5f/K5b and K5Lf/K5Lb against K1/K3 and "
          f"the plain reverse on {card}")
    max_err = check_grad_kernels(dev, False)
    max_err.update(check_grad_kernels(dev, True))
    times = time_grad_kernels(dev, card, function_ops, max_err)
    print(f"    phase 36 took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    print(f"[37] training a 16-QAM constellation through the quick-start "
          f"link (batch {TRAIN['batch']}, {TRAIN['ebno_db']} dB, Adam lr "
          f"{TRAIN['lr']}) on {card}")
    gen = torch.Generator(device=dev).manual_seed(7)
    launches = {}
    for layered in (False, True):
        losses, (grad_l, base_l), before, after = \
            train_constellation(dev, layered, gen)
        what = ("layered-10, engine=\"lifted\"" if layered
                else "BP-20, engine=\"auto\"")
        print(f"    {what}: loss per step "
              f"{', '.join(f'{x:.5f}' for x in losses)}; evaluation loss "
              f"{before:.5f} -> {after:.5f}; launches {grad_l} (K1/K3 "
              f"{base_l}) in {TRAIN['steps']} steps")
        if grad_l != {"forward": TRAIN["steps"],
                      "backward": TRAIN["steps"]} or base_l:
            raise AssertionError(f"[37] {what}: launches {grad_l}, K1/K3 "
                                 f"{base_l} in {TRAIN['steps']} steps")
        if not after < before:
            raise AssertionError(f"[37] {what}: the evaluation loss did not "
                                 f"fall: {before} -> {after}")
        fwd, bwd = [v[0] for v in GRAD_VARIANTS
                    if (v[2] is LAYERED_BP_GRAD_KERNEL) == layered]
        launches[fwd] = grad_l["forward"]
        launches[bwd] = grad_l["backward"]
    print(f"    phase 37 took {time.perf_counter() - t1:.1f} s")
    results.put([{
        "name": name,
        "route": "cuda",
        "source": "sionna_tpu_torch/csrc/" + kern.source.name,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": max_err[name],
        "shape": times[name][3],
        "ms": times[name][0],
        "plain_ms": times[name][1],
        "bound_ms": times[name][2][0],
        "bound_by": times[name][2][1],
        "library_ms": None,
    } for name, _, kern, _, replaces in GRAD_VARIANTS])


def print_ptxas(kern):
    """Builds ``kern`` and prints ptxas's registers and spills of each of
    its entry functions."""
    kern.library()
    name = None
    for line in kern.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            print(f"    ptxas {name}: {line.split(':', 1)[-1].strip()}")


def lin_interp_phase(card, launches):
    """Phase 38: the linear interpolators' kernel (``csrc/lin_interp.cu``)
    at the 273-PRB PUSCH's shape (``benchmark``'s ``pusch_273prb.ls_lin``:
    2 layers, 6,552 pilots, 45,864 REs) against its plain version and
    the dense complex64 operator's einsum; returns its kernels-line entry,
    with ``launches`` (phase 25's count in the link's counted
    iterations)."""
    dev = torch.device("cuda", 0)
    print_ptxas(LIN_INTERP_KERNEL)
    pc = pusch_config(273)
    rg = PUSCHTransmitter(pc, device=dev).resource_grid
    est = PUSCHLSChannelEstimator(
        rg, pc.dmrs.length, pc.dmrs.additional_position,
        pc.dmrs.num_cdm_groups_without_data, interpolation_type="lin",
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(38)
    idx, w = est._interpolator._tables(dev, torch.float32)
    n_t, n_re, k = idx.shape
    p = rg.pilot_pattern.num_pilot_symbols
    x = torch.randn((256, n_t, p), dtype=torch.complex64, device=dev,
                    generator=gen)
    got, want = lin_interp_cuda(x, idx, w), lin_interp_plain(x, idx, w)
    # a few f32 roundings of the taps' magnitudes
    err = float(torch.max(torch.abs(got - want)
                          / lin_interp_plain(x.abs(), idx, w.abs())))
    if not err <= 2 * k * torch.finfo(torch.float32).eps:
        raise AssertionError(f"[38] kernel against plain: {err}")
    max_err = float(torch.max(torch.abs(got - want)))
    (k1, k2), (p1, p2) = in_turns(lambda: lin_interp_cuda(x, idx, w),
                                  lambda: lin_interp_plain(x, idx, w),
                                  200, 20)
    # the dense complex64 operator [T, RE, P] and its einsum (what the
    # port ran before the kernel): the yardstick
    dense = torch.zeros((n_t, n_re, p), device=dev).scatter_add_(
        2, idx.long(), w).to(torch.complex64)
    lib1 = cuda_ms(lambda: torch.einsum("mtp,trp->mtr", x, dense), 5)
    lib_err = float(torch.max(torch.abs(
        torch.einsum("mtp,trp->mtr", x, dense) - want)))
    del dense
    torch.cuda.empty_cache()
    nbytes = (got.numel() + x.numel()) * 8 + idx.numel() * 8
    bound = nbytes / PEAK_BYTES_S * 1e3
    ms = min(k1, k2)
    print(f"    complex64 x [256, {n_t}, {p}] -> [256, {n_t}, {n_re}], K={k}: "
          f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.3f} / {p2:.3f} ms, "
          f"dense einsum {lib1:.3f} ms (max |einsum-plain| {lib_err:.3e}); "
          f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), {bound / ms:.1%} "
          f"of it; max |kernel-plain| {max_err:.3e} ({err:.2e} of the "
          f"taps' magnitude); on {card}")
    return {
        "name": "lin_interp",
        "route": "cuda",
        "source": "sionna_tpu_torch/csrc/" + LIN_INTERP_KERNEL.source.name,
        "replaces": None,
        "launches": launches,
        "max_abs_err": max_err,
        "shape": f"[256, {n_t}, {p}] -> [256, {n_t}, {n_re}], K={k}",
        "ms": ms,
        "plain_ms": min(p1, p2),
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": lib1,
    }


def lmmse_phase(card, launches):
    """Phase 39: the whitened-LMMSE kernel (``csrc/lmmse_whitened.cu``) on
    one MC iteration's own channel uses of phase 26's MIMO link (the
    ``benchmark``'s ``flat_mimo_4x16.lmmse_bp20``: N = 4096 x 256, M = 16,
    K = 4, S = N0 I) against its plain path (``lmmse_equalizer_plain``,
    the library calls it replaced); returns its kernels-line entry, with
    ``launches`` (phase 26's count in the link's sim_ber). ``plain_ms`` is
    the plain path's."""
    dev = torch.device("cuda", 0)
    print_ptxas(LMMSE_WHITENED_KERNEL)
    config.seed = FLAT_SEED
    link = FlatLink(dev)
    with torch.no_grad():
        _, _, y, h, s = link.channel_uses(FLAT["batch"], FLAT["ebno_db"])
        x_k, n_k = lmmse_equalizer(y, h, s)
        x_p, n_p = lmmse_equalizer_plain(y, h, s)
        (n, m), k = y.shape, h.shape[-1]
        gaps = {}
        for what, kern, plain in (("x_hat", x_k, x_p), ("no_eff", n_k, n_p)):
            gaps[what] = float((kern - plain).abs().max()
                               / plain.abs().max())
            if not gaps[what] < LMMSE_RTOL:
                raise AssertionError(f"[39] {what}: kernel against plain "
                                     f"{gaps[what]} (bound {LMMSE_RTOL})")
        max_err = float((x_k - x_p).abs().max())
        args = tuple(t.contiguous() for t in (y, h, s))
        (k1, k2), (p1, p2) = in_turns(lambda: lmmse_whitened_cuda(*args),
                                      lambda: lmmse_equalizer_plain(y, h, s),
                                      200, 5)
    nbytes = n * (m + m * k + k) * 8 + n * k * 4
    bound = nbytes / PEAK_BYTES_S * 1e3
    ms = min(k1, k2)
    shape = f"N={n}, M={m}, K={k}, S=N0 I"
    print(f"    {shape}: kernel {k1:.4f} / {k2:.4f} ms, plain "
          f"{p1:.3f} / {p2:.3f} ms; bound {bound:.4f} ms "
          f"({nbytes / 1e6:.1f} MB), {bound / ms:.1%} of it; kernel-plain "
          f"of the largest value: x_hat {gaps['x_hat']:.2e}, no_eff "
          f"{gaps['no_eff']:.2e} (bound {LMMSE_RTOL:.0e}); max "
          f"|kernel-plain| x_hat {max_err:.3e}; on {card}")
    return {
        "name": LMMSE_WHITENED_KERNEL.name,
        "route": "cuda",
        "source": "sionna_tpu_torch/csrc/" + LMMSE_WHITENED_KERNEL.source.name,
        "replaces": None,
        "launches": launches,
        "max_abs_err": max_err,
        "shape": shape,
        "ms": ms,
        "plain_ms": min(p1, p2),
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": None,
    }


def lmmse_per_re_entry(card, launches):
    """Phase 39, its second part: the per-RE LMMSE kernel
    (``csrc/lmmse_per_re.cu``) on one MC iteration's own REs of phase 25's
    273-PRB PUSCH (the ``benchmark``'s ``pusch_273prb.ls_lin``: N = 64 x
    14 x 3,276, M = 4, K = 2, an S at each RE), y, h and S as its detector
    hands them, against its plain path (``lmmse_equalizer_plain``, the
    unrolled tensor operations it replaced); returns its kernels-line
    entry, with ``launches`` (phase 25's count in its counted
    iterations). ``plain_ms`` is the plain path's."""
    dev = torch.device("cuda", 0)
    print_ptxas(LMMSE_PER_RE_KERNEL)
    config.seed = PUSCH_SEED
    cfg = PUSCH_FULL
    link = PuschLink(dev, cfg["n_size_grid"])
    seen = {}
    link.rx._mimo_detector._detector.register_forward_pre_hook(
        lambda module, args: seen.__setitem__("ys", args))
    with torch.no_grad():
        link(cfg["batch"], PUSCH["ebno_db"])
        y, h, s = seen["ys"]
        del link, seen
        x_k, n_k = lmmse_equalizer(y, h, s)
        x_p, n_p = lmmse_equalizer_plain(y, h, s)
        m, k = h.shape[-2:]
        n = y[..., 0].numel()
        gaps = {}
        for what, kern, plain in (("x_hat", x_k, x_p), ("no_eff", n_k, n_p)):
            gaps[what] = float((kern - plain).abs().max()
                               / plain.abs().max())
            if not gaps[what] < LMMSE_RTOL:
                raise AssertionError(f"[39] {what}: per-RE kernel against "
                                     f"plain {gaps[what]} (bound "
                                     f"{LMMSE_RTOL})")
        max_err = float((x_k - x_p).abs().max())
        del x_k, n_k, x_p, n_p
        (k1, k2), (p1, p2) = in_turns(lambda: lmmse_per_re_cuda(y, h, s),
                                      lambda: lmmse_equalizer_plain(y, h, s),
                                      200, 5)
    # each RE: y, h and S read, x_hat and no_eff written
    nbytes = n * (m + m * k + m * m + k) * 8 + n * k * 4
    bound = nbytes / PEAK_BYTES_S * 1e3
    ms = min(k1, k2)
    shape = f"N={n}, M={m}, K={k}, an S at each RE"
    print(f"    {shape}: kernel {k1:.4f} / {k2:.4f} ms, plain "
          f"{p1:.3f} / {p2:.3f} ms; bound {bound:.4f} ms "
          f"({nbytes / 1e6:.1f} MB), {bound / ms:.1%} of it; kernel-plain "
          f"of the largest value: x_hat {gaps['x_hat']:.2e}, no_eff "
          f"{gaps['no_eff']:.2e} (bound {LMMSE_RTOL:.0e}); max "
          f"|kernel-plain| x_hat {max_err:.3e}; on {card}")
    return {
        "name": LMMSE_PER_RE_KERNEL.name,
        "route": "cuda",
        "source": "sionna_tpu_torch/csrc/" + LMMSE_PER_RE_KERNEL.source.name,
        "replaces": None,
        "launches": launches,
        "max_abs_err": max_err,
        "shape": shape,
        "ms": ms,
        "plain_ms": min(p1, p2),
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": None,
    }


def precode_channel_entry(card, launches):
    """Phase 39, its last part: the channel-precoding kernel
    (``csrc/precode_channel.cu``) at the 273-PRB PUSCH's h (the
    ``benchmark``'s ``pusch_273prb.perfect_csi``: [64, 1, 4, 1, 2, 14,
    3276], TPMI 1) against its plain path (``precode_channel_plain``: the
    permute, the cuBLAS complex64 matrix product and the permute back,
    which the port ran before the kernel); returns its kernels-line entry,
    with ``launches`` (phase 24's count in its perfect-CSI call).
    ``plain_ms`` and ``library_ms`` are both the plain path's: the
    contiguous copy of the permuted h that ``torch.matmul`` makes and the
    cuBLAS product."""
    dev = torch.device("cuda", 0)
    print_ptxas(PRECODE_CHANNEL_KERNEL)
    gen = torch.Generator(device=dev).manual_seed(39)
    shape = (64, 1, 4, 1, 2, 14, 3276)
    h = torch.complex(torch.randn(shape, device=dev, generator=gen),
                      torch.randn(shape, device=dev, generator=gen))
    w = PUSCHTransmitter(pusch_config(16), device=dev)._precoder._w.to(dev)
    got, want = precode_channel_cuda(h, w), precode_channel_plain(h, w)
    # a few f32 roundings of sum_p |h_p| |w_pl|
    mag = precode_channel_plain(h.abs().to(torch.complex64),
                                w.abs().to(torch.complex64)).real
    err = float(torch.max(torch.abs(got - want) / mag))
    if not err <= 8 * torch.finfo(torch.float32).eps:
        raise AssertionError(f"[39] precoding kernel against plain: {err}")
    max_err = float(torch.max(torch.abs(got - want)))
    del got, want, mag
    (k1, k2), (p1, p2) = in_turns(lambda: precode_channel_cuda(h, w),
                                  lambda: precode_channel_plain(h, w),
                                  200, 20)
    # h read once (P planes), the L layer planes written once
    nbytes = h.numel() * 8 + h.numel() // w.shape[1] * w.shape[2] * 8
    bound = nbytes / PEAK_BYTES_S * 1e3
    ms = min(k1, k2)
    print(f"    h {list(shape)} complex64, w {list(w.shape)}: kernel "
          f"{k1:.4f} / {k2:.4f} ms, plain (cuBLAS) {p1:.3f} / {p2:.3f} ms; "
          f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), {bound / ms:.1%} "
          f"of it; kernel-plain {err:.2e} of sum |h||w|, max "
          f"{max_err:.3e}; on {card}")
    return {
        "name": PRECODE_CHANNEL_KERNEL.name,
        "route": "cuda",
        "source": "sionna_tpu_torch/csrc/" + PRECODE_CHANNEL_KERNEL.source.name,
        "replaces": None,
        "launches": launches,
        "max_abs_err": max_err,
        "shape": f"h {list(shape)}, w {list(w.shape)}",
        "ms": ms,
        "plain_ms": min(p1, p2),
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": min(p1, p2),
    }


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
    with ThreadPoolExecutor(len(KERNELS + GRAD_KERNELS) + 1) as pool:
        ops_job = pool.submit(sass_ops.function_ops)
        list(pool.map(lambda kern: kern.library(), KERNELS + GRAD_KERNELS))
        function_ops = ops_job.result()
    ops_per_update = sass_ops.ops_per_update(function_ops)
    print(f"[2] built "
          f"{', '.join(k.source.name for k in KERNELS + GRAD_KERNELS)} and "
          f"the SASS probes: took {time.perf_counter() - t0:.2f} s")
    for kern in KERNELS:
        for line in ptxas_report(kern):
            print(f"    ptxas {line}")
            # K3 keeps every per-edge value in registers or shared memory
            if kern is LAYERED_BP_KERNEL and local_memory_bytes(line):
                raise AssertionError(f"K3 uses local memory: {line}")
    # the tape kernels (K1's and K3's code with the tape stores) beside them
    for kern in GRAD_KERNELS:
        for line in grad_ptxas_report(kern):
            print(f"    ptxas {line}")
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
    ber, bler = sim_ber(run, [3.0, 4.0], batch_size=LINK["batch"],
                        max_mc_iter=10, early_stop=False, verbose=True)
    torch.cuda.synchronize()
    launches = LIFTED_BP_KERNEL.variant_launches.get("f32", 0)
    ber, bler = ber.tolist(), bler.tolist()
    print(f"    BER {ber}, BLER {bler}, {seen['calls']} decoder calls, "
          f"{launches} kernel launches, devices {sorted(seen['devices'])}")
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

    print(f"[8] every kernel variant against its plain version on {card}; "
          f"each variant's first case timed (warm-up excluded)")
    # every kernel variant alone at the flagship's code, batch 2048:
    # BP-20 flooding, layered-10 (the setting docs/PERFORMANCE.md
    # compares), and K1 and K3 at the coded-AWGN link's code and batch,
    # and at BG1's; each output held identical to its plain version at
    # that shape
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
        print(f"    {name}, {shape}: max|kernel-plain| {err:.3e}")
        print(f"      {launch_line(name, lift, llr.shape[0])}")
        if name in times:
            continue
        # the kernels line: main path's shape
        (k1, k2), (p1, p2) = in_turns(lambda: ker(llr, it),
                                      lambda: plain(llr, it), 10, 2)
        per_update = ((sass_ops.MINSUM_OPS,) * 2 if name.endswith("minsum")
                      else ops_per_update["ratio" if name.endswith("ratio")
                                          else "log1p"])
        bound = lifted_bound(lift, llr.shape[0], it, per_update)
        print(f"      kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / "
              f"{p2:.3f} ms per call; bound {bound[0]:.3f} ms "
              f"({bound[1]}), {100 * bound[0] / min(k1, k2):.1f} % of it; "
              f"FP32 issue {bound[2]:.3f} ms, "
              f"{100 * bound[2] / min(k1, k2):.1f} %")
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        shapes[name] = shape
        bounds[name] = bound

    print("[9] decoder-kernel tuning sweep "
          "(python -m sionna_tpu_torch.tools.ldpc_tune --quick)")
    reset_launches()
    # the sweep's own table is its times of each variant, not printed here
    with contextlib.redirect_stdout(io.StringIO()):
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
        _, _, sig, ones, flips = sweep[label]
        print(f"    {label} on the probe LLRs: hard decisions sig={sig:.0f} "
              f"ones={ones:.0f}, flip rate against f32 {flips:.3e}")

    print("[10] generic-code link (n=648 802.11n LDPC, LDPCBPDecoder "
          "boxplus-phi BP-20, segment engine) through sim_ber")
    generic, gseen = make_generic_link(dev)
    reset_launches()
    _, gbler = sim_ber(generic, [1.5, 2.0], batch_size=GENERIC["batch"],
                       max_mc_iter=GENERIC["mc_iter"], early_stop=False,
                       verbose=True)
    torch.cuda.synchronize()
    gbler = gbler.tolist()
    print(f"    BLER {gbler}, {gseen['calls']} decoder calls, devices "
          f"{sorted(gseen['devices'])}")
    for snr, p in zip([1.5, 2.0], gbler):
        lo, hi = bler_band("generic", snr)
        if not lo <= p <= hi:
            raise AssertionError(f"generic-code BLER at {snr} dB {p} "
                                 f"outside [{lo}, {hi}]")
    check_no_kernel("[10]", gseen["devices"])

    print("[11] coded-AWGN link with engine=\"segment\" through sim_ber")
    srun, _, sseen = make_link(dev, engine="segment")
    reset_launches()
    _, sbler = sim_ber(srun, [3.0, 4.0], batch_size=LINK["batch"],
                       max_mc_iter=10, early_stop=False, verbose=True)
    torch.cuda.synchronize()
    sbler = sbler.tolist()
    print(f"    BLER {sbler}, {sseen['calls']} decoder calls, devices "
          f"{sorted(sseen['devices'])}")
    check_link_bands(sbler, "segment-engine link")
    check_no_kernel("[11]", sseen["devices"])

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
    # nothing decoded under grad through the lifted engine so far
    if any(kern.launches for kern in GRAD_KERNELS):
        raise AssertionError(f"phases 1-14 launched a gradient kernel: "
                             f"{[k.variant_launches for k in GRAD_KERNELS]}")

    # phases 15-16 in a process of their own
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
    run_in_process(sys_phases, card, 600)
    print(f"    phases 20-22 took {time.perf_counter() - t0:.1f} s")
    # phases 23-25 (the 5G NR PUSCH link), likewise
    t0 = time.perf_counter()
    nr_launches = run_in_process(nr_phases, card, 600)
    print(f"    phases 23-25 took {time.perf_counter() - t0:.1f} s")
    # phases 26-28 (flat fading, pulse shaping, the optical link), likewise
    t0 = time.perf_counter()
    flat_launches = run_in_process(flat_phases, card, 600)
    print(f"    phases 26-28 took {time.perf_counter() - t0:.1f} s")
    # phases 29-31 (BASELINE config 4, the ray tracer), likewise
    t0 = time.perf_counter()
    run_in_process(rt_phases, card, 600)
    print(f"    phases 29-31 took {time.perf_counter() - t0:.1f} s")
    # phases 32-33 (the renderer, the Mitsuba loader), likewise
    t0 = time.perf_counter()
    run_in_process(render_phases, card, 600)
    print(f"    phases 32-33 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[34] phase 5's link through sim_ber over torch.distributed ranks "
          f"(init_multihost; spawned processes) on {card}")
    distributed_phase(card)
    print(f"    phase 34 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[35] the port's examples (sionna_tpu_torch/examples) at full "
          f"size on {card}")
    examples_phase(card)
    print(f"    phase 35 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    grad_entries = run_in_process(grad_phases, card, 300, function_ops)
    print(f"    phases 36-37 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[38] the linear interpolators' kernel against its plain version "
          f"and the dense einsum at the 273-PRB PUSCH's shape on {card}")
    lin_entry = lin_interp_phase(card, nr_launches[LIN_INTERP_KERNEL.name])
    print(f"    phase 38 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[39] the whitened-LMMSE kernels against their plain path on the "
          f"flat MIMO link's channel uses and the PUSCH's REs, the channel's "
          f"precoding at the PUSCH's h, on {card}")
    lmmse_entry = lmmse_phase(card,
                              flat_launches[LMMSE_WHITENED_KERNEL.name])
    per_re_entry = lmmse_per_re_entry(
        card, nr_launches[LMMSE_PER_RE_KERNEL.name])
    precode_entry = precode_channel_entry(
        card, nr_launches[PRECODE_CHANNEL_KERNEL.name])
    print(f"    phase 39 took {time.perf_counter() - t0:.1f} s; the script "
          f"took {time.perf_counter() - t_start:.1f} s")

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
    } for name, _, kern, _, replaces in VARIANTS] + grad_entries
        + [lin_entry, lmmse_entry, per_re_entry, precode_entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
