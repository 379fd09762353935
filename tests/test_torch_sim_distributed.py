"""Multi-process ``sim_ber`` of the PyTorch port: two gloo ranks on the
CPU, each a subprocess, joined by ``init_multihost`` (a ``tcp://``
rendezvous, and the ``env://`` one that ``torchrun`` sets up), run the
same QPSK/AWGN sweep with ``distribute="multihost"``, as
``tests/test_multihost.py`` runs the JAX package's over two processes.

Checks: the BER at 4 dB inside the closed-form band (as the JAX test's);
the counters every rank sees are the sums of the ranks' own counts, and
they stop the point at the same iteration on both ranks (before one
rank's own errors would); each rank runs half the batch from its own
random stream; only rank 0 writes its checkpoint; an indivisible batch
raises. In this process: the ``distribute=`` values that need a group,
or have no one-process counterpart, raise; ``"all"`` without a group is
this process alone.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.utils import sim_ber

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

WORKER = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
from sionna_tpu_torch.phy import config, BinarySource, Mapper, Demapper, AWGN
from sionna_tpu_torch.phy.utils import ebnodb2no, init_multihost, sim_ber
torch.set_num_threads(1)
config.device = "cpu"
if {coord!r}:
    init_multihost(coordinator_address={coord!r}, num_processes=2,
                   process_id={pid})
else:
    init_multihost()
assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
config.seed = 42
src, mp = BinarySource(), Mapper("qam", 2)
dm, ch = Demapper("app", "qam", 2, hard_out=True), AWGN()
own = dict(bit_errors=0, bits=0, calls=0, batch=[], first=None)

def mc_fun(batch_size, ebno_db):
    no = ebnodb2no(ebno_db, 2, 1.0)
    b = src([batch_size, 256])
    b_hat = dm(ch(mp(b), no), no)
    if own["first"] is None:
        own["first"] = b[0, :64].tolist()
    own["bit_errors"] += int((b != b_hat).sum())
    own["bits"] += b.numel()
    own["calls"] += 1
    own["batch"].append(batch_size)
    return b, b_hat

seen = []

def callback(it, i, ebno, bit_e, blk_e, nb, nblk):
    seen.append([it, int(bit_e[i]), int(nb[i]), int(blk_e[i]),
                 int(nblk[i])])

ckpt = os.path.join({tmp!r}, "ckpt_{pid}.npz")
ber, bler = sim_ber(mc_fun, [4.0], batch_size=1024, max_mc_iter=8,
                    num_target_bit_errors=6000, device_iters=1,
                    verbose=False, distribute="multihost",
                    callback=callback, checkpoint_path=ckpt)
try:
    sim_ber(mc_fun, [4.0], batch_size=1023, max_mc_iter=1, verbose=False,
            distribute="multihost")
    indivisible = None
except ValueError as e:
    indivisible = str(e)
print("RESULT " + json.dumps(dict(ber=float(ber[0]), bler=float(bler[0]),
                                  seen=seen, own=own,
                                  indivisible=indivisible)))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, rendezvous):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        coord = f"127.0.0.1:{port}"
        if rendezvous == "env":  # what torchrun exports
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=str(pid), LOCAL_RANK=str(pid))
            coord = ""
        code = WORKER.format(repo=REPO, coord=coord, pid=pid,
                             tmp=str(tmp_path))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    results = []
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {pid} rc={p.returncode}\n{out[-1500:]}\n{err[-3000:]}")
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


@pytest.mark.parametrize("rendezvous", ["tcp", "env"])
def test_two_rank_gloo_sweep(tmp_path, rendezvous):
    r0, r1 = _run_ranks(tmp_path, rendezvous)
    # QPSK @ EbNo 4 dB: BER = Q(sqrt(2*10^0.4)) ~ 1.25e-2
    assert 0.9e-2 < r0["ber"] < 1.7e-2
    assert (r0["ber"], r0["bler"]) == (r1["ber"], r1["bler"])
    # one all_reduce per chunk: both ranks see the same summed counters,
    # and they are the sums of the ranks' own counts
    assert r0["seen"] == r1["seen"]
    it, bit_e, nb, _, nblk = r0["seen"][-1]
    assert bit_e == r0["own"]["bit_errors"] + r1["own"]["bit_errors"]
    assert nb == r0["own"]["bits"] + r1["own"]["bits"] == it * 1024 * 256
    assert nblk == it * 1024
    assert r0["ber"] == bit_e / nb
    # the summed errors stop the point (6000) at the same iteration on
    # both ranks, before either rank's own errors would
    assert it == r0["own"]["calls"] == r1["own"]["calls"] < 8
    assert bit_e >= 6000
    assert max(r0["own"]["bit_errors"], r1["own"]["bit_errors"]) < 6000
    # half the batch each, from streams of their own
    assert set(r0["own"]["batch"] + r1["own"]["batch"]) == {512}
    assert r0["own"]["first"] != r1["own"]["first"]
    # the checkpoint is rank 0's alone, with the summed counters
    assert not os.path.exists(tmp_path / "ckpt_1.npz")
    ckpt = np.load(tmp_path / "ckpt_0.npz", allow_pickle=True)
    assert int(ckpt["bit_errors"][0]) == bit_e
    assert int(ckpt["nb_bits"][0]) == nb
    assert int(ckpt["iters"][0]) == it
    for r in (r0, r1):
        assert "divisible" in r["indivisible"]


@pytest.fixture
def _cpu():
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _ones(batch_size, ebno_db):
    return torch.zeros(batch_size, 8), torch.ones(batch_size, 8)


@pytest.mark.usefixtures("_cpu")
def test_distribute_values_without_a_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_multihost"):
        sim_ber(_ones, [0.0], 8, 1, distribute="multihost", verbose=False)

    class Mesh:  # stands in for jax.sharding.Mesh
        axis_names = ("batch",)

    for value in (Mesh(), ["cpu", "cpu"], ("cuda:0",), "local"):
        with pytest.raises(ValueError, match="torchrun"):
            sim_ber(_ones, [0.0], 8, 1, distribute=value, verbose=False)
    # "all" without a group, one device visible: this process alone
    for distribute in ("all", None):
        ber, bler = sim_ber(_ones, [0.0, 1.0], 6, 2, distribute=distribute,
                            verbose=False)
        assert ber.tolist() == [1.0, 1.0] and bler.tolist() == [1.0, 1.0]
