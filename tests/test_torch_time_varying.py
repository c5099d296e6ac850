"""A time-varying topology sequence in the port's trainer, held against
the JAX trainer on the CPU: "ring,star" at n = 4, two graphs whose W
differ (ring and hypercube have the same W at n = 4), the exchange taking
schedule ``t % 2`` in gossip round t.

* 3 trainer steps with 2 gossip rounds per step, top_k and QSGD (the JAX
  dither injected), with ``test_torch_slice.py``'s reference script and
  ``check_against_jax``'s tolerances;
* gossip_steps must be a multiple of the sequence's length, and gamma
  takes the worst (delta, beta) over the sequence, as in the JAX trainer;
* the launcher trains on --topology star, chain, torus and "ring,star",
  and refuses the directed graphs outside --mode pushsum before torch is
  imported.

The torus and star runs are in ``test_torch_topology.py``; each file
makes its own JAX reference runs, so pytest-xdist can run them apart.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.comm.packing import bucket_omega_worst
from repro_torch.core import topology
from repro_torch.core.choco_gossip import theorem2_stepsize
from repro_torch.launch import train as launcher
from test_torch_slice import _SMOKE, N, ROOT, _port_trainer
from test_torch_slice import one_thread  # noqa: F401  (autouse)
from test_torch_topology import run_against_jax


@pytest.mark.parametrize("comp,arg", [("top_k", 0.05), ("qsgd", 16)])
def test_trainer_matches_jax_on_a_time_varying_pair(tmp_path_factory, comp,
                                                    arg):
    run_against_jax(tmp_path_factory, "ring,star", 2, comp, arg)


def test_time_varying_rules():
    with pytest.raises(ValueError, match="multiple of the sequence length"):
        _port_trainer("top_k", 0.05, 3, False, topology="ring,star")
    tr = _port_trainer("top_k", 0.05, 2, False, topology="ring,star")
    topos = [topology.make_topology(t, N) for t in ("ring", "star")]
    assert [s.name for s in tr.schedules] == ["ring", "star"]
    delta = min(t.delta for t in topos)
    beta = max(t.beta for t in topos)
    assert tr.gamma == theorem2_stepsize(
        delta, beta, bucket_omega_worst(tr.spec, tr.compressor))


# -- the launcher ---------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--topology", "star"],
    ["--topology", "ring,star", "--gossip-steps", "2"],
    ["--topology", "chain", "--compressor", "qsgd", "--qsgd-s", "16"],
    ["--topology", "torus", "--compressor", "sign"],
])
def test_launcher_trains_on_the_topology(extra, capsys):
    assert launcher.main(_SMOKE + extra + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"topology={extra[1]} " in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("extra,message", [
    (["--topology", "directed_ring"], "need the push-sum engine: --mode "
                                      "pushsum"),
    (["--topology", "ring,random_digraph", "--gossip-steps", "2"],
     "--topology 'ring,random_digraph' is directed"),
    (["--topology", "moebius"], "choose from ring, torus"),
    (["--topology", "ring,star"], "--gossip-steps must be a multiple of 2"),
])
def test_launcher_refuses_topologies_before_importing_torch(extra, message):
    code = ("import sys; from repro_torch.launch.train import main\n"
            "try:\n    main(sys.argv[1:])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 2 and 'torch' not in sys.modules\n"
            "    print('refused')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code, *_SMOKE, *extra],
                       env=env, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and "refused" in r.stdout, r.stderr
    assert message in r.stderr
