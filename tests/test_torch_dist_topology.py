"""The per-rank engine on star and chain, 4 gloo ranks on the CPU, held
bit for bit against the stacked engine.

Both graphs have per-node self weights (star 0.25 / 0.75, chain 2/3 /
1/3) and partial rounds, in which some nodes send and receive nothing:
the per-rank exchange then sends only where its rank is a source,
receives only where it is a destination, and adds a zero row otherwise,
as the stacked engine's gather does.  Per case (top_k, QSGD, SignNorm,
identity with the exact small-leaf bucket) and gossip_steps 1 and 2:
x, x_hat and s bit-equal to the stacked exchange's rows, and each rank's
``bytes_sent`` equal to its own sends (``exchange.sends``) times one
payload's bytes per bucket.  On star, node 0 sends 3 payloads per gossip
round and each leaf 1.
"""
import os

import numpy as np
import torch

from repro_torch.comm import gossip, schedule
from repro_torch.comm.packing import (bucket_wire_nbytes, make_bucket_spec,
                                      pack_leaves)
from repro_torch.core import topology
from repro_torch.core.compression import make_compressor
from repro_torch.launch import mesh
from test_torch_dist import LEAF_SHAPES, N, THREADS, _join, _spawn

TOPOLOGIES = ("star", "chain")
CASES = (("top_k", {"fraction": 0.05}, False), ("qsgd", {"s": 16}, False),
         ("sign", {}, False), ("identity", {}, True))
GOSSIP_STEPS = (1, 2)
SEED = 4321
#: payloads each node sends per gossip round: star's hub reaches every
#: leaf, chain's ends have one neighbour and its middle nodes two
SENDS_PER_ROUND = {"star": (3, 1, 1, 1), "chain": (1, 2, 2, 1)}


def _case(topo, index):
    """Compressor, spec, schedules, gamma and node-stacked (x_half, x_hat,
    s) of one case, the same in every process."""
    name, kw, exact = CASES[index]
    comp = make_compressor(name, **kw)
    spec = make_bucket_spec(
        [torch.empty(s, device="meta") for s in LEAF_SHAPES],
        align=gossip._pack_align(comp), exact_small_leaves=exact,
        small_leaf_threshold=4224, max_bucket_elems=8192)
    rng = np.random.default_rng(100 + index)
    bufs = [pack_leaves(spec, [torch.from_numpy(
        scale * rng.standard_normal((N,) + s).astype(np.float32))
        for s in LEAF_SHAPES]) for scale in (1.0, 0.5, 0.1)]
    sched = schedule.compile_schedule(topology.make_topology(topo, N))
    return comp, spec, (sched,), 0.25, bufs


def _rank(rank, store, out_dir):
    group = _join(rank, store)
    results = {}
    for topo in TOPOLOGIES:
        for i in range(len(CASES)):
            comp, spec, scheds, gamma, bufs = _case(topo, i)
            for k in GOSSIP_STEPS:
                ex = gossip.make_dist_choco_exchange(
                    spec=spec, schedules=scheds, compressor=comp,
                    gamma=gamma, gossip_steps=k, group=group)
                x, x_hat, s = [[b[rank:rank + 1].clone() for b in part]
                               for part in bufs]
                before = group.bytes_sent
                ex(x, x_hat, s, seed=SEED)
                results[(topo, i, k)] = (x, x_hat, s,
                                         group.bytes_sent - before, ex.sends,
                                         ex.payload_bytes)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def test_dist_exchange_on_star_and_chain_bit_equal_to_stacked(tmp_path):
    ranks = _spawn(_rank, tmp_path, str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        for topo in TOPOLOGIES:
            for i, (name, _, exact) in enumerate(CASES):
                comp, spec, scheds, gamma, bufs = _case(topo, i)
                assert scheds[0].self_weight is None
                for k in GOSSIP_STEPS:
                    x, x_hat, s = [[b.clone() for b in part] for part in bufs]
                    gossip.make_choco_exchange(
                        spec=spec, schedules=scheds, compressor=comp,
                        gamma=gamma, gossip_steps=k)(x, x_hat, s, seed=SEED)
                    payload = bucket_wire_nbytes(spec, comp)
                    for r, res in enumerate(ranks):
                        got_x, got_hat, got_s, sent, sends, nbytes = \
                            res[(topo, i, k)]
                        for want, got in ((x, got_x), (x_hat, got_hat),
                                          (s, got_s)):
                            for b, g in zip(want, got):
                                assert torch.equal(g[0], b[r]), \
                                    (topo, name, exact, k, r)
                        assert nbytes == payload
                        assert sends == k * SENDS_PER_ROUND[topo][r]
                        assert sent == sends * sum(payload), \
                            (topo, name, k, r, sent)
                    assert not torch.equal(x[0], bufs[0][0])
    finally:
        torch.set_num_threads(threads)
